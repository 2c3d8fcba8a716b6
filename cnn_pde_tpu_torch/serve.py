"""Inference path — port of ``cnn_pde_tpu/serve.py``.

* ``make_predict_fn(model)``: a callable from a batch of NCHW float32
  images (numpy or tensor) to logits, probabilities or labels in eval
  mode.  On a CUDA model every request replays a CUDA graph, one a batch
  size (a bucket, or each distinct size seen), captured at the size's
  first request; on a CPU model it runs eagerly
  (``make_eager_predict_fn``, also the reference the graphs are held
  against on the card).  A model's predicts share its graphs, each of
  which computes logits, probabilities and labels at once.
* ``cache_hoisted_operators`` / ``clear_operator_cache``: pin the sweep
  operators of every hoisted ADI layer for serving with frozen weights
  (the AMP grade's serving path, ``--amp``).
* ``linearize_pde_layers`` / ``clear_linear_cache`` /
  ``select_linearize_grade``: compose each linear PDE layer's whole
  evolution into one matrix (``pde/linearize.py``), stored in float32,
  bf16 or int8.
* ``export_model`` / ``load_exported``: the eval forward as a
  ``torch.export`` program (K1, K2 and K6 are registered ops), with the
  weights and any pinned caches in it.

A captured predict reads the module's own storage at every replay: a later
``load_state_dict`` (an in-place copy) is seen by the next request, but a
cache pinned or cleared after the predict was made is not, so such a
predict raises and a new one must be made.  One lock a model serialises
the copy into a graph's input, the replay and the copy out of its output,
for every predict of that model: the graphs' buffers are not reentrant.

    python -m cnn_pde_tpu_torch.serve --preset cifar10_noconv [--device cpu]
"""

from __future__ import annotations

import copy
import io
import math
import threading
import weakref

import numpy as np
import torch

from .ops import kernels

__all__ = ["make_predict_fn", "make_eager_predict_fn",
           "cache_hoisted_operators", "clear_operator_cache",
           "linearize_pde_layers", "clear_linear_cache",
           "select_linearize_grade", "export_model", "load_exported"]

OUTPUTS = ("logits", "probs", "labels")

def select_linearize_grade(batch_size, feature_dim=None):
    """The matrix grade ``linearize_pde_layers(dtype='auto')`` stores for
    serving batches of ``batch_size`` (the largest bucket): torch.bfloat16
    at every batch and D.  On the H100, the linearized flagship (D =
    3,072) and mnist (D = 784) served at B = 1-1,024 faster in bf16 than
    in int8 at every batch from which int8 could be chosen (PERF.md §5,
    ``chip_smoke.py``'s serving phase): quantizing the activations row by
    row costs more there than the bf16 product it replaces.  The
    arguments are the JAX signature's; an int8 threshold comes back only
    when a measured table puts one in.  float32 is the exact grade,
    chosen only by name."""
    return torch.bfloat16


def _device(model):
    return next(model.parameters()).device


def _batch(images, device):
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    return images.to(device=device, dtype=torch.float32).contiguous()


def _bucket(n, sizes):
    """The smallest bucket >= n, or n above the largest."""
    return next((b for b in sizes if b >= n), n)


def _pad(x, target):
    """x with its last row repeated up to ``target`` rows."""
    n = x.shape[0]
    if target == n:
        return x
    return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])])


def _finish(logits, output):
    if output == "probs":
        return torch.softmax(logits, dim=-1)
    if output == "labels":
        return logits.argmax(dim=-1)
    return logits


def make_eager_predict_fn(model, output="logits", buckets=None):
    """The predict of ``make_predict_fn`` run eagerly on the model's device
    under ``torch.inference_mode()``: the CPU path, and on the card the
    reference a captured predict is held against.  ``buckets``: batch
    sizes to pad requests up to (the last row repeated; padded rows
    sliced off); a request above the largest bucket runs unpadded."""
    if output not in OUTPUTS:
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    model.eval()
    device = _device(model)
    sizes = sorted(int(b) for b in buckets) if buckets else []

    @torch.inference_mode()
    def predict(images):
        x = _batch(images, device)
        n = x.shape[0]
        return _finish(model(_pad(x, _bucket(n, sizes)))[:n], output)

    return predict


def _pinned(layers):
    return [(getattr(lay, "linear_cache", None),
             getattr(lay, "operator_cache", None)) for lay in layers]


class _ModelGraphs:
    """The CUDA graphs of one CUDA model, shared by all its captured
    predicts: one a batch size, each computing the logits, probabilities
    and labels of its static input, all in one memory pool, with the one
    lock of the model.  ``caches`` holds the linear and operator caches
    the graphs read (kept alive with them); once the model's pins differ,
    the set is stale and ``make_predict_fn`` starts a new one."""

    def __init__(self, model, lock):
        from .pde.linearize import iter_linear_pde_layers

        self.lock = lock
        self.device = _device(model)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = None
        self.graphs = {}  # batch -> (graph, static input, {output: tensor})
        self.layers = list(iter_linear_pde_layers(model))
        self.caches = _pinned(self.layers)

    def stale(self):
        return any(a is not b or c is not d for (a, c), (b, d) in
                   zip(_pinned(self.layers), self.caches))

    def capture(self, model, target, x):
        """The graph of batch ``target``, warmed (``WARMUP_ROUNDS`` eager
        runs) on a side stream and captured, its static input holding
        ``x`` padded.  Call under ``lock``."""
        from .train.graph import WARMUP_ROUNDS, _capture, _on_stream

        static_in = torch.empty((target,) + tuple(x.shape[1:]),
                                device=self.device)
        static_in.copy_(_pad(x, target))
        out = {}

        def body():
            logits = model(static_in)
            out.update(logits=logits, probs=torch.softmax(logits, dim=-1),
                       labels=logits.argmax(dim=-1))

        for _ in range(WARMUP_ROUNDS):
            _on_stream(self.stream, body)
        graph = _capture({None: body}, self.stream, pool=self.pool)[None]
        self.pool = graph.pool()
        self.graphs[target] = (graph, static_in, dict(out))
        return self.graphs[target]


_model_graphs = weakref.WeakKeyDictionary()
_model_graphs_guard = threading.Lock()


def _graphs_of(model):
    """The graph set of ``model``, a new one (with the same lock) if a
    cache was pinned or cleared since the last was made."""
    with _model_graphs_guard:
        graphs = _model_graphs.get(model)
        if graphs is None or graphs.stale():
            lock = graphs.lock if graphs is not None else threading.Lock()
            graphs = _model_graphs[model] = _ModelGraphs(model, lock)
        return graphs


class _CapturedPredict:
    """``make_predict_fn`` on a CUDA model: it replays the model's graph of
    each request's batch size (``_ModelGraphs``), captured at the size's
    first request by whichever of the model's predicts meets it.  A
    request is copied into the graph's static input (padded with its last
    row), the graph replayed, and the first rows of its ``output`` cloned
    out.  Inside ``kernels.plain_versions()`` it runs eagerly: the plain
    versions are the reference, not what the graphs hold."""

    def __init__(self, model, output, buckets):
        self.eager = make_eager_predict_fn(model, output, buckets)
        self.model, self.output = model, output
        self.sizes = sorted(int(b) for b in buckets) if buckets else []
        self.set = _graphs_of(model)
        self.graphs = self.set.graphs

    def __call__(self, images):
        if kernels.in_plain_versions():
            return self.eager(images)
        x = _batch(images, self.set.device)
        n = x.shape[0]
        target = _bucket(n, self.sizes)
        with self.set.lock, torch.no_grad():
            if self.set.stale():
                raise RuntimeError(
                    "a linear or operator cache was pinned or cleared after "
                    "this predict fn was made, and its CUDA graphs read the "
                    "old one: make a new predict fn")
            entry = self.graphs.get(target)
            if entry is None:
                entry = self.set.capture(self.model, target, x)
            graph, static_in, static_out = entry
            static_in.copy_(_pad(x, target))
            graph.replay()
            return static_out[self.output][:n].clone()


class _MeshPredict:
    """``make_predict_fn(mesh=)``: one replica of the model a device of the
    mesh's 'data' axis, all in this process (the model itself on its own
    device, a copy on each other), each with its own predict (on the card
    its own CUDA graph a batch size).  A request is padded to its bucket,
    split into equal blocks of rows in device order, each block predicted
    by its replica, and the outputs concatenated on the model's device:
    no collective.  The replicas copy the weights when the predict is
    made."""

    def __init__(self, model, output, buckets, mesh):
        if mesh.group is not None:
            raise ValueError(
                "make_predict_fn(mesh=): serving under a mesh runs in one "
                "process, a replica a device; this mesh spans the ranks of "
                "a process group, whose devices are not all local to this "
                "process")
        self.data = int(mesh.shape["data"])
        self.sizes = sorted(int(b) for b in buckets) if buckets else []
        bad = [b for b in self.sizes if b % self.data]
        if bad:
            raise ValueError(
                f"buckets {bad} not divisible by the 'data' axis size "
                f"{self.data} (required for --dp batch sharding)")
        self.device = _device(model)
        replicas, own = [], False
        for dev in mesh.devices.flat:
            if dev == self.device and not own:
                replicas.append(model)
                own = True
            else:
                replicas.append(copy.deepcopy(model).to(dev))
        self.replicas = replicas
        self.fns = [make_predict_fn(r, output) for r in replicas]

    def __call__(self, images):
        x = _batch(images, self.device)
        n = x.shape[0]
        target = _bucket(n, self.sizes)
        if target % self.data:
            raise ValueError(
                f"batch {target} not divisible by the 'data' axis size "
                f"{self.data} (required for batch sharding)")
        blocks = _pad(x, target).split(target // self.data)
        outs = [fn(b) for fn, b in zip(self.fns, blocks)]
        return torch.cat([o.to(self.device) for o in outs])[:n]


def make_predict_fn(model, output="logits", buckets=None, mesh=None):
    """output: 'logits' | 'probs' | 'labels'.

    ``buckets``: optional batch sizes to pad requests up to (the last row
    repeated; padded rows are sliced off), so the model sees a handful of
    shapes; a request above the largest bucket runs unpadded.

    On a CUDA model the predict replays one CUDA graph a batch size (a
    bucket, or each distinct size seen), which computes the logits,
    probabilities and labels together and which every predict of the
    model shares (``_CapturedPredict``); it is safe to call from several
    threads.  On a CPU model it runs eagerly.  The weights enter
    as the module's own storage (the JAX ``bind='args'``); there is no
    ``bind`` argument.

    ``mesh`` (``parallel.make_mesh()`` outside a process group): batched
    data-parallel serving over the mesh's 'data' axis, one replica a local
    device (``_MeshPredict``); a batch or bucket that the axis does not
    divide raises, and so does a mesh over a process group's ranks."""
    if mesh is not None:
        return _MeshPredict(model, output, buckets, mesh)
    if _device(model).type == "cuda":
        return _CapturedPredict(model, output, buckets)
    return make_eager_predict_fn(model, output, buckets)


def cache_hoisted_operators(model):
    """Build and pin the sweep operators of every ADI layer of ``model``
    whose eval forward takes the hoisted branch, for serving with frozen
    weights: the operators are batch-free and the weights do not change,
    so a request then runs only the GEMMs (two K1 launches a layer here,
    none a request).  Training with a cache pinned raises, and a cache
    built before the weights change is stale: ``clear_operator_cache``
    undoes it.  Each pinned tensor owns its storage (the x sweeps' are
    built as halves of one stack), so that ``export_model`` saves each
    whole.  Returns the number of layers cached."""
    from .pde.amp import iter_adi_layers
    from .pde.diffusion import runs_hoisted

    n = 0
    with torch.no_grad():
        for layer in iter_adi_layers(model):
            if runs_hoisted(layer):
                layer.operator_cache = tuple(
                    tuple(t.clone() for t in sweep)
                    for sweep in layer.hoisted_operators())
                n += 1
    return n


def clear_operator_cache(model):
    """Unpin the operators ``cache_hoisted_operators`` pinned (e.g. to
    resume training).  Returns the number of layers cleared."""
    from .pde.amp import iter_adi_layers

    n = 0
    for layer in iter_adi_layers(model):
        if getattr(layer, "operator_cache", None) is not None:
            layer.operator_cache = None
            n += 1
    return n


def linearize_pde_layers(model, sample_images, max_dim=4096, precision=None,
                         dtype=None, serve_batch_size=None):
    """Frozen-weights serving: collapse each linear PDE layer's whole
    evolution into one composed (D, D) matrix, D = C·H·W, pinned on the
    layer as ``linear_cache`` (``pde/linearize.py``).  One eval forward of
    ``sample_images[:1]`` finds the layers and their input shapes; each
    matrix is the identity basis evolved through the layer's own forward.
    Layers with D > ``max_dim`` stay sequential.

    ``dtype``: the stored grade.  None: float32.  ``torch.bfloat16``: bf16
    operands, a float32 result.  ``'int8'`` or ``torch.int8``: a
    ``QuantizedMatrix`` (W8A8).  ``'auto'``: ``select_linearize_grade(
    serve_batch_size, D)``, with ``serve_batch_size`` the batch the server
    will run (default: the sample's) and D the sample's C·H·W.
    ``precision`` is accepted for the JAX signature and changes nothing:
    the port's float32 products never take TF32.

    Composes with ``cache_hoisted_operators``: the matrix bakes in the
    cached operators.  Training with a cache pinned raises;
    ``clear_linear_cache`` undoes it.  A captured predict made before
    this call must be made again.  Returns the number of layers
    linearized."""
    from .pde.linearize import capture_linearized, quantize_int8

    shape = tuple(sample_images.shape)
    if isinstance(dtype, str) and dtype == "auto":
        dtype = select_linearize_grade(
            serve_batch_size if serve_batch_size is not None else shape[0],
            feature_dim=math.prod(shape[1:]))
    if isinstance(dtype, str) and dtype == "int8":
        dtype = torch.int8
    if dtype not in (None, torch.bfloat16, torch.int8):
        raise ValueError(f"dtype must be None, torch.bfloat16, 'int8', "
                         f"torch.int8 or 'auto', got {dtype!r}")
    was_training = model.training
    model.eval()
    try:
        with capture_linearized(max_dim=max_dim) as cap, torch.no_grad():
            model(_batch(sample_images[:1], _device(model)))
    finally:
        model.train(was_training)
    for layer, mat in cap.items:
        if dtype == torch.int8:
            layer.linear_cache = quantize_int8(mat)
        else:
            layer.linear_cache = mat if dtype is None else mat.to(dtype)
    return len(cap.items)


def clear_linear_cache(model):
    """Unpin the matrices ``linearize_pde_layers`` pinned (e.g. to resume
    training).  Returns the number of layers cleared."""
    from .pde.linearize import iter_linear_pde_layers

    n = 0
    for layer in iter_linear_pde_layers(model):
        if getattr(layer, "linear_cache", None) is not None:
            layer.linear_cache = None
            n += 1
    return n


def export_model(model, sample_images, path=None):
    """The eval forward (logits) of ``model`` at ``sample_images``' shape,
    traced by ``torch.export`` and saved (``torch.export.save``) to bytes,
    also written to ``path`` when given.  The program holds the weights
    and any pinned linear or operator cache; K1, K2 and K6 appear in it as
    the ops ``cnn_pde_tpu_torch::thomas_solve``, ``::fused_channel_fwd``
    and ``::fused_grayscale_fwd``.  Returns the bytes."""
    model.eval()
    x = _batch(sample_images, _device(model))
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes):
    """A program ``export_model`` wrote (bytes or a path), as a callable
    from a batch of the exported shape (numpy or tensor; it runs on the
    exported device) to logits, under ``torch.inference_mode()``.
    Importing ``cnn_pde_tpu_torch.ops`` registers the kernels' ops it
    calls."""
    from . import ops  # noqa: F401  (registers the ops)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        source = io.BytesIO(bytes(path_or_bytes))
    else:
        source = path_or_bytes
    module = torch.export.load(source).module()
    device = next(iter(module.state_dict().values())).device

    @torch.inference_mode()
    def predict(images):
        return module(_batch(images, device))

    return predict


if __name__ == "__main__":
    from .serve_cli import main

    main()
