"""The port's serving path (cnn_pde_tpu_torch.serve) against the JAX package's
on the CPU: predict outputs with and without shape buckets, concurrent
callers, the CLI's summary line and each of its flags against the JAX CLI
on the same weights, the HTTP CLI with a reload on a changed checkpoint,
weights from a reference checkpoint, import hygiene, and the refusal to fall
back to the CPU when no card is present.
"""

import io
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu import serve_cli as jax_serve_cli
from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.serve import make_predict_fn as jax_make_predict_fn
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.serve import make_predict_fn
from cnn_pde_tpu_torch.serve_cli import main as port_cli_main


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_port_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cnn_pde_tpu_torch.serve",
         "--preset", "cifar10_noconv", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def served():
    """JAX flagship weights (with non-zero time coefficients) carried into
    the port, and a ragged request batch of 3."""
    rng = np.random.default_rng(2)
    model = JaxModel()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1)))
    for i in (1, 2, 3):
        pde = params["feature_extractor"][f"pde{i}"]
        for k in ("alpha_time_coeff", "beta_time_coeff"):
            pde[k] = (5.0 * rng.standard_normal(pde[k].shape)).astype(
                np.float32)
    port = build_model("cifar10_noconv", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state), strict=True)
    x = rng.random((3, 3, 32, 32)).astype(np.float32)
    return model, params, state, port, x


@pytest.mark.parametrize("output", ["logits", "probs", "labels"])
def test_predict_fn_matches_jax(served, output):
    model, params, state, port, x = served
    ref = np.asarray(jax_make_predict_fn(model, params, state,
                                         output=output)(x))
    for buckets in (None, (4, 8)):
        out = make_predict_fn(port, output=output, buckets=buckets)(x)
        assert out.shape == ref.shape
        if output == "labels":
            np.testing.assert_array_equal(out.numpy(), ref)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_predict_fn_buckets_pad_with_last_row(served):
    _, _, _, port, x = served
    seen = []
    hook = port.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    try:
        fn = make_predict_fn(port, buckets=(8, 4))
        out = fn(x)
        big = fn(np.concatenate([x] * 3))  # 9 rows: above every bucket
    finally:
        hook.remove()
    assert seen == [(4, 3, 32, 32), (9, 3, 32, 32)]
    np.testing.assert_allclose(out.numpy(), make_predict_fn(port)(x).numpy(),
                               rtol=0, atol=1e-6)
    assert big.shape == (9, 10)


def test_cli_summary_keys_match_jax_cli(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--preset", "mnist",
                                      "--batch-size", "2"])
    jax_serve_cli.main()
    jax_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = _run_port_cli("--device", "cpu", "--batch-size", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(summary) == list(jax_summary)
    assert summary["preset"] == "cifar10_noconv"
    assert summary["batch"] == 2 and len(summary["predictions"]) == 2
    assert summary["restored"] is False


def test_cli_serves_reference_checkpoint(served, tmp_path, capsys):
    _, _, _, port, x = served
    ckpt = tmp_path / "best_model.pth"
    torch.save(port.state_dict(), ckpt)
    np.save(tmp_path / "batch.npy", x)
    port_cli_main(["--preset", "cifar10_noconv", "--device", "cpu",
                   "--torch-checkpoint", str(ckpt),
                   "--input", str(tmp_path / "batch.npy"), "--output", "probs"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["restored"] is True and summary["shape"] == [3, 10]
    ref = make_predict_fn(port, output="labels")(x).tolist()
    assert summary["argmax"] == ref


def test_cli_refuses_cpu_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit) as exit_info:
        port_cli_main(["--preset", "cifar10_noconv", "--batch-size", "1"])
    assert exit_info.value.code not in (0, None)
    assert "--device cpu" in str(exit_info.value.code)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np, torch\n"
        "from cnn_pde_tpu_torch.models import build_model\n"
        "from cnn_pde_tpu_torch.serve import make_predict_fn\n"
        "import cnn_pde_tpu_torch.compat, cnn_pde_tpu_torch.serve_cli\n"
        "m = build_model('cifar10_noconv', device='cpu', "
        "fused_inference=True)\n"
        "x = np.random.default_rng(0).random((2, 3, 32, 32), np.float32)\n"
        "assert make_predict_fn(m, output='labels')(x).shape == (2,)\n"
        "import cnn_pde_tpu_torch.train.__main__\n"
        "from cnn_pde_tpu_torch.presets import PRESETS\n"
        "from cnn_pde_tpu_torch.train import make_train_step\n"
        "t = build_model('cifar10_noconv', device='cpu', fused_pde=True)\n"
        "step = make_train_step(t, PRESETS['cifar10_noconv']['train'], 1,\n"
        "                       torch.Generator())\n"
        "loss, _ = step(x, np.array([1, 2]))\n"
        "assert bool(torch.isfinite(loss))\n"
        "g = build_model('mnist', device='cpu', fused=True)\n"
        "gstep = make_train_step(g, PRESETS['mnist']['train'], 1,\n"
        "                        torch.Generator())\n"
        "gx = np.random.default_rng(1).random((2, 1, 28, 28), np.float32)\n"
        "assert bool(torch.isfinite(gstep(gx, np.array([3, 4]))[0]))\n"
        "from cnn_pde_tpu_torch.pde import enable_amp\n"
        "from cnn_pde_tpu_torch.serve import cache_hoisted_operators\n"
        "s = build_model('svhn', device='cpu')\n"
        "assert enable_amp(s) == 1 and cache_hoisted_operators(s) == 1\n"
        "sx = np.random.default_rng(2).random((2, 3, 32, 32), np.float32)\n"
        "assert make_predict_fn(s)(sx).shape == (2, 10)\n"
        "e = build_model('emotion', device='cpu')\n"
        "ex = np.random.default_rng(3).random((2, 1, 48, 48), np.float32)\n"
        "assert make_predict_fn(e)(ex).shape == (2, 7)\n"
        "ti = build_model('tiny_imagenet', device='cpu', pde_implicit=True)\n"
        "assert enable_amp(ti) == 0 and cache_hoisted_operators(ti) == 0\n"
        "tx = np.random.default_rng(4).random((2, 3, 64, 64), np.float32)\n"
        "assert make_predict_fn(ti)(tx).shape == (2, 200)\n"
        "from cnn_pde_tpu_torch.serve import (export_model, load_exported,\n"
        "    linearize_pde_layers)\n"
        "from cnn_pde_tpu_torch.pde.linearize import QuantizedMatrix\n"
        "from cnn_pde_tpu_torch.serve_batch import MicroBatcher\n"
        "from cnn_pde_tpu_torch.serve_http import serve_http\n"
        "assert linearize_pde_layers(g, gx, dtype='int8') == 1\n"
        "assert isinstance(g.diff.linear_cache, QuantizedMatrix)\n"
        "with MicroBatcher(make_predict_fn(g, output='labels')) as mb:\n"
        "    assert mb(gx).shape == (2,)\n"
        "assert load_exported(export_model(g, gx))(gx).shape == (2, 10)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'cnn_pde_tpu' or k.startswith('cnn_pde_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def mnist_checkpoint(tmp_path_factory):
    """JAX MNIST weights as a reference checkpoint both CLIs read, and the
    same weights in the port."""
    from cnn_pde_tpu.models import MNISTClassifier

    model = MNISTClassifier()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
    sd = state_dict_from_jax(params, state, "mnist")
    path = tmp_path_factory.mktemp("ckpt") / "best_model.pth"
    torch.save(sd, path)
    port = build_model("mnist", device="cpu")
    port.load_state_dict(sd, strict=True)
    return path, port


def test_concurrent_predicts_equal_serial_calls(mnist_checkpoint):
    """Eight threads calling one predict (as the HTTP server's handlers
    do) get what serial calls get."""
    _, port = mnist_checkpoint
    rng = np.random.default_rng(9)
    xs = [rng.random((1 + i % 3, 1, 28, 28)).astype(np.float32)
          for i in range(8)]
    fn = make_predict_fn(port, buckets=(2, 4))
    serial = [fn(x) for x in xs]
    results = [[] for _ in xs]
    barrier = threading.Barrier(len(xs))

    def worker(i):
        barrier.wait()
        for _ in range(3):
            results[i].append(fn(xs[i]))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for want, got in zip(serial, results):
        assert len(got) == 3 and all(torch.equal(g, want) for g in got)


CLI_FLAGS = [("--linearize",), ("--linearize", "bf16"),
             ("--linearize-int8",), ("--linearize-bf16", "--output", "probs"),
             ("--linearize", "auto", "--buckets", "1,64,1024"),
             ("--export", "{path}")]


@pytest.mark.parametrize("flags", CLI_FLAGS,
                         ids=lambda f: "_".join(a.strip("-") for a in f))
def test_cli_flags_match_jax_cli(mnist_checkpoint, tmp_path, capsys,
                                 monkeypatch, flags):
    """Each new flag on --device cpu against the JAX CLI with the same
    weights and smoke batch: the same summary keys in the same order, the
    same values, and the same predictions."""
    ckpt, _ = mnist_checkpoint
    summaries = {}
    for name in ("jax", "port"):
        args = [a.format(path=tmp_path / f"{name}.export") for a in flags]
        argv = ["--preset", "mnist", "--torch-checkpoint", str(ckpt), *args]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            jax_serve_cli.main()
        else:
            port_cli_main([*argv, "--device", "cpu"])
        summaries[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    ours, theirs = summaries["port"], summaries["jax"]
    assert list(ours) == list(theirs)
    for key in ours:
        if key in ("exported", "shape", "argmax", "predictions"):
            continue
        assert ours[key] == theirs[key], key
    assert ours["linearized_layers"] == (1 if "linearize" in "".join(flags)
                                         else 0)
    if "predictions" in ours:
        assert ours["predictions"] == theirs["predictions"]
    else:
        assert ours["shape"] == theirs["shape"]
        assert ours["argmax"] == theirs["argmax"]
    if "exported" in ours:
        assert ours["exported"] == str(tmp_path / "port.export")
        assert (tmp_path / "port.export").stat().st_size > 0


def _lines(stream):
    """A queue of ``stream``'s lines, read by a daemon thread."""
    q = queue.Queue()

    def pump():
        for line in stream:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return q


def _predict_npy(base, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(
        f"{base}/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy",
                 "Accept": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def test_cli_http_microbatch_buckets_and_reload_watch(mnist_checkpoint,
                                                      tmp_path):
    """--http with --microbatch, --microbatch-wait-ms,
    --microbatch-pipeline, --buckets and --reload-watch: the server
    answers as the port's predict does; a new checkpoint is picked up by
    the watcher, which builds a fresh model from it."""
    ckpt, port = mnist_checkpoint
    served = tmp_path / "served.pth"
    served.write_bytes(ckpt.read_bytes())
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "cnn_pde_tpu_torch.serve", "--preset",
         "mnist", "--device", "cpu", "--torch-checkpoint", str(served),
         "--http", "0", "--microbatch", "4", "--microbatch-wait-ms", "5",
         "--microbatch-pipeline", "1", "--buckets", "1,4",
         "--reload-watch", "0.2", "--output", "logits"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = _lines(proc.stdout)
    try:
        first = lines.get(timeout=120)
        assert first.startswith("serving on http://"), first
        base = first.split()[2]
        x = np.random.default_rng(4).random((3, 1, 28, 28)).astype(
            np.float32)
        got = _predict_npy(base, x)
        want = make_predict_fn(port)(x).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        other = build_model("mnist", device="cpu",
                            generator=torch.Generator().manual_seed(7))
        torch.save(other.state_dict(), served)
        line = lines.get(timeout=120)
        assert "hot-swapped" in line, line
        got = _predict_npy(base, x)
        want = make_predict_fn(other)(x).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
