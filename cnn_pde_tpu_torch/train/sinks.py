"""Metrics sinks — port of ``cnn_pde_tpu/train/sinks.py``: each epoch
record of ``Trainer.fit`` streamed to JSONL, CSV or TensorBoard as soon as
it exists, so a killed run still leaves its metrics beside its
checkpoints.

    sink = JSONLSink("run/metrics.jsonl")        # or sink_from_path(...)
    trainer.fit(state, ds, metrics_sink=sink)
    sink.close()

or ``python -m cnn_pde_tpu_torch.train ... --metrics-out run/metrics.jsonl``
(the extension picks the format).
"""

import csv
import json
import os
import time


def _jsonable(v):
    """Coerce scalars (numpy and torch 0-d ones too) to plain Python; drop
    the rest."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)  # a numpy or torch scalar
    except (TypeError, ValueError):
        return None


def _clean(record):
    out = {}
    for k, v in record.items():
        j = _jsonable(v)
        if j is not None:
            out[k] = j
    return out


class MetricsSink:
    """Base sink: ``log(record)`` per epoch, ``close()`` when done.

    Subclasses override ``log``/``close``; the base is a usable no-op sink
    and a context manager (``with JSONLSink(p) as s: ...``)."""

    def log(self, record):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class JSONLSink(MetricsSink):
    """One JSON object per line, flushed per record (crash-durable).

    Adds a ``wall_time`` unix timestamp to every record so post-hoc tooling
    can reconstruct the run's timeline."""

    def __init__(self, path):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def log(self, record):
        rec = _clean(record)
        rec.setdefault("wall_time", round(time.time(), 3))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


#: columns every training run can produce; the CSV header is the union of
#: these and the first record's keys, so 'test_acc' (absent on non-eval
#: epochs) still gets a column even when the first epoch lacks it.
CSV_KNOWN_FIELDS = ("epoch", "loss", "acc", "test_acc", "time", "chunk")


class CSVSink(MetricsSink):
    """CSV with a header fixed at the first record (union with
    CSV_KNOWN_FIELDS); keys outside the header are dropped — use JSONL for
    fully open-schema logging."""

    def __init__(self, path):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8", newline="")
        self._writer = None

    def log(self, record):
        rec = _clean(record)
        if self._writer is None:
            fields = list(CSV_KNOWN_FIELDS)
            fields += [k for k in rec if k not in fields]
            self._writer = csv.DictWriter(self._f, fieldnames=fields,
                                          restval="", extrasaction="ignore")
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(rec)
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class TensorBoardSink(MetricsSink):
    """Scalars to a TensorBoard event file via torch.utils.tensorboard,
    imported when the sink is made; without the tensorboard package it
    raises an ImportError that says so."""

    def __init__(self, logdir):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorBoardSink needs the 'tensorboard' package "
                "(torch.utils.tensorboard failed to import); use JSONLSink "
                f"or CSVSink instead: {e}") from e
        self._writer = SummaryWriter(log_dir=str(logdir))

    def log(self, record):
        rec = _clean(record)
        step = int(rec.get("epoch", 0))
        for k, v in rec.items():
            if k != "epoch" and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                self._writer.add_scalar(f"train/{k}", v, global_step=step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class MultiSink(MetricsSink):
    """Fan one record out to several sinks."""

    def __init__(self, *sinks):
        self.sinks = list(sinks)

    def log(self, record):
        for s in self.sinks:
            s.log(record)

    def close(self):
        for s in self.sinks:
            s.close()


def sink_from_path(path):
    """Pick a sink by extension: .jsonl/.ndjson → JSONL, .csv → CSV,
    a directory-looking path (no extension or trailing slash) → TensorBoard."""
    p = str(path)
    ext = os.path.splitext(p)[1].lower()
    if ext in (".jsonl", ".ndjson"):
        return JSONLSink(p)
    if ext == ".csv":
        return CSVSink(p)
    if ext == "" or p.endswith(os.sep):
        return TensorBoardSink(p)
    raise ValueError(f"unknown metrics sink extension {ext!r} for {p!r}; "
                     "use .jsonl, .csv, or a directory (TensorBoard)")
