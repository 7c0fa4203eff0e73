"""Host-side tracer: a versioned JSONL span / event sink (port of
``repro.obs.trace``, schema v1 unchanged).

One record per line, every record carrying ``{"v": SCHEMA_VERSION}``.
Four record kinds make up schema v1:

  * ``meta``: the first line of every file: ``schema``, wall-clock ``ts``
    and the run's metadata (arch, topology, ...);
  * span records (``"type": "span"``): a timed section; ``kind`` names it
    (``compile``: a round during which ``kernels/build.py`` built or
    loaded a CUDA library, ``chunk``: any other round, ``eval``,
    ``checkpoint``), with ``ts`` (wall clock at entry) and ``dur_s``;
  * ``event`` records: instantaneous marks (``flush``, an async buffer
    flush read off the round metrics; ``eval``);
  * ``stages`` / ``round``: ``stages`` names the RoundStats byte slots
    once, then one ``round`` record per round with every metric flattened
    to ``m`` under dotted names (NaN as null, which is how the eval
    cadence's skipped rounds serialise).

Only the standard library is imported at module level (torch loads inside
the helpers that need it), so :mod:`repro_torch.obs.report` validates and
renders anywhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time

SCHEMA_VERSION = 1


def _json_scalar(x: float):
    x = float(x)
    return None if x != x else x      # NaN (cadence-skipped eval) -> null


def _flatten(node, prefix, out: dict) -> None:
    """Metric leaves under dotted names, in ``jax.tree_util`` order: dict
    keys sorted, dataclass fields in order, ``None`` left out (JAX drops a
    ``None`` leaf)."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], prefix + (str(k),), out)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _flatten(getattr(node, f.name), prefix + (f.name,), out)
    else:
        out[".".join(prefix)] = node


class Tracer:
    """Append-only JSONL sink.  Construct with the ``--trace`` path; every
    write flushes, so a killed run keeps its prefix."""

    def __init__(self, path: str, profile_dir: str = "", meta: dict = None):
        self.path = str(path)
        self.profile_dir = profile_dir or ""
        self._f = open(self.path, "w")
        self._write(dict(kind="meta", schema=SCHEMA_VERSION,
                         ts=time.time(), **(meta or {})))

    # ------------------------------------------------------------------ sink
    def _write(self, rec: dict) -> None:
        rec = {"v": SCHEMA_VERSION, **rec}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def event(self, kind: str, **attrs) -> None:
        self._write(dict(kind=kind, type="event", ts=time.time(), **attrs))

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        """Timed section; yields a mutable attrs dict so that the body can
        retag itself (a ``chunk`` span becoming ``compile``)."""
        rec = dict(kind=kind, **attrs)
        ts, t0 = time.time(), time.perf_counter()
        try:
            yield rec
        finally:
            self._write(dict(type="span", ts=ts,
                             dur_s=time.perf_counter() - t0, **rec))

    def close(self) -> None:
        self._f.close()

    # --------------------------------------------------------- torch helpers
    def profile(self):
        """Context manager: ``torch.profiler`` (CPU, and CUDA where there
        is a card) around the run, writing a Chrome / TensorBoard trace
        into ``profile_dir`` when one was given; else a no-op."""
        if not self.profile_dir:
            return contextlib.nullcontext()
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler
            .tensorboard_trace_handler(self.profile_dir))

    def emit_rounds(self, metrics, spec=None) -> None:
        """Write ``run_rounds``' stacked metrics as one ``round`` record
        per row.  ``spec`` (a TelemetrySpec) writes the ``stages`` naming
        record first.  Leaves flatten to dotted names
        (``ledger.uplink_wire``, ``round_stats.up_stage_bytes``); vector
        leaves serialise as lists, NaN as null."""
        import torch
        if metrics is None:
            return
        if spec is not None:
            self._write(dict(kind="stages", up=list(spec.up_names),
                             down=list(spec.down_names)))
        flat = {}
        _flatten(metrics, (), flat)
        for k, v in flat.items():
            v = v.detach().cpu()
            flat[k] = (v.to(torch.float32) if v.dtype == torch.bfloat16
                       else v).numpy()
        if not flat:
            return
        n = len(next(iter(flat.values())))
        for i in range(n):
            row = {}
            for k, v in flat.items():
                x = v[i]
                row[k] = (_json_scalar(x) if x.ndim == 0 else
                          [_json_scalar(y) for y in x.ravel()])
            self._write(dict(kind="round", round=i, m=row))


# ---------------------------------------------------------------------------
# schema validation (standard library only)
# ---------------------------------------------------------------------------

def validate_record(rec: dict) -> None:
    """Raise ValueError when ``rec`` is not a well-formed v1 record."""
    if rec.get("v") != SCHEMA_VERSION:
        raise ValueError(f"schema version {rec.get('v')!r} != "
                         f"{SCHEMA_VERSION}")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        raise ValueError(f"record missing 'kind': {rec}")
    if kind == "meta" and rec.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"meta record schema mismatch: {rec}")
    if rec.get("type") == "span" and not isinstance(
            rec.get("dur_s"), (int, float)):
        raise ValueError(f"span record missing dur_s: {rec}")
    if kind == "round":
        if not isinstance(rec.get("m"), dict):
            raise ValueError(f"round record missing metrics dict: {rec}")
        if not isinstance(rec.get("round"), int):
            raise ValueError(f"round record missing round index: {rec}")
    if kind == "stages" and not isinstance(rec.get("up"), list):
        raise ValueError(f"stages record missing slot names: {rec}")


def validate_file(path: str) -> list:
    """Validate every line of a trace file; the first record must be the
    ``meta`` header.  Returns the parsed records."""
    records = []
    with open(path) as fh:
        for ln, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln + 1}: not JSON: {e}") from e
            validate_record(rec)
            records.append(rec)
    if not records:
        raise ValueError(f"{path}: empty trace")
    if records[0].get("kind") != "meta":
        raise ValueError(f"{path}: first record must be the meta header, "
                         f"got {records[0].get('kind')!r}")
    return records
