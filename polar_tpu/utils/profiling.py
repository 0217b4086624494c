"""Profiling / tracing helpers (SURVEY.md §5 "Tracing / profiling").

The reference's only instrumentation is a wall-clock around the decode
call (``testbench.cc:170-175``). Here:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard/Perfetto trace of the jitted pipeline;
* :func:`annotate` — named TraceAnnotation for marking campaign phases;
* :func:`layer_breakdown` — device time per ``jax.named_scope`` (the step
  names ``channel``, ``encode``, ``decode`` and ``counters``) and the
  device idle share of a traced window.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device+host profiler trace of the enclosed block.

    View with TensorBoard (``tensorboard --logdir <log_dir>``) or load the
    .trace.json.gz into Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named annotation visible in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def _stat(event, key):
    for k, v in event.stats:
        if k == key:
            return v
    return None


def device_events(xplane_path: str):
    """``(name, hlo_op, start_ns, duration_ns)`` of every kernel event on
    the GPU planes of a profiler trace (``*.xplane.pb``)."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                out.append((ev.name, _stat(ev, "hlo_op"), ev.start_ns,
                            ev.duration_ns))
    return out


def op_scopes(hlo_text: str, scopes) -> dict:
    """Map each HLO instruction of a compiled module's text to the first of
    ``scopes`` (``jax.named_scope`` names) in its ``op_name`` metadata."""
    import re

    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    found = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        for s in scopes:
            if s in parts:
                # kernel names in a trace spell the instruction's dots as _
                found[m.group(1)] = found[m.group(1).replace(".", "_")] = s
                break
    return found


def busy_and_scopes(events, scope_of: dict) -> dict:
    """Reduce ``(name, hlo_op, start_ns, duration_ns)`` kernel events to
    device time per scope plus the busy and idle shares: busy is the union
    of the kernel intervals, the window runs from the first kernel start
    to the last kernel end. A kernel is looked up in ``scope_of`` by its
    name, then by its HLO op; unmatched kernels count under ``"other"``."""
    if not events:
        raise ValueError("no kernel events")
    per: dict = {}
    spans = []
    for name, hlo_op, start, dur in events:
        key = scope_of.get(name, scope_of.get(hlo_op or "", "other"))
        per[key] = per.get(key, 0.0) + dur
        spans.append((start, start + dur))
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {"window_ns": window, "busy_ns": busy,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels": len(events), "by_scope_ns": per}


def layer_breakdown(xplane_path: str, hlo_text: str, scopes) -> dict:
    """:func:`busy_and_scopes` of the GPU kernels in a profiler trace,
    scoped by the ``jax.named_scope`` names ``scopes`` found in the
    compiled module's text (``compiled.as_text()``)."""
    events = device_events(xplane_path)
    if not events:
        raise RuntimeError(f"no GPU kernel events in {xplane_path}")
    return busy_and_scopes(events, op_scopes(hlo_text, scopes))
