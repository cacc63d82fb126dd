"""The program's own spans in the traced sub-window, and the device's time
put down to them.

``posetpu_torch.utils.profiling`` records a span (its name, host start and
end on ``time.time_ns``'s clock in us, the id of the span open around it,
integer counts) while a profiler session runs, as the traced window's
does. Here they are cut to the window, bounded by the benchmark's own
spans of the traced iterations (``Trace.spans``), and two rules apply:

- device time: the window's launching calls (``Trace.host_ops`` named
  ``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*``, ``cudaMemset*``; a call
  that lies inside another, as a driver call inside the runtime's, counts
  once) are matched to the device operations (``Trace.ops``) in order: one
  stream runs them in the order they were launched. Each operation goes
  to the innermost program span open when its launch began. Where the two
  counts differ nothing is read.
- idle: each gap of ``Trace.gaps()`` goes to the innermost program span
  open on the host at its middle, unless the tracer held the host then
  (its ``Activity Buffer Request``, a host operation of the trace). Those,
  the gaps with no span open (the benchmark's loop), and the window's idle
  before its first and after its last operation go "outside".

Both rules see the host's time only, so a span on another thread than the
one that launched counts where it is open at the launch. A program that
records no spans (one older than them) gives None, and so does every
reader built on :func:`per_iteration`.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
TRACER = "Activity Buffer Request"
OUTSIDE = -1
# the span that marks one iteration of a cell's kind
ITERATION = {"serve": "serve.infer", "train": "train.step"}


@dataclass
class Attributed:
    """The window's program spans; the device us and idle us put down to
    each (by index, :data:`OUTSIDE` for the rest); the launches and device
    operations matched; for each span the names on its path to its root."""

    spans: list
    device_us: dict
    idle_us: dict
    launches: int
    ops: int
    paths: list = field(default_factory=list)

    def count(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)

    def under(self, name: str) -> list[int]:
        """The indices of the spans named ``name`` and of those inside them."""
        return [k for k, p in enumerate(self.paths) if name in p]


def cut(spans, tr) -> list:
    """The spans that lie inside the benchmark's spans of the traced window."""
    if not tr.spans:
        return []
    lo, hi = min(a for _, a, _ in tr.spans), max(b for _, _, b in tr.spans)
    return [s for s in spans if s.start_us >= lo and s.end_us <= hi]


def innermost(spans, times) -> list[int]:
    """For each of the ascending ``times``, the index in ``spans`` of the
    innermost span open then (the latest to start), or :data:`OUTSIDE`."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_us, -spans[i].end_us))
    out, active, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]].start_us <= t:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i].end_us >= t]
        out.append(active[-1] if active else OUTSIDE)
    return out


def launches(host_ops) -> list:
    """The launching calls, in order, each once."""
    calls = sorted((h for h in host_ops if h[0].startswith(LAUNCHES)),
                   key=lambda h: (h[1], -h[2]))
    out, end = [], float("-inf")
    for call in calls:
        if call[2] <= end:
            continue
        out.append(call)
        end = call[2]
    return out


def attribute(tr, spans) -> Attributed | None:
    """Both rules over the trace ``tr`` and the window's ``spans``; None
    without spans, without device operations, or where the launches and
    the operations differ in number."""
    ops = sorted(tr.ops, key=lambda o: o[1])
    calls = launches(tr.host_ops)
    if not spans or not ops or len(calls) != len(ops):
        return None
    device, idle = {}, {}
    for s, (_, a, b) in zip(innermost(spans, [c[1] for c in calls]), ops):
        device[s] = device.get(s, 0.0) + (b - a)
    gaps = tr.gaps()
    held = [(a, b) for n, a, b in tr.host_ops if n == TRACER]
    for s, (a, b) in zip(innermost(spans, [(a + b) / 2 for a, b in gaps]), gaps):
        if any(c <= (a + b) / 2 <= d for c, d in held):
            s = OUTSIDE
        idle[s] = idle.get(s, 0.0) + (b - a)
    idle[OUTSIDE] = (idle.get(OUTSIDE, 0.0) + tr.wall_s * 1e6 - tr.busy_us()
                     - sum(b - a for a, b in gaps))
    index = {s.id: k for k, s in enumerate(spans)}
    paths: list = [None] * len(spans)

    def path(k):
        if paths[k] is None:
            up = index.get(spans[k].parent)
            paths[k] = {spans[k].name} | (path(up) if up is not None else set())
        return paths[k]

    for k in range(len(spans)):
        path(k)
    return Attributed(spans, device, idle, len(calls), len(ops), paths)


def recorded() -> list:
    """The program's recorded spans; [] where it records none."""
    try:
        from posetpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return []
    return program_recorded()


_cache: dict = {}


def read(rec) -> Attributed | None:
    """:func:`attribute` of the run's traced window, computed once a run;
    the first reading prints its counts to standard error."""
    tr = rec.trace
    if tr is None:
        return None
    hit = _cache.get(id(tr))
    if hit is not None and hit[0] is tr:
        return hit[1]
    spans = cut(recorded(), tr)
    att = attribute(tr, spans)
    _cache[id(tr)] = (tr, att)
    if spans:
        calls, ops = len(launches(tr.host_ops)), len(tr.ops)
        idle = sum(att.idle_us.values()) / 1e3 if att else None
        print(f"portbench: program spans {len(spans)} in the window; {calls} launches, "
              f"{ops} device operations; idle put down {idle} ms of "
              f"{tr.wall_s * 1e3 - tr.busy_us() / 1e3} ms", file=sys.stderr)
    if att is not None and tr.iterations:
        print("portbench: program spans by name, ms a traced iteration [device with what "
              "is inside, device itself, idle with what is inside, idle itself] "
              + json.dumps(_by_name(att, tr.iterations)), file=sys.stderr)
    return att


def _by_name(att, n) -> dict:
    def ms(d, ks):
        return sum(d.get(k, 0.0) for k in ks) / 1e3 / n

    out = {}
    for name in sorted({s.name for s in att.spans}):
        under = att.under(name)
        own = [k for k, s in enumerate(att.spans) if s.name == name]
        out[name] = [ms(att.device_us, under), ms(att.device_us, own),
                     ms(att.idle_us, under), ms(att.idle_us, own)]
    out["outside"] = [ms(att.device_us, [OUTSIDE])] * 2 + [ms(att.idle_us, [OUTSIDE])] * 2
    return out


def per_iteration(rec, kind: str, name: str, what: str):
    """Of the spans named ``name`` and those inside them, a traced
    iteration's device ms (``what="device"``) or idle ms (``"idle"``), or
    the sum of their count ``what`` over 1e6 (MB where it counts bytes).
    None unless the run is of ``kind``, the window holds one
    :data:`ITERATION` span an iteration, and one named ``name``."""
    if rec.kind != kind:
        return None
    att = read(rec)
    n = rec.trace.iterations if rec.trace is not None else 0
    if att is None or not n or att.count(ITERATION[kind]) != n or not att.count(name):
        return None
    ks = att.under(name)
    if what == "device":
        return sum(att.device_us.get(k, 0.0) for k in ks) / 1e3 / n
    if what == "idle":
        return sum(att.idle_us.get(k, 0.0) for k in ks) / 1e3 / n
    return sum(att.spans[k].counts.get(what, 0) for k in ks if att.spans[k].name == name) / 1e6 / n
