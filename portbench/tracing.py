"""The traced run's spans and their reduction to a record.

`Wrappers` wraps each layer's entry points, as `layers/<layer>.json`
names them.  While `ranges` is on (the profiled batches) each call runs
in a torch.profiler.record_function range named "pb:<layer>:<entry>"
(with "|<argument shapes>" where the layer asks for them); always, the
call's host time is added up under that name (`host_s`), so batches
timed without the profiler still give each layer's host time.  An entry is {"module", "attr"}: the attribute is replaced
where its callers look it up.  Options: "args": true records the
arguments' shapes; "returns": true wraps each callable that the call
returns (and each callable attribute of it, such as `solve.pair`) as
"<entry>.<index>[.<attribute>]"; "count_arg": i counts the calls of the
callable passed as positional argument i.

`reduce_trace` reads a Chrome trace of whole batches and gives the
record that `metrics/*.py` read: per layer the host time of its ranges
and the device time of the kernels launched inside them, per call of a
layer that records arguments its shapes and device time, the device's
busy time, and the breakdown.  It first checks that every kernel launch
the host recorded has its device event, matched by correlation id, and
the reverse, so that a dropped event fails the run and never reads as a
short device time.
"""

import bisect
import collections
import importlib
import json
import re
import time

import torch

from . import yardstick

PREFIX = "pb:"
BATCH = PREFIX + "batch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"LaunchKernel|LaunchCooperativeKernel")


class TraceError(RuntimeError):
    """The trace is incomplete: the profiler dropped events."""


def _describe(args):
    out = []
    for a in args:
        if torch.is_tensor(a):
            out.append("T" + "x".join(map(str, a.shape)))
        elif isinstance(a, (bool, int, float)):
            out.append(repr(a))
        else:
            out.append("-")
    return ",".join(out)


class Wrappers:
    """Installs the ranges of the given layers ({slug: layer dict}) and
    removes them again."""

    def __init__(self, layers):
        self.layers = layers
        self.counts = collections.Counter()
        self.host_s = collections.Counter()
        self.ranges = False
        self._saved = []

    def reset(self):
        self.counts.clear()
        self.host_s.clear()

    def _wrap(self, fn, label, entry):
        record_args = entry.get("args", False)
        count_arg = entry.get("count_arg")
        returns = entry.get("returns", False)
        counts, host_s = self.counts, self.host_s

        def counting(inner, key):
            def call(*a, **k):
                counts[key] += 1
                return inner(*a, **k)
            return call

        def wrapper(*args, **kwargs):
            if count_arg is not None and len(args) > count_arg:
                args = list(args)
                args[count_arg] = counting(args[count_arg],
                                           f"{label}#arg{count_arg}")
            t0 = time.perf_counter()
            if self.ranges:
                name = label + ("|" + _describe(args) if record_args
                                else "")
                with torch.profiler.record_function(name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            host_s[label] += time.perf_counter() - t0
            if returns and isinstance(out, tuple):
                out = tuple(self._wrap_returned(o, f"{label}.{i}")
                            for i, o in enumerate(out))
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def _wrap_returned(self, obj, label):
        if not callable(obj):
            return obj
        w = self._wrap(obj, label, {})
        for k, v in vars(obj).items():
            setattr(w, k, self._wrap(v, f"{label}.{k}", {})
                    if callable(v) else v)
        return w

    def install(self):
        for slug, layer in self.layers.items():
            for entry in layer["entries"]:
                mod = importlib.import_module(entry["module"])
                fn = getattr(mod, entry["attr"])
                self._saved.append((mod, entry["attr"], fn))
                label = f"{PREFIX}{slug}:{entry['attr']}"
                setattr(mod, entry["attr"], self._wrap(fn, label, entry))

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


def _intervals_by_tid(events):
    by = collections.defaultdict(list)
    for e in events:
        by[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    return {tid: _merge(spans) for tid, spans in by.items()}


def _merge(spans):
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _inside(merged, tid, ts):
    spans = merged.get(tid)
    if not spans:
        return False
    i = bisect.bisect_right(spans, [ts, float("inf")]) - 1
    return i >= 0 and spans[i][0] <= ts <= spans[i][1]


def _short(name):
    return re.sub(r"\([^()]*\)$", "", name)[:96]


def reduce_trace(trace, layers):
    """The record of a Chrome trace (a dict) of whole batches, each in a
    BATCH range, with the ranges of `layers` ({slug: layer dict})."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    launches = {c for c, e in runtime.items() if LAUNCH.search(e["name"])}
    got = {e["args"].get("correlation") for e in kernels}
    lost = launches - got
    orphans = got - set(runtime)
    if lost or orphans:
        raise TraceError(
            f"the profiler dropped events: {len(lost)} of {len(launches)} "
            f"kernel launches have no device event and {len(orphans)} of "
            f"{len(kernels)} kernels no launch")
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX)]
    batches = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges
                     if e["name"] == BATCH)
    if not batches:
        raise TraceError("no batch range in the trace")

    def launch_of(k):
        r = runtime[k["args"]["correlation"]]
        return r["tid"], r["ts"]

    rec = {"batches": len(batches),
           "batch_host_s": [(t1 - t0) / 1e6 for t0, t1 in batches],
           "kernels": len(kernels), "layers": {}}
    for slug, layer in layers.items():
        mine = [e for e in ranges
                if e["name"].startswith(f"{PREFIX}{slug}:")]
        merged = _intervals_by_tid(mine)
        ks = [k for k in kernels if _inside(merged, *launch_of(k))]
        host = sum(t1 - t0 for spans in merged.values() for t0, t1 in spans)
        info = {"host_s": host / 1e6, "kernels": len(ks),
                "device_s": sum(k["dur"] for k in ks) / 1e6}
        if any(en.get("args") for en in layer["entries"]):
            info["calls"] = _calls(mine, ks, launch_of)
        rec["layers"][slug] = info
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    clipped = yardstick.clip_spans(spans, batches)
    rec["window_s"] = sum(rec["batch_host_s"])
    rec["busy_s"] = yardstick.union_seconds(clipped) / 1e6
    rec["breakdown"] = _breakdown(kernels, device, batches, ranges)
    return rec


def _calls(mine, ks, launch_of):
    """Each range of `mine` (innermost first where they nest) with its
    name's entry and shapes and the kernels launched inside it."""
    rows = sorted(((e["tid"], e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in mine), key=lambda r: (r[0], r[1]))
    out = [{"entry": name.split(":", 2)[2].split("|")[0],
            "args": _parse_args(name), "device_s": 0.0, "kernels": 0}
           for _, _, _, name in rows]
    starts = collections.defaultdict(list)
    for i, (tid, t0, _, _) in enumerate(rows):
        starts[tid].append((t0, i))
    for k in ks:
        tid, ts = launch_of(k)
        lst = starts[tid]
        j = bisect.bisect_right(lst, (ts, float("inf"))) - 1
        while j >= 0 and rows[lst[j][1]][2] < ts:
            j -= 1
        if j >= 0:
            c = out[lst[j][1]]
            c["device_s"] += k["dur"] / 1e6
            c["kernels"] += 1
    return out


def _parse_args(name):
    """The arguments that `_describe` wrote into a range's name: a
    tensor's shape as a tuple, a number as itself, anything else None."""
    if "|" not in name:
        return []
    out = []
    for a in name.split("|", 1)[1].split(","):
        if a.startswith("T"):
            out.append(tuple(int(d) for d in a[1:].split("x") if d))
        else:
            try:
                out.append(json.loads(a.lower()))
            except ValueError:
                out.append(None)
    return out


def _breakdown(kernels, device, batches, ranges, top=10):
    """The device operations that took most time, and the longest idle
    gaps by the innermost range the host was in."""
    by = collections.Counter()
    for k in kernels:
        by[_short(k["name"])] += k["dur"] / 1e6
    busy = _merge(yardstick.clip_spans(
        [(e["ts"], e["ts"] + e["dur"]) for e in device], batches))
    gaps = []
    for w0, w1 in batches:
        t = w0
        for b0, b1 in busy:
            if b1 <= w0 or b0 >= w1:
                continue
            if b0 > t:
                gaps.append((t, b0))
            t = max(t, b1)
        if w1 > t:
            gaps.append((t, w1))
    inner = sorted(((e["ts"], e["ts"] + e["dur"], e["name"].split("|")[0])
                    for e in ranges if e["name"] != BATCH))
    idle = collections.Counter()
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while i < len(inner) and inner[i][0] <= mid:
            while stack and stack[-1][1] < inner[i][0]:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = (stack[-1][2][len(PREFIX):] if stack
                else "host outside the wrapped layers")
        idle[name] += (g1 - g0) / 1e6
    return {"device_ops": [[k, v] for k, v in by.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
