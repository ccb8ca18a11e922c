"""Device-time split of one jitted program from a jax.profiler trace.

The profiler names each device event after the HLO instruction that
ran (the `hlo_op` stat); the compiled HLO text maps every instruction
to the `jax.named_scope` path it came from (`op_name` metadata).  The
two together attribute device time to the program's own stages:

    scopes = hlo_scopes(jitted.lower(*args).compile().as_text())
    with jax.profiler.trace(logdir):
        ...run the program...
    events = op_events(xplane_path(logdir))
    split = split_by_scope(events, scopes, ("filters", "colour"))

Only events on planes whose name starts with `plane_prefix` count:
"/device:GPU" for the card, "/host:CPU" for XLA's CPU backend.  Where
XLA's GPU backend runs a program as a command buffer, every kernel's
`hlo_op` reads "command_buffer"; the kernel name then stands in (a
fusion's kernel is its instruction name with "_N" for ".N"), and
library kernels such as cuBLAS gemms stay unmapped.  Tracing with
XLA_FLAGS=--xla_gpu_enable_command_buffer= keeps every instruction
name.
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                    r"metadata=\{[^}]*?op_name=\"([^\"]*)\"")


class OpEvent(NamedTuple):
    hlo_op: str
    start_ns: float
    dur_ns: float
    name: str = ""


def hlo_scopes(hlo_text: str) -> Dict[str, str]:
    """{HLO instruction name: op_name path} from compiled HLO text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def xplane_path(logdir: str) -> str:
    """The newest .xplane.pb file a jax.profiler trace wrote."""
    paths = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return max(paths, key=os.path.getmtime)


def op_events(path: str, plane_prefix: str = "/device:GPU"
              ) -> List[OpEvent]:
    """Every event carrying an `hlo_op` stat on the matching planes."""
    from jax.profiler import ProfileData
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op:
                    out.append(OpEvent(str(op), float(ev.start_ns),
                                       float(ev.duration_ns),
                                       str(ev.name)))
    return out


def busy_ns(events: Iterable[OpEvent]) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, None
    for s, e in sorted((ev.start_ns, ev.start_ns + ev.dur_ns)
                       for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def scope_of(op_name: str, keys: Sequence[str]) -> str:
    """The first path component of op_name that starts with one of
    keys, or "other"."""
    for part in op_name.split("/"):
        for k in keys:
            if part.startswith(k):
                return part
    return "other"


def op_name_of(ev: OpEvent, scopes: Dict[str, str]):
    """The op_name path of an event's instruction, or None."""
    for key in (ev.hlo_op, ev.name, _KERNEL_SUFFIX.sub(r".\1", ev.name)):
        if key in scopes:
            return scopes[key]
    return None


_KERNEL_SUFFIX = re.compile(r"_(\d+)$")


def split_by_scope(events: Iterable[OpEvent], scopes: Dict[str, str],
                   keys: Sequence[str]) -> Dict[str, float]:
    """Summed device ns per scope; instructions not in `scopes` (other
    programs, runtime copies, library kernels inside a command buffer)
    land in "unmapped"."""
    out = defaultdict(float)
    for ev in events:
        op = op_name_of(ev, scopes)
        out["unmapped" if op is None else scope_of(op, keys)] += ev.dur_ns
    return dict(out)
