"""Records of the collectives a rank makes: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses collectives out of compiled HLO text
(``collective_counts`` / ``collective_bytes`` over ``compiled.as_text()``).
The port has no compiled program: a rank issues each collective as a
``torch.distributed`` call. ``record_collectives()`` is a context manager
that, while it is open, wraps the ``torch.distributed`` collectives the
port calls (``dist.all_reduce(...)`` and the like, looked up on the module
at call time) and appends one ``CollectiveCall`` a call: its kind, in the
reference's HLO names (``all-reduce``, ``all-gather``, ``all-to-all``,
...), and the bytes the rank sent and received. Received bytes are those
of the buffers the call fills on this rank (an all-gather's whole output,
its own block included), as the reference counts an HLO collective's
result shape, and ``site``, the port's function that made the call
(``scripts/coll_probe_torch.py`` attributes bytes by it). The wrapped
calls run unchanged.

  collective_counts(calls)   calls per kind
  collective_bytes(calls)    received bytes per kind

Importing this module changes nothing; the wrappers exist only inside the
``with`` block, and the originals come back when it closes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Dict, Iterator, List, Sequence

import torch
import torch.distributed as dist

#: the torch.distributed functions recorded, by their kind in HLO's names
KINDS = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_to_all_single": "all-to-all",
    "all_to_all": "all-to-all",
    "broadcast": "broadcast",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "send": "send",
    "isend": "send",
    "recv": "recv",
    "irecv": "recv",
    "barrier": "barrier",
}


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective on one rank."""

    kind: str                   # "all-reduce", "all-gather", "all-to-all", ...
    fn: str                     # the torch.distributed function called
    sent: int                   # bytes this rank contributed
    received: int               # bytes of the buffers the call filled here
    buffers: tuple = ()         # (dtype, numel) of each buffer filled here
    site: str = ""              # "module.py:function" of the port's caller


_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _site() -> str:
    """The nearest caller outside this module and PyTorch."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if path != __file__ and not path.startswith(_TORCH_DIR):
            return f"{os.path.basename(path)}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _buffers(ts: Sequence[torch.Tensor]) -> tuple:
    return tuple((str(t.dtype).replace("torch.", ""), t.numel()) for t in ts)


def _sizes(fn: str, args: tuple, kwargs: dict):
    """(bytes sent, buffers filled) of a call of ``fn``."""
    def arg(i, name):
        return args[i] if len(args) > i else kwargs.get(name)

    if fn == "all_reduce":
        t = arg(0, "tensor")
        return _nbytes(t), [t]
    if fn == "broadcast":  # the source sends, the others receive (src: a global rank)
        t = arg(0, "tensor")
        return (_nbytes(t) if dist.get_rank() == arg(1, "src") else 0), [t]
    if fn == "all_gather":
        return _nbytes(arg(1, "tensor")), list(arg(0, "tensor_list"))
    if fn == "all_to_all":
        return (sum(_nbytes(t) for t in arg(1, "input_tensor_list")),
                list(arg(0, "output_tensor_list")))
    if fn == "all_to_all_single":
        return _nbytes(arg(1, "input")), [arg(0, "output")]
    if fn in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return _nbytes(arg(1, "input_tensor")), [arg(0, "output_tensor")]
    if fn == "reduce_scatter":
        return sum(_nbytes(t) for t in arg(1, "input_list")), [arg(0, "output")]
    if fn in ("send", "isend"):
        return _nbytes(arg(0, "tensor")), []
    if fn in ("recv", "irecv"):
        return 0, [arg(0, "tensor")]
    return 0, []  # barrier


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveCall]]:
    """Yields a list that receives one ``CollectiveCall`` per collective
    this process makes inside the block (module docstring)."""
    calls: List[CollectiveCall] = []
    originals = {fn: getattr(dist, fn) for fn in KINDS if hasattr(dist, fn)}

    def wrap(fn, original):
        def recorded(*args, **kwargs):
            sent, out = _sizes(fn, args, kwargs)
            result = original(*args, **kwargs)
            calls.append(CollectiveCall(kind=KINDS[fn], fn=fn, sent=sent,
                                        received=sum(_nbytes(t) for t in out),
                                        buffers=_buffers(out), site=_site()))
            return result
        return recorded

    for fn, original in originals.items():
        setattr(dist, fn, wrap(fn, original))
    try:
        yield calls
    finally:
        for fn, original in originals.items():
            setattr(dist, fn, original)


def collective_counts(calls: Sequence[CollectiveCall]) -> Dict[str, int]:
    """Calls per kind."""
    out: Dict[str, int] = {}
    for c in calls:
        out[c.kind] = out.get(c.kind, 0) + 1
    return out


def collective_bytes(calls: Sequence[CollectiveCall]) -> Dict[str, int]:
    """Received bytes per kind (a barrier moves none)."""
    out: Dict[str, int] = {}
    for c in calls:
        out[c.kind] = out.get(c.kind, 0) + c.received
    return out
