"""Op-trace lint: rules over the ops a hot-path function dispatches; the
port's counterpart of ``repro/analysis/jaxpr_lint.py``.

The reference reads the closed jaxpr, where routing is still visible as
named primitives (``pallas_call``, callbacks) before XLA lowers them away.
PyTorch has no traced program: its counterpart is the stream of ATen ops a
call dispatches, recorded here by a ``TorchDispatchMode`` (below autograd,
so a backward's ops are recorded too), together with how many kernel
wrappers the call reached. Rules:

  trace-f64
      An op produced a float64 or complex128 tensor (the reference's
      ``jaxpr-f64``: double precision leaking into the hot path).

  trace-host-sync
      The hot path waits for the device and copies to the host: a
      ``_local_scalar_dense`` (``.item()``, ``float(t)``, ``bool(t)``), an
      op whose output size depends on the data (``nonzero``,
      ``masked_select``), or a device-to-host copy (the reference's
      ``jaxpr-callback`` and ``hlo-host-transfer``). On the CPU only the
      first two can show; device-to-host copies show on the card.

  trace-kernel-missing
      The function was built with ``use_kernels=True`` but reached none of
      the port's kernels (the reference's ``jaxpr-pallas-missing``: the
      silent fallback). On the card this reads ``kernels.LAUNCHES``; on the
      CPU, where every wrapper runs its plain version, ``kernels.CALLS``,
      the wrappers' call counts: a route that quietly took plain PyTorch
      calls no wrapper on either.

``trace(fn, *args)`` runs ``fn`` once under the recorder and returns its
result and an ``OpTrace``; ``lint_trace`` applies the rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels
from repro_torch.analysis.findings import ERROR, Finding

_F64 = (torch.float64, torch.complex128)
#: ops that wait for the device: a scalar read, or an output sized by the data
_SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select"})


@dataclasses.dataclass
class OpTrace:
    """What one call dispatched (plain values only, so it pickles)."""

    device: str = "cpu"                                      # where the call ran
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    f64_ops: List[Tuple[str, str]] = dataclasses.field(default_factory=list)  # (op, dtype)
    host_syncs: List[str] = dataclasses.field(default_factory=list)  # op, or op + devices
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)     # CALLS delta
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # LAUNCHES delta

    def kernels_reached(self) -> int:
        """Kernel launches on the card; wrapper calls elsewhere."""
        counts = self.kernel_launches if self.device == "cuda" else self.kernel_calls
        return sum(counts.values())


def _device_to_host(name: str, args: tuple, kwargs: dict, out: Any) -> bool:
    """A copy whose source lies on an accelerator and whose result on the CPU."""
    if name == "aten::copy_":
        dst, src = args[0], args[1]
        return src.device.type != "cpu" and dst.device.type == "cpu"
    if name == "aten::_to_copy":
        return (isinstance(args[0], torch.Tensor) and args[0].device.type != "cpu"
                and isinstance(out, torch.Tensor) and out.device.type == "cpu")
    return False


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: OpTrace):
        super().__init__()
        self.t = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        t = self.t
        t.op_counts[name] = t.op_counts.get(name, 0) + 1
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.dtype in _F64:
                t.f64_ops.append((name, str(leaf.dtype).replace("torch.", "")))
                break
        if name in _SYNC_OPS:
            t.host_syncs.append(name)
        elif _device_to_host(name, args, kwargs, out):
            t.host_syncs.append(f"{name} (device to host)")
        return out


def trace(fn, *args, device: str = "cpu", **kwargs):
    """``(fn(*args, **kwargs), OpTrace)``: the call recorded op by op, and
    the kernel wrappers' calls and launches it made; ``device`` names where
    it runs (``"cuda"``: kernel presence is read from the launches)."""
    t = OpTrace(device=torch.device(device).type)
    calls0, launches0 = dict(kernels.CALLS), dict(kernels.LAUNCHES)
    with _Recorder(t):
        out = fn(*args, **kwargs)
    if t.device == "cuda":
        torch.cuda.synchronize()
    t.kernel_calls = {k: v - calls0[k] for k, v in kernels.CALLS.items() if v != calls0[k]}
    t.kernel_launches = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()
                         if v != launches0[k]}
    return out, t


def lint_trace(t: OpTrace, target: str, expect_kernels: bool = False) -> List[Finding]:
    """Every op-trace rule over one recorded call."""
    findings: List[Finding] = []
    for name, dtype in dict(t.f64_ops).items():  # one finding an op
        findings.append(Finding(
            rule="trace-f64", severity=ERROR, target=target, location=name,
            message=f"{name} produces {dtype} — double precision in the hot path"))
    for name in sorted(set(t.host_syncs)):
        findings.append(Finding(
            rule="trace-host-sync", severity=ERROR, target=target, location=name,
            message=(f"{name} x{t.host_syncs.count(name)} in the hot path — the host "
                     f"waits for the device each call")))
    if expect_kernels and not t.kernels_reached():
        where = "kernels.LAUNCHES" if t.device == "cuda" else "kernels.CALLS"
        findings.append(Finding(
            rule="trace-kernel-missing", severity=ERROR, target=target,
            location="whole call",
            message=(f"use_kernels=True but the call reached no kernel of the port "
                     f"({where} unchanged on {t.device}) — the kernel route silently "
                     f"fell back to plain PyTorch")))
    return findings
