"""What one step costs: FLOPs, HBM bytes, collective bytes, device time.

The counterpart of both of the reference's cost modules:

* ``perf/hlo.py`` (``HloCostSummary``: XLA's ``cost_analysis`` of one
  compiled executable, and its collectives parsed from the optimized HLO)
  → :class:`StepCostSummary`, the same record (fields, ``to_dict`` keys,
  ``from_dict``), so downstream code (the roofline, the simulator's
  kernels) reads it unchanged;
* ``perf/hlo_cost_model.py`` (the loop-aware recount over the HLO text,
  because XLA counts a ``while`` body once) → :func:`count_step`.  An eager
  torch step dispatches every layer and every microbatch, so a count over
  one call is loop-aware by construction and needs no trip counts.

:func:`count_step` runs one call of a step on **fake copies** of its inputs
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
data, no device work), so the real step is never run under a counter and
nothing is allocated:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the dispatched
  ops, plus each hand-written kernel's FLOPs by formula, one count per
  launch as the wrapper records it on a fake tensor (``FlashLaunch``,
  ``SSDLaunch``), whatever the route;
* HBM bytes: an unfused count of every dispatched op (:class:`ByteCounter`:
  each op reads its inputs and writes its outputs once; not XLA's
  post-fusion ``bytes accessed``), plus each kernel's bytes by formula;
* argument and output bytes: the step's inputs and outputs.

Per-device FLOPs and bytes are the step's totals divided by ``chips``, an
even split (the reference reads the per-device count of an SPMD program).
Collective wire bytes per device come from a sharding plan's placements
(:func:`plan_collectives`): the all-gather of every parameter a step must
assemble (sharded over a data-parallel axis), and for a train step also
its gradient's reduce-scatter.  The port has no sharded model step yet, so
tensor-parallel activation collectives are not counted; ``counted_by``
says so.  Temp bytes (XLA's buffer assignment) have no counterpart and
read ``None``.

:func:`device_profile` reads what the card did in one call: device ms by
kernel from a ``torch.profiler`` trace, busy ms and the idle share of the
call's wall time.
"""

from __future__ import annotations

import re
import statistics
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import flash_attention as flash_kernel
from ..kernels import ssd_scan as ssd_kernel

__all__ = [
    "ByteCounter",
    "StepCostSummary",
    "count_step",
    "count_cell",
    "kernel_costs",
    "fake_launches",
    "plan_collectives",
    "per_rank_bytes",
    "device_profile",
    "COUNTED_BY",
]

#: what :func:`count_step` counts, and what it cannot see
COUNTED_BY = ("FlopCounterMode and an unfused dispatch byte count on fake tensors, plus each hand-written "
              "kernel's launches by formula; collectives: the parameter all-gathers and gradient "
              "reduce-scatters a sharding plan's placements need (tensor-parallel activation collectives "
              "not counted); totals split evenly over the chips; no temp bytes")


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs.

    An unfused count: each eager op is taken to read its inputs and write its
    outputs in full, once.  Views, allocations and metadata reads (the
    ``prim`` namespace, such as ``prim.device``, and the size, stride and
    scalar queries) move nothing and are skipped: a metadata read that some
    device's dispatch makes and another's does not would otherwise charge a
    whole tensor to one of them.  It is not XLA's ``bytes accessed`` (the
    reference's count, taken after fusion), and it cannot see a kernel
    launched through ctypes, whose bytes :func:`kernel_costs` adds by
    formula."""

    _NO_DATA = {
        torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default, torch.ops.aten.empty_like.default,
        torch.ops.aten._unsafe_view.default, torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default,
        torch.ops.aten.sym_size.int, torch.ops.aten.sym_stride.int, torch.ops.aten.sym_numel.default,
        torch.ops.aten.sym_storage_offset.default, torch.ops.aten.is_same_size.default,
        torch.ops.aten._local_scalar_dense.default,
    }

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in self._NO_DATA and func.namespace != "prim":
            self.bytes += sum(t.nbytes for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor))
        return out


@dataclass
class StepCostSummary:
    """Everything the roofline needs from one step: the fields, ``to_dict``
    keys and ``from_dict`` of the reference's ``HloCostSummary``.  ``None``
    marks what the port cannot count (XLA's temp and code bytes, so also
    the peak).  Beside them, not in ``to_dict``: ``counted_by`` (how), the
    ``parts`` of the FLOPs and bytes, the kernels' fake ``launches`` and the
    ``chips`` the totals were split over."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_wire_bytes_per_device: float
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    output_bytes: float = 0.0
    argument_bytes: float = 0.0
    temp_bytes: Optional[float] = None
    generated_code_bytes: Optional[float] = None
    peak_hbm_bytes: Optional[float] = None
    counted_by: str = COUNTED_BY
    parts: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, Counter] = field(default_factory=dict)
    chips: int = 1
    alias_bytes: float = 0.0  # of output_bytes, what the step wrote into its own inputs (in place)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_wire_bytes_per_device": self.collective_wire_bytes_per_device,
            "collective_breakdown": dict(self.collective_breakdown),
            "collective_count": self.collective_count,
            "output_bytes": self.output_bytes,
            "argument_bytes": self.argument_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StepCostSummary":
        return cls(**d)

    def loop_aware(self) -> dict:
        """The reference's ``CostReport.to_dict`` keys (its dry run's
        ``loop_aware`` record) from this count: an eager step dispatches
        every loop trip, so there is nothing to multiply."""
        return {
            "flops": self.flops_per_device,
            "hbm_bytes": self.hbm_bytes_per_device,
            "hbm_bytes_allops": self.hbm_bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes_per_device,
            "collective_breakdown": dict(self.collective_breakdown),
            "collective_count": self.collective_count,
            "n_while_loops": 0,
            "warnings": [],
        }


def fake_launches() -> Dict[str, Counter]:
    """The launches the kernel wrappers recorded on fake tensors so far, by
    kernel (copies of the wrappers' counters)."""
    return {"flash_forward": Counter(flash_kernel.flash_attention.fake_shapes),
            "flash_backward": Counter(flash_kernel.flash_attention_backward.fake_shapes),
            "ssd_kernel": Counter(ssd_kernel.ssd_scan.fake_shapes)}


def kernel_costs(launched: Dict[str, Counter]) -> Dict[str, float]:
    """FLOPs and bytes that the hand-written kernels add by formula: each
    launch at its own shape and mask as the wrapper recorded it
    (``launched["flash_forward"]``, ``["flash_backward"]``: counts by
    ``FlashLaunch``; ``["ssd_kernel"]``: counts by ``SSDLaunch``).  Keys:
    each kernel's name for FLOPs, ``"bytes_"`` + the name for bytes; a
    kernel that did not launch adds 0."""
    out: Dict[str, float] = {}
    for name, backward in (("flash_forward", False), ("flash_backward", True)):
        shapes = launched.get(name, {})
        out[name] = float(sum(n * rec.flops(backward) for rec, n in shapes.items()))
        out[f"bytes_{name}"] = float(sum(n * rec.bytes(backward) for rec, n in shapes.items()))
    shapes = launched.get("ssd_kernel", {})
    out["ssd_kernel"] = float(sum(n * rec.flops() for rec, n in shapes.items()))
    out["bytes_ssd_kernel"] = float(sum(n * rec.bytes() for rec, n in shapes.items()))
    return out


def _unique_bytes(tree) -> int:
    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            seen[id(t)] = t.nbytes
    return sum(seen.values())


def count_step(fn: Callable, *args, chips: int = 1, device=None,
               collectives: Optional[Dict[str, float]] = None, argument_bytes: Optional[float] = None
               ) -> StepCostSummary:
    """Count one call ``fn(*args)`` on fake copies of ``args``.

    Every tensor in ``args`` (nested dicts, lists, tuples) becomes a fake
    tensor of its shape, strides and dtype, on ``device`` where given (the
    same count for a cell's ``meta`` inputs on ``"cpu"`` or, on a machine
    with a GPU, ``"cuda"``) and on its own device otherwise (a ``meta``
    tensor on the CPU), keeping ``requires_grad``; a tensor that
    appears twice stays one.  A zero-dim tensor (AdamW's step) becomes a
    fake constant, so the step can read its value.  ``fn`` may update its
    inputs in place: only the fake copies change.  ``collectives`` is the
    wire bytes per device by kind (:func:`plan_collectives`), and
    ``argument_bytes`` the bytes a device holds of the inputs (their total
    split over ``chips`` if not given)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = fake_launches()
    mode = FakeTensorMode()
    cpu = torch.device("cpu")
    memo: Dict[int, torch.Tensor] = {}

    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in memo:
            dev = torch.device(device) if device is not None else t.device if t.device.type != "meta" else cpu
            if t.dim() == 0 and t.device.type == "cpu":
                value = t.item()
                with mode:
                    f = torch.tensor(value, dtype=t.dtype)
            else:
                with mode:
                    f = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=dev)
            memo[id(t)] = f.requires_grad_(t.requires_grad) if t.is_floating_point() else f
        return memo[id(t)]

    fake_args = tree_map(fake, args)
    with mode, FlopCounterMode(display=False) as flops, ByteCounter() as moved:
        out = fn(*fake_args)
    inputs = {id(t) for t in memo.values()}
    aliased = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor) and id(t) in inputs]
    after = fake_launches()
    launched = {name: after[name] - before[name] for name in after}
    parts = {"counted": float(flops.get_total_flops()), "bytes_counted": float(moved.bytes), **kernel_costs(launched)}
    total_flops = sum(v for k, v in parts.items() if not k.startswith("bytes_"))
    total_bytes = sum(v for k, v in parts.items() if k.startswith("bytes_"))
    collectives = dict(collectives or {})
    arg_bytes = _unique_bytes(args) / chips if argument_bytes is None else argument_bytes
    return StepCostSummary(
        flops_per_device=total_flops / chips,
        hbm_bytes_per_device=total_bytes / chips,
        collective_wire_bytes_per_device=float(sum(collectives.values())),
        collective_breakdown=collectives,
        collective_count=sum(1 for v in collectives.values() if v > 0),
        output_bytes=_unique_bytes(out) / chips,
        argument_bytes=float(arg_bytes),
        parts=parts,
        launches=launched,
        chips=chips,
        alias_bytes=_unique_bytes(aliased) / chips,
    )


def _shards(placements, mesh_sizes) -> int:
    """How many pieces ``placements`` (one per mesh dim) cut a tensor into."""
    from torch.distributed.tensor import Shard

    n = 1
    for p, size in zip(placements, mesh_sizes):
        if isinstance(p, Shard):
            n *= size
    return n


def _leaves(tree):
    """The leaves of a nested dict (anything not a dict), in key order."""
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key])
    else:
        yield tree


def per_rank_bytes(args, placements, mesh) -> float:
    """The bytes one rank holds of ``args`` (a tuple of trees) placed by
    ``placements`` (the matching tuple of placement trees: a list of
    placements per tensor, or one list for a whole tree, such as the batch
    rule)."""
    sizes = tuple(mesh.mesh.shape)
    total = 0.0
    for arg, pl in zip(args, placements):
        arg_leaves = [t for t in tree_flatten(arg)[0] if isinstance(t, torch.Tensor)]
        if isinstance(pl, dict):
            pl_leaves = list(_leaves(pl))
            if len(pl_leaves) != len(arg_leaves):
                raise ValueError(f"{len(arg_leaves)} tensors but {len(pl_leaves)} placements")
        else:
            pl_leaves = [pl] * len(arg_leaves)
        total += sum(t.nbytes / _shards(p, sizes) for t, p in zip(arg_leaves, pl_leaves))
    return total


def plan_collectives(params, placements, mesh, dp: tuple, *, train: bool) -> Dict[str, float]:
    """Wire bytes per device (ring model, as the reference's
    ``CollectiveOp.wire_bytes``) of the parameter traffic a sharded step
    needs: every parameter sharded over the data-parallel axes ``dp``
    (FSDP) is all-gathered once a step, ``r·(g-1)/g`` of its full size
    ``r`` for a group of ``g``, and a train step reduce-scatters its
    gradient, the same volume.  A parameter sharded over the model axis is
    used in place (its activation collectives are not counted)."""
    from torch.distributed.tensor import Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    gather = 0.0
    for t, pl in zip(_leaves(params), _leaves(placements)):
        g = 1
        for p, name in zip(pl, names):
            if isinstance(p, Shard) and name in dp:
                g *= sizes[name]
        if g > 1:
            gather += t.nbytes * (g - 1) / g
    out = {"all-gather": gather}
    if train:
        out["reduce-scatter"] = gather
    return out


def count_cell(cell, device=None, args=None) -> StepCostSummary:
    """:func:`count_step` of a :class:`~repro_torch.launch.steps.CellSpec`:
    its step on fake copies of its abstract inputs (on ``device`` if given)
    or of ``args`` (real inputs of the same shapes, such as
    ``launch.steps.materialize``'s, faked on their own device), split over
    its chips, with the parameter collectives its plan's placements need
    (:func:`plan_collectives`) and the bytes a rank holds of its inputs
    (:func:`per_rank_bytes`)."""
    mesh = cell.plan.mesh
    colls = plan_collectives(cell.args[0], cell.in_shardings[0], mesh, cell.plan.dp,
                             train=cell.step_name == "train_step")
    return count_step(cell.fn, *(cell.args if args is None else args), chips=cell.chips, device=device,
                      collectives=colls, argument_bytes=per_rank_bytes(cell.args, cell.in_shardings, mesh))


#: device_profile's witnesses: the spin kernels on each side of the traced call, the host sleep between
#: them and the trace window's edge (doubled on each retake), and the traces taken before it gives up
PROFILE_SPINS, PROFILE_MARGIN_S, PROFILE_TRIES = 16, 0.05, 4


def device_profile(fn: Callable[[], Any], *, wall_rounds: int = 3) -> Dict[str, Any]:
    """What the card does in one call of ``fn`` (after one warm-up call).

    ``wall_ms`` is the median of ``wall_rounds`` calls on the host clock,
    each synchronised, no profiler (0 rounds: not read).  ``us_by_kernel``
    is the device microseconds of one call by kernel, memset or memcpy,
    from a ``torch.profiler`` trace of the device's events alone;
    ``busy_ms`` their sum, ``idle_share`` ``1 - busy / wall``.  The traced
    call sits between two runs of ``PROFILE_SPINS`` spin kernels, left out
    of the result, each ``PROFILE_MARGIN_S`` of host sleep inside the
    trace's window: late in a long process the profiler drops device events
    near the window's edges (its clock conversion drifts), so a spin seen on
    each side shows that every event of ``fn`` came through.  A trace that
    lost one side's spins is taken again at twice the margin
    (``retaken_margins_s``); after ``PROFILE_TRIES`` such traces it raises.
    ``lead_ms`` is how long after its margin the kept trace's first device
    event came."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(PROFILE_SPINS):
            torch.cuda._sleep(100)

    walls = []
    fn()
    torch.cuda.synchronize()
    for _ in range(wall_rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    margin, retaken = PROFILE_MARGIN_S, []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # host ops left out: ~10x the trace time
            time.sleep(margin)
            spin()
            fn()
            spin()
            torch.cuda.synchronize()
            time.sleep(margin)
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        own = [e for e in events if "spin_kernel" not in e.name]
        if own:
            first, last = own[0].time_range.start, own[-1].time_range.start
            spin_starts = [e.time_range.start for e in events if "spin_kernel" in e.name]
            if any(t < first for t in spin_starts) and any(t > last for t in spin_starts):
                by_kernel: Dict[str, float] = {}
                for e in own:
                    name = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", ""))[:48]
                    by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us()
                busy = sum(by_kernel.values()) / 1e3
                wall = statistics.median(walls) if walls else None
                return {"us_by_kernel": by_kernel, "busy_ms": busy, "wall_ms": wall,
                        "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
                        "device_events": len(own), "lead_ms": events[0].time_range.start / 1e3 - margin * 1e3,
                        "retaken_margins_s": retaken}
        retaken.append(margin)
        print(f"device_profile: a profiler trace lost every spin kernel of one side at a margin of {margin} s; "
              "taking it again", file=sys.stderr, flush=True)
        margin *= 2
    raise RuntimeError(f"{PROFILE_TRIES} profiler traces each lost every spin kernel on one side of the call, "
                       "so some of the call's events too")
