"""Multi-pod dry run: build and count every (architecture × shape × mesh)
cell and record its memory, cost and collective evidence.

The reference's ``launch/dryrun.py`` over the port.  Where the reference
lowers and compiles each cell for 512 forced host devices, this builds the
mesh over torch's ``fake`` process-group backend (every rank of a 256- or
512-rank mesh in one process, no device) and counts one call of the cell's
step on fake tensors (:func:`repro_torch.perf.cost.count_cell`).  It runs
on a CPU:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape decode_32k --mesh tiny
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, 1-pod + 2-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod1

Records land in ``artifacts/dryrun/<arch>__<shape>__<mesh>.json`` with the
reference's keys.  ``memory`` is what one rank holds of the step's inputs
by the plan's placements, and its outputs split evenly; XLA's temp and
code bytes have no counterpart here and read ``"not counted"``.
``lower_s`` is the time to build the cell and ``compile_s`` the time of the
fake-tensor count (nothing is compiled).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional

from ..configs import SHAPES, applicable_shapes, get_config, list_archs
from .shardings import PlanOverrides

__all__ = ["run_cell", "main", "MESHES"]

#: mesh name → its ranks (the port's tiny meshes: (2, 2) and (2, 2, 2))
MESHES = {"pod1": 256, "pod2": 512, "tiny": 4, "tiny2": 8}
NOT_COUNTED = "not counted"


def _mesh(mesh_name: str):
    """The named mesh over a ``fake`` process group of its size (replacing
    any group this process holds)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_production_mesh, make_tiny_mesh

    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name}")
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=MESHES[mesh_name])
    if mesh_name in ("pod1", "pod2"):
        return make_production_mesh(multi_pod=mesh_name == "pod2", device_type="cpu")
    return make_tiny_mesh(multi_pod=mesh_name == "tiny2", device_type="cpu")


def run_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    *,
    overrides: PlanOverrides = PlanOverrides(),
    out_dir: Optional[str] = None,
    verbose: bool = True,
    tag: str = "",
) -> dict:
    import torch.distributed as dist

    from ..perf.cost import count_cell
    from .steps import build_cell

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "step": None,
        "status": "error",
    }
    try:
        mesh = _mesh(mesh_name)
        cell = build_cell(arch, cfg, shape, mesh, overrides=overrides)
        record["step"] = cell.step_name
        t_lower = time.time() - t0
        summary = count_cell(cell, device="cpu")
        t_compile = time.time() - t0 - t_lower
        if verbose:
            print(f"  counted: flops/dev={summary.flops_per_device:.3e} bytes/dev={summary.hbm_bytes_per_device:.3e} "
                  f"parts={summary.parts}")
        out_b = summary.output_bytes
        record.update(
            status="ok",
            chips=cell.chips,
            model_flops_total=cell.model_flops,
            lower_s=round(t_lower, 2),
            compile_s=round(t_compile, 2),
            summary=summary.to_dict(),
            loop_aware=summary.loop_aware(),
            counted_by=summary.counted_by,
            parts=summary.parts,
            memory={
                "argument_bytes": int(summary.argument_bytes),
                "output_bytes": int(out_b),
                "temp_bytes": NOT_COUNTED,
                "alias_bytes": int(summary.alias_bytes),
                "code_bytes": NOT_COUNTED,
                "peak_bytes_est": int(summary.argument_bytes + max(out_b - summary.alias_bytes, 0)),
                "peak_bytes_est_holds": "arguments and new outputs a rank holds; no temps",
            },
        )
    except Exception as e:  # a failing cell is a bug — record it loudly
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=20)
        if verbose:
            print(record["traceback"], file=sys.stderr)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    record["wall_s"] = round(time.time() - t0, 2)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    status = record["status"]
    line = f"[{status:5s}] {arch:26s} {shape_name:12s} {mesh_name:5s} wall={record['wall_s']:7.1f}s"
    if status == "ok":
        gb = record["memory"]["peak_bytes_est"] / 2**30
        line += (f" peak={gb:6.2f}GiB/dev flops/dev={record['loop_aware']['flops']:.2e}"
                 f" coll={record['loop_aware']['collective_wire_bytes']:.2e}B")
    print(line, flush=True)
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES))
    ap.add_argument("--multi-pod", action="store_true", help="alias for --mesh pod2")
    ap.add_argument("--all", action="store_true", help="every applicable cell")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="", help="artifact suffix for perf experiments")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--kv-cache-dtype", default=None)
    ap.add_argument("--decode-loop", default=None, choices=[None, "inplace", "scan"])
    ap.add_argument("--ssd-chunk", type=int, default=None)
    ap.add_argument("--accum-dtype", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()

    overrides = PlanOverrides(
        fsdp=not args.no_fsdp, remat=args.remat, microbatches=args.microbatches,
        kv_cache_dtype=args.kv_cache_dtype, decode_loop=args.decode_loop,
        ssd_chunk=args.ssd_chunk, accum_dtype=args.accum_dtype,
    )

    if args.all:
        meshes = [args.mesh] if args.mesh else ["pod1", "pod2"]
        failures = 0
        for arch in list_archs():
            cfg = get_config(arch)
            for shape_name in applicable_shapes(cfg):
                for mesh_name in meshes:
                    rec = run_cell(
                        arch, shape_name, mesh_name,
                        overrides=overrides, out_dir=args.out,
                        verbose=not args.quiet, tag=args.tag,
                    )
                    failures += rec["status"] != "ok"
        print(f"dry-run sweep complete; failures={failures}")
        sys.exit(1 if failures else 0)

    mesh_name = args.mesh or ("pod2" if args.multi_pod else "pod1")
    rec = run_cell(
        args.arch, args.shape, mesh_name,
        overrides=overrides, out_dir=args.out, verbose=not args.quiet, tag=args.tag,
    )
    sys.exit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
