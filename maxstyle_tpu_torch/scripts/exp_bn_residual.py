"""What the BatchNorm running-statistics update costs a training step.

    python -m maxstyle_tpu_torch.scripts.exp_bn_residual [--repeats 3]
        [--modes fused,torch,biased,off] [--device cpu]

Counterpart of ``scripts/exp_bn_residual.py``. Three arms on the headline
workload (``flagship.flagship_solver``, timed by
``flagship.measure_throughput`` with K=4 and rounds of 2 calls), in one
process, varying only ``models.layers._BN_UPDATE_MODE``:

  torch   — the shipped semantics: the Bessel-corrected running update;
  biased  — the running update without the n/(n-1) factor;
  off     — no running update at all.

Every arm takes the same explicit route (the batch moments, the update by
torch ops, a statistics-free cuDNN batch norm), so the arms differ only in
the update. The shipped route, where cuDNN's batch norm updates the
statistics itself, runs as a fourth arm, ``fused`` (``--modes`` takes it
too): its difference from "torch" prices the explicit route, not the
update. Prints one line an arm: ``bn_update=<mode>: <steps/s> steps/s``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--modes", type=str, default="fused,torch,biased,off")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = ap.parse_args(argv)

    from maxstyle_tpu_torch.flagship import flagship_solver, measure_throughput
    from maxstyle_tpu_torch.models import layers
    from maxstyle_tpu_torch.solver import resolve_device
    from maxstyle_tpu_torch.utils.gpulock import chip_lock, yield_to_bench

    dev = resolve_device(opt.device)
    print(f"devices: {dev}", flush=True)
    yield_to_bench()
    try:
        with chip_lock("exp_bn_residual"):
            for mode in opt.modes.split(","):
                layers._BN_UPDATE_MODE = None if mode == "fused" else mode
                solver = flagship_solver(hw=192, batch=20, device=dev)
                rate, _, _ = measure_throughput(solver, k_inner=4, n_calls=2,
                                                n_repeats=opt.repeats)
                print(f"bn_update={mode}: {rate:.3f} steps/s", flush=True)
    finally:
        layers._BN_UPDATE_MODE = None


if __name__ == "__main__":
    main()
