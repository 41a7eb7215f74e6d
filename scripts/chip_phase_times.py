"""Run a checkout's ``chip_smoke.py`` with each of its phase functions timed.

    python3 scripts/chip_phase_times.py CHECKOUT TAG OUT_DIR

imports ``CHECKOUT/chip_smoke.py``, wraps the functions its ``main()``
calls for each phase (and a few they call) with a timer, and runs
``main()`` from ``CHECKOUT``: its output goes to ``OUT_DIR/TAG.log``,
one JSON line ``{"phase_time": name, "seconds": s}`` a timed call (nested
calls each get theirs) to ``OUT_DIR/TAG.times``, the last one
``{"phase_time": "all", ...}`` with ``main()``'s exit code.  Run two
checkouts in one card call to compare their phases on the same host
(the replay-bound phases follow the host's speed).
"""
import functools
import json
import os
import sys
import time

NAMES = """setup launch_configs check_kernels check_bsr_layout check_quantized_kernel check_chain_grid check_dgrad_grid
check_wgrad_grid check_backward_kernels main_path quantized_path check_k4_rounding measured_dispatch training_path
train_lm train_resilient ef_run preempt_resume recompress_run calibration factorize_batched strategies compose
grad_dispatch measure measure_quantized measure_backward measure_unembed serve serve_run serve_stream compressed_mlp
archs arch_train arch_serve moe_decode ssm_archs ssm_serving modality mesh mesh_operator mesh_head mesh_serve
mesh_nccl mesh_serve_1x1 mesh_train mesh_train_nccl report tensor_parallel tensor_parallel_ssm moe_split""".split()


def timed(name, fn, times):
    @functools.wraps(fn)
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            times.write(json.dumps({"phase_time": name, "seconds": time.perf_counter() - t0}) + "\n")
            times.flush()
    return run


def main() -> int:
    checkout, tag, out_dir = os.path.abspath(sys.argv[1]), sys.argv[2], os.path.abspath(sys.argv[3])
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import chip_smoke as cs

    times = open(os.path.join(out_dir, f"{tag}.times"), "w")
    for n in NAMES:
        if hasattr(cs, n):
            setattr(cs, n, timed(n, getattr(cs, n), times))
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{tag}.log"), "w") as log:
        sys.stdout = log
        try:
            rc = cs.main()
        except BaseException:  # noqa: BLE001 — its traceback goes to the log
            import traceback

            traceback.print_exc(file=log)
            rc = 1
        sys.stdout = sys.__stdout__
    times.write(json.dumps({"phase_time": "all", "seconds": time.perf_counter() - t0, "rc": rc}) + "\n")
    times.close()
    print(tag, "rc", rc, "seconds", round(time.perf_counter() - t0, 1))
    return rc


if __name__ == "__main__":  # the phases spawn ranks, which import this module again
    sys.exit(main())
