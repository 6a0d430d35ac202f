"""The port's card lock (``maxstyle_tpu_torch/utils/gpulock.py``), with the
cases of tests/test_tpulock.py, and the CUDA probe
(``maxstyle_tpu_torch/utils/backend.py``), which raises where the JAX
package's probe would fall back."""

import json
import os
import subprocess
import sys
import time

import pytest

from maxstyle_tpu_torch.utils import backend, gpulock
from maxstyle_tpu_torch.utils.gpulock import chip_lock, lock_holder, yield_to_bench


@pytest.fixture(autouse=True)
def _isolated_lock(tmp_path, monkeypatch):
    monkeypatch.setattr(gpulock, "LOCK_PATH", str(tmp_path / "chip.lock"))
    monkeypatch.setattr(gpulock, "BENCH_FLAG", str(tmp_path / "bench.flag"))


class TestChipLock:
    def test_uncontended_acquire(self):
        with chip_lock("t") as info:
            assert info == {"waited_s": 0.0, "contended": False,
                            "acquired": True}
            assert lock_holder()["tag"] == "t"

    def test_release_allows_reacquire(self):
        with chip_lock("a"):
            pass
        with chip_lock("b", timeout_s=1) as info:
            assert info["acquired"] and not info["contended"]

    def test_contended_times_out_but_still_runs(self):
        """An advisory lock must never turn a measurement into a
        no-result: on timeout the block runs with acquired=False."""
        code = (
            "import sys, json; sys.path.insert(0, %r)\n"
            "from maxstyle_tpu_torch.utils import gpulock\n"
            "gpulock.LOCK_PATH = %r\n"
            "from maxstyle_tpu_torch.utils.gpulock import chip_lock\n"
            "with chip_lock('inner', timeout_s=1.5, poll_s=0.2) as i:\n"
            "    print(json.dumps(i))\n"
        ) % (os.getcwd(), gpulock.LOCK_PATH)
        with chip_lock("outer"):
            r = subprocess.run([sys.executable, "-c", code],
                               capture_output=True, text=True, timeout=60)
        info = json.loads(r.stdout)
        assert info["contended"] and not info["acquired"]
        assert info["waited_s"] >= 1.5

    def test_cross_process_serialization(self):
        """Second process acquires only after the first releases."""
        code = (
            "import sys, json, time; sys.path.insert(0, %r)\n"
            "from maxstyle_tpu_torch.utils import gpulock\n"
            "gpulock.LOCK_PATH = %r\n"
            "from maxstyle_tpu_torch.utils.gpulock import chip_lock\n"
            "with chip_lock('inner', timeout_s=30, poll_s=0.1) as i:\n"
            "    print(json.dumps({**i, 't_acquired': time.time()}))\n"
        ) % (os.getcwd(), gpulock.LOCK_PATH)
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE, text=True)
        try:
            with chip_lock("holder"):
                # hold long enough that the child (however slow its
                # interpreter start) is blocked in its wait loop
                time.sleep(2.5)
                t_release = time.time()
            out, _ = proc.communicate(timeout=60)
        finally:
            proc.kill()
        info = json.loads(out)
        assert info["acquired"]
        # the child could not have held the lock before we released it
        assert info["t_acquired"] >= t_release - 0.05

    def test_holder_info_cleared_on_release(self):
        with chip_lock("t"):
            pass
        assert lock_holder() in (None, {})


class TestBenchPriority:
    def test_bench_flag_raised_while_waiting_and_cleaned(self):
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "from maxstyle_tpu_torch.utils import gpulock\n"
            "gpulock.LOCK_PATH = %r\n"
            "gpulock.BENCH_FLAG = %r\n"
            "from maxstyle_tpu_torch.utils.gpulock import chip_lock\n"
            "with chip_lock('bench', timeout_s=1.5, poll_s=0.2,\n"
            "               bench_priority=True):\n"
            "    pass\n"
        ) % (os.getcwd(), gpulock.LOCK_PATH, gpulock.BENCH_FLAG)
        with chip_lock("sweep"):
            proc = subprocess.Popen([sys.executable, "-c", code])
            deadline = time.time() + 30
            while (not os.path.exists(gpulock.BENCH_FLAG)
                   and time.time() < deadline):
                time.sleep(0.05)
            assert os.path.exists(gpulock.BENCH_FLAG), \
                "waiting bench must raise its flag"
            proc.wait(timeout=60)
        assert not os.path.exists(gpulock.BENCH_FLAG), \
            "flag must be removed when bench exits"

    def test_yield_to_bench_waits_for_flag(self):
        with open(gpulock.BENCH_FLAG, "w") as f:
            f.write("{}")
        t0 = time.monotonic()
        waited = yield_to_bench(max_wait_s=0.6, poll_s=0.1)
        assert waited >= 0.5
        assert time.monotonic() - t0 >= 0.5

    def test_yield_no_flag_returns_immediately(self):
        assert yield_to_bench() == 0.0


class TestDefaultPaths:
    def test_lock_and_flag_default_under_the_checkout(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = ("import sys; sys.path.insert(0, %r)\n"
                "from maxstyle_tpu_torch.utils import gpulock\n"
                "print(gpulock.LOCK_PATH); print(gpulock.BENCH_FLAG)\n") % root
        env = {k: v for k, v in os.environ.items()
               if k not in ("MAXSTYLE_GPU_LOCK", "MAXSTYLE_GPU_BENCH_FLAG")}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=60).stdout.split()
        assert out == [os.path.join(root, "build", "gpu_chip.lock"),
                       os.path.join(root, "build", "gpu_bench_waiting")]


class TestCudaProbe:
    def test_probe_raises_without_a_device(self):
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        with pytest.raises(RuntimeError, match="CUDA probe failed"):
            backend.probe_cuda(timeout_s=120, env=env)

    def test_probe_raises_on_a_hang(self, tmp_path):
        hang = tmp_path / "python"
        hang.write_text("#!/bin/sh\nsleep 30\n")
        hang.chmod(0o755)
        with pytest.raises(RuntimeError, match="still running after 1 s"):
            backend.probe_cuda(timeout_s=1, python=str(hang))

    def test_probe_reports_the_card(self, tmp_path):
        fake = tmp_path / "python"
        fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3; 1'\n")
        fake.chmod(0o755)
        assert backend.probe_cuda(python=str(fake)) == "NVIDIA H100 80GB HBM3; 1"
