"""The port's elastic drill on the CPU: ``paddle_tpu_torch.tools.
faultinject`` over ``elastic_ckpt_worker --cpu --model mlp``, one SIGKILL in
each phase (mid-step, mid-save, mid-commit) and one SIGTERM in the middle
of a step. Every executed step's loss is bitwise the uninterrupted run's,
the final digests are equal, steps lost stay within the async bound, and
the SIGTERM'd worker commits its final save of the step the signal landed
in and dies of the signal. Each worker launch is bounded
(``timeout_s``)."""
import os
import subprocess
import sys

from paddle_tpu_torch.tools import faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kills_in_every_phase_and_a_sigterm_resume_bitwise(tmp_path):
    rec = faultinject.run(steps=8, interval=2, kills=3, sleep_s=0.05,
                          midstep_sleep=0.3, model="mlp", cpu=True,
                          expect_launches=[0, 0, 0], root=str(tmp_path),
                          timeout_s=120.0, verbose=False)
    assert rec["trajectory_bitwise_equal"] and rec["final_digest_equal"]
    assert rec["kills_survived"] == 3
    assert rec["phases"] == ["mid-commit", "mid-save", "mid-step"]
    assert rec["steps_lost_bound"] == 4
    assert len(rec["steps_lost_per_kill"]) == 3
    assert all(n <= 4 for n in rec["steps_lost_per_kill"])
    term = rec["sigterm"]
    assert term["exit_status"] == -15 and term["relaunch_steps_lost"] == 0
    assert term["saved_step"] == term["signal_in_step"]
    assert term["final_save_s"] >= 0 and term["boundary_wait_s"] >= 0
    assert rec["attempts"] == 5 and rec["device"] == "cpu"
    # each process's start-up split, from its STARTUP line (every attempt
    # ran a first step before its interruption); no compile cache here
    starts = rec["startup"]
    assert [s["resumed"] for s in starts] == [False, False] + [True] * 4
    for s in starts:
        assert {"imports", "cuda_context", "kernel_library", "model",
                "restore", "first_step"} <= set(s)
        assert s["compile_cache"] is None and s["imports"] > 0
        assert s["cuda_context"] == s["kernel_library"] == 0.0
    assert os.listdir(str(tmp_path)) == []    # the drill cleans up


def test_worker_without_a_gpu_or_cpu_flag_fails_with_the_device_error(
        tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_ckpt_worker",
         str(tmp_path), "2", "1"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "STEP" not in proc.stdout
