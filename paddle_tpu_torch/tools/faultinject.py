"""faultinject: kill a real training run and prove it always recovers (the
port of the reference's ``tools/faultinject.py``).

A training worker (``paddle_tpu_torch.tools.elastic_ckpt_worker``) is
SIGKILLed at randomised points in three phases:

  mid-step     right after a step completes (a small random delay puts the
               kill anywhere inside the next step's work)
  mid-save     inside the staged checkpoint write (the worker runs with
               PADDLE_CKPT_TEST_SLEEP_S, so the checkpoint layer prints a
               CKPT_WRITE marker and sleeps: the kill lands mid-.npy)
  mid-commit   just before the atomic manifest-commit rename (CKPT_COMMIT)

each kill armed once a checkpoint is committed (the attempt resumed from
one, or its worker printed SAVED), and relaunched each time; then it is
sent one SIGTERM in the middle of its second step (the worker pauses
there, after the step's batch is drawn and its update dispatched: the
preemption path, a final save at the next step boundary within
FLAGS_ckpt_preempt_deadline_s, then death by the signal), and relaunched
until the run completes. The drill then checks:

  1. every relaunch resumed from a committed checkpoint (never a torn
     one: restore_latest quarantines corrupt directories, and never
     fresh) and no resume went backwards;
  2. every executed step's loss is bitwise the uninterrupted reference
     run's (parameters, optimizer state, the LR schedule and both RNG
     streams restored exactly), and every step was executed;
  3. the final state digest equals the reference run's;
  4. steps lost per kill stay within the cadence's bound (the interval
     with synchronous saves, twice it with async saves, where one save can
     still be in flight);
  5. the SIGTERM'd worker died of the signal after committing its final
     save of the step the signal landed in, and its relaunch resumed
     there and lost no step;
  6. with ``--expect-launches F,DQ,DKV``, each worker that completed
     launched the flash forward, dq and dk/dv kernels that many times a
     step of its own, and ran their plain versions 0 times.

It prints a JSON record (kills survived, steps lost per kill, median
restore ms, spawn-to-first-step seconds, each process's start-up split
and compile-cache counts, the SIGTERM's final save) to stdout and
``--out``. Every worker inherits the environment, so a
``FLAGS_compile_cache_dir`` set there gives them one compile cache and a
relaunch's first step loads its record. The reference run goes beside the fault run, in a process of its own.
The workers run on the GPU unless ``--cpu`` is given; without a GPU every
worker fails and so does the drill.

Usage::

  python -m paddle_tpu_torch.tools.faultinject --cpu --model mlp
  python -m paddle_tpu_torch.tools.faultinject --model gpt --layers 4 \\
      --steps 12 --interval 3 --keep 2 --expect-launches 8,4,4
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "paddle_tpu_torch.tools.elastic_ckpt_worker"

PHASES = ("mid-step", "mid-save", "mid-commit")


class DrillFailure(AssertionError):
    """A check of the drill failed (a gate, not an ``assert``: it holds
    under ``python -O`` too)."""


def _require(cond, msg):
    if not cond:
        raise DrillFailure(msg)


def _worker_env(phase, mode, sleep_s, midstep_sleep):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["ELASTIC_WORKER_BLOCK"] = "1" if mode == "block" else "0"
    if phase in ("mid-save", "mid-commit"):
        # widen the write and commit windows so the kill lands in the
        # targeted phase; a marker is printed at each
        env["PADDLE_CKPT_TEST_SLEEP_S"] = str(sleep_s)
    else:
        env.pop("PADDLE_CKPT_TEST_SLEEP_S", None)
    if phase == "sigterm":
        env["ELASTIC_WORKER_MIDSTEP_SLEEP"] = str(midstep_sleep)
    else:
        env.pop("ELASTIC_WORKER_MIDSTEP_SLEEP", None)
    return env


def _read_loss_log(path):
    """step -> set of float32-hex records (tolerates a torn last line)."""
    records = {}
    if not os.path.exists(path):
        return records
    with open(path, "rb") as f:
        data = f.read()
    for line in data.split(b"\n"):
        parts = line.decode("utf-8", "replace").split()
        if len(parts) != 2 or len(parts[1]) != 8:
            continue
        try:
            step = int(parts[0])
        except ValueError:
            continue
        records.setdefault(step, set()).add(parts[1])
    return records


def _kv(line):
    return dict(p.split("=", 1) for p in line.split()[1:] if "=" in p)


def run_attempt(ckpt_dir, cfg, phase, rng, timeout_s, live=None):
    """One worker launch; ``phase`` None runs it to completion, a kill
    phase SIGKILLs it there, "sigterm" sends SIGTERM when a step pauses
    after its update (the worker's MIDSTEP line). ``live`` (a list) gets
    the process, so a caller that fails elsewhere can kill it. Returns
    what happened."""
    cmd = [sys.executable, "-u", "-m", WORKER, ckpt_dir, str(cfg["steps"]),
           str(cfg["interval"]), "--model", cfg["model"], "--layers",
           str(cfg["layers"]), "--keep", str(cfg["keep"])]
    if cfg["cpu"]:
        cmd.append("--cpu")
    t_spawn = time.perf_counter()
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True,
        env=_worker_env(phase, cfg["mode"], cfg["sleep_s"],
                        cfg["midstep_sleep"]))
    if live is not None:
        live.append(proc)
    # a worker that hangs silently is killed at the bound
    watchdog = threading.Timer(timeout_s, proc.kill)
    watchdog.start()
    info = {"phase": phase, "killed": False, "fresh": False,
            "resumed_from": None, "restore_ms": None, "steps_lost": None,
            "last_step_seen": 0, "done": False, "digest": None,
            "first_step_s": None, "returncode": None, "preempted": None,
            "signal_in_step": None, "startup": None,
            "saved": []}
    steps, interval = cfg["steps"], cfg["interval"]
    # arm points stay clear of the run's end, so a later interruption
    # still finds steps to run
    arm_hi = max(1, steps - 2 * interval)
    kill_at_step = kill_marker = None
    marker_skip = arm_at = 0
    if phase == "mid-step":
        kill_at_step = rng.randint(1, arm_hi)
    elif phase in ("mid-save", "mid-commit"):
        kill_marker = "CKPT_WRITE" if phase == "mid-save" else "CKPT_COMMIT"
        # skip a random number of write markers so kills land on
        # different files
        marker_skip = rng.randint(0, 3) if phase == "mid-save" else 0
        arm_at = rng.randint(1, arm_hi)
    try:
        for line in proc.stdout:
            line = line.strip()
            if line == "FRESH":
                info["fresh"] = True
            elif line.startswith("RESUMED"):
                kv = _kv(line)
                info["resumed_from"] = int(kv["step"])
                info["restore_ms"] = float(kv["restore_ms"])
                info["steps_lost"] = int(kv["steps_lost"])
                lo = info["resumed_from"] + 1
                if phase == "mid-step":
                    kill_at_step = rng.randint(lo, max(lo, arm_hi))
                elif kill_marker is not None:
                    arm_at = rng.randint(lo, max(lo, arm_hi))
            elif line.startswith("SAVED "):
                info["saved"].append(int(line.split()[1]))
            elif line.startswith("STARTUP "):
                try:
                    info["startup"] = json.loads(line[len("STARTUP "):])
                except ValueError:
                    pass    # torn by a kill landing mid-write
            elif line.startswith("STEP "):
                try:
                    info["last_step_seen"] = int(line.split()[1])
                except (ValueError, IndexError):
                    continue  # torn line from a kill landing mid-write
                if info["first_step_s"] is None:
                    info["first_step_s"] = time.perf_counter() - t_spawn
                if not (info["saved"] or info["resumed_from"]):
                    continue  # no committed checkpoint yet: not armed
                if kill_at_step is not None and \
                        info["last_step_seen"] >= kill_at_step:
                    time.sleep(rng.uniform(0, 0.02))  # land inside work
                    proc.send_signal(signal.SIGKILL)
                    info["killed"] = True
                    break
            elif line.startswith("MIDSTEP ") and phase == "sigterm" and \
                    not info["killed"] and (info["saved"]
                                            or info["resumed_from"]):
                k = int(line.split()[1])
                if k < (info["resumed_from"] or 0) + 2:
                    continue  # a step of this process's must come first
                # the worker pauses after this step's update: the signal
                # lands mid-step
                info["signal_in_step"] = k
                proc.send_signal(signal.SIGTERM)
                info["killed"] = True
            elif kill_marker is not None and line.startswith(kill_marker):
                if info["last_step_seen"] < arm_at or not (
                        info["saved"] or info["resumed_from"]):
                    continue
                if marker_skip > 0:
                    marker_skip -= 1
                    continue
                proc.send_signal(signal.SIGKILL)
                info["killed"] = True
                break
            elif line.startswith("PREEMPTED"):
                kv = _kv(line)
                info["preempted"] = {
                    "step": int(kv["step"]),
                    "boundary_wait_s": float(kv["boundary_wait_s"]),
                    "final_save_s": float(kv["final_save_s"]),
                    "committed": kv["committed"] == "1"}
            elif line.startswith("DONE"):
                kv = _kv(line)
                info["done"] = True
                info["digest"] = kv["digest"]
                info["steps_run"] = int(kv["steps"])
                info["launches"] = [int(x) for x in
                                    kv["launches"].split(",")]
                info["plain"] = [int(x) for x in kv["plain"].split(",")]
    finally:
        try:
            proc.stdout.close()
        except OSError:
            pass
        proc.wait()
        timed_out = not watchdog.is_alive()
        watchdog.cancel()
        err.seek(0)
        info["stderr_tail"] = err.read()[-2000:]
        err.close()
    info["returncode"] = proc.returncode
    if timed_out:
        raise AssertionError(f"worker ({phase}) ran past {timeout_s} s: "
                             f"{info['stderr_tail']}")
    if not info["killed"] and not info["done"]:
        raise AssertionError(
            f"worker ({phase}) exited {proc.returncode} without finishing:"
            f" {info['stderr_tail']}")
    return info


def _check_counts(info, expect):
    if expect is None:
        return
    want = [n * info["steps_run"] for n in expect]
    _require(info["launches"] == want,
             f"flash launches {info['launches']} over {info['steps_run']} "
             f"steps, expected {expect} a step")
    _require(info["plain"] == [0, 0, 0],
             f"the flash kernels' plain versions ran {info['plain']} times")


def run(steps=30, interval=2, kills=3, mode="async", seed=0, sleep_s=0.15,
        midstep_sleep=0.5, model="mlp", layers=4, keep=3,
        cpu=False, expect_launches=None, root=None, timeout_s=600.0,
        out=None, verbose=True):
    rng = random.Random(seed)
    t_start = time.time()
    cfg = {"steps": steps, "interval": interval, "mode": mode,
           "sleep_s": sleep_s, "midstep_sleep": midstep_sleep,
           "model": model,
           "layers": layers, "keep": keep, "cpu": cpu}
    root = tempfile.mkdtemp(prefix="faultinject-", dir=root)
    live, ref_thread = [], None
    try:
        # 1. reference: an uninterrupted run, in its own process beside
        # the fault run's (the two share nothing but the device)
        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir)
        ref_out = {}

        def reference():
            try:
                ref_out["info"] = run_attempt(ref_dir, cfg, None,
                                              random.Random(seed), timeout_s,
                                              live)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                ref_out["error"] = e
        ref_thread = threading.Thread(target=reference, daemon=True)
        ref_thread.start()

        # 2. the fault run: kill and relaunch, SIGTERM once, run to the end
        dir_ = os.path.join(root, "faults")
        os.makedirs(dir_)
        plan = [PHASES[i % len(PHASES)] for i in range(kills)]
        rng.shuffle(plan)
        plan.append("sigterm")
        log, attempts, max_resumed = [], [], 0
        while True:
            phase = plan[len(log)] if len(log) < len(plan) else None
            info = run_attempt(dir_, cfg, phase, rng, timeout_s)
            attempts.append(info)
            if len(attempts) > 1:
                # every interruption came after a commit: a relaunch
                # resumes from a committed checkpoint
                _require(info["resumed_from"] is not None,
                         f"attempt {len(attempts)} did not resume")
                _require(info["resumed_from"] >= max_resumed,
                         f"resume went backwards: {info['resumed_from']} < "
                         f"{max_resumed} (a committed checkpoint was lost)")
                max_resumed = info["resumed_from"]
            if info["killed"]:
                log.append(info)
                if verbose:
                    print(f"  {info['phase']} at step "
                          f"{info['last_step_seen']}", file=sys.stderr)
                continue
            _require(phase is None,
                     f"the worker finished before its {phase} interruption")
            final = info
            break
        _check_counts(final, expect_launches)
        ref_thread.join()
        if "error" in ref_out:
            raise ref_out["error"]
        ref = ref_out["info"]
        _check_counts(ref, expect_launches)
        ref_losses = _read_loss_log(os.path.join(ref_dir, "loss_log.txt"))
        _require(len(ref_losses) == steps
                 and all(len(v) == 1 for v in ref_losses.values()),
                 "the reference run must log exactly one loss per step")

        # 3. the checks
        bound = interval if mode == "block" else 2 * interval
        resumes = attempts[1:]      # every one resumed (checked above)
        # the relaunches after a SIGKILL (the SIGTERM's is reported apart)
        lost = [b["steps_lost"] for a, b in zip(attempts, attempts[1:])
                if a["phase"] in PHASES]
        for a in resumes:
            _require(a["steps_lost"] <= bound,
                     f"lost {a['steps_lost']} steps, bound is {bound} ({mode})")
        i = next(i for i, a in enumerate(attempts)
                 if a["phase"] == "sigterm")
        a, after = attempts[i], attempts[i + 1]
        _require(a["returncode"] == -signal.SIGTERM,
                 f"the SIGTERM'd worker exited {a['returncode']}, not by "
                 f"the signal: {a['stderr_tail']}")
        _require(a["preempted"] and a["preempted"]["committed"],
                 "the SIGTERM'd worker's final save did not commit in time")
        saved_at = a["preempted"]["step"]
        in_step = a["signal_in_step"]
        _require(saved_at == in_step,
                 f"the final save holds step {saved_at}; the signal came "
                 f"during step {in_step}")
        _require(after["resumed_from"] == saved_at
                 and after["steps_lost"] == 0,
                 f"the relaunch after SIGTERM resumed at "
                 f"{after['resumed_from']} losing {after['steps_lost']} "
                 f"steps; the final save held step {saved_at}")
        term = {"signal_in_step": in_step,
                "saved_step": saved_at,
                "exit_status": a["returncode"],
                "boundary_wait_s": a["preempted"]["boundary_wait_s"],
                "final_save_s": a["preempted"]["final_save_s"],
                "relaunch_steps_lost": after["steps_lost"]}
        losses = _read_loss_log(os.path.join(dir_, "loss_log.txt"))
        mismatches = [(s, sorted(r), sorted(ref_losses.get(s, ())))
                      for s, r in losses.items() if r != ref_losses.get(s)]
        _require(not mismatches,
                 f"loss trajectory diverged from the reference at: "
                 f"{mismatches[:5]}")
        _require(set(losses) == set(ref_losses),
                 "not every step was executed")
        _require(final["digest"] == ref["digest"],
                 f"final state digest {final['digest'][:12]} != reference "
                 f"{ref['digest'][:12]}")
        restore_ms = sorted(a["restore_ms"] for a in resumes)
        first = [a["first_step_s"] for a in [ref] + attempts
                 if a["first_step_s"] is not None]
        kills_done = [a for a in log if a["phase"] != "sigterm"]
        record = {
            "bench": "faultinject", "schema": 1, "mode": mode,
            "model": model, "layers": layers if model == "gpt" else None,
            "device": "cpu" if cpu else "cuda",
            "steps": steps, "save_interval": interval, "keep": keep,
            "kills_requested": kills, "kills_survived": len(kills_done),
            "attempts": len(attempts),
            "phases": sorted({a["phase"] for a in kills_done}),
            "steps_lost_per_kill": lost, "steps_lost_bound": bound,
            "median_restore_ms": statistics.median(restore_ms)
            if restore_ms else None,
            "spawn_to_first_step_s": first,
            "median_spawn_to_first_step_s": statistics.median(first)
            if first else None,
            # each process's start-up split and compile-cache counts:
            # the reference, then the fault run's attempts in order
            "startup": [dict(a["startup"] or {}, attempt=i,
                             resumed=a["resumed_from"] is not None)
                        for i, a in enumerate([ref] + attempts)],
            "sigterm": term,
            "worker_launches": {"reference": ref["launches"],
                                "final": final["launches"],
                                "final_steps": final["steps_run"]},
            "trajectory_bitwise_equal": True, "final_digest_equal": True,
            "elapsed_s": round(time.time() - t_start, 3),
            "kills": [{"phase": a["phase"], "at_step": a["last_step_seen"]}
                      for a in kills_done],
        }
    finally:
        for proc in live:       # the reference, when the fault run failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if ref_thread is not None:
            ref_thread.join()
        shutil.rmtree(root, ignore_errors=True)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--interval", type=int, default=2,
                    help="save every N steps")
    ap.add_argument("--kills", type=int, default=3,
                    help="SIGKILLs, cycling through the three phases")
    ap.add_argument("--mode", choices=("async", "block"), default="async")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sleep-s", type=float, default=0.15,
                    help="save/commit window width for targeted kills")
    ap.add_argument("--midstep-sleep", type=float, default=0.5,
                    help="the SIGTERM'd worker's pause inside each step")
    ap.add_argument("--model", choices=("mlp", "gpt"), default="mlp")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the workers on the CPU (default: the GPU)")
    ap.add_argument("--expect-launches", default=None, metavar="F,DQ,DKV",
                    help="flash launches a step each completed worker "
                         "must show (and 0 plain calls)")
    ap.add_argument("--dir", default=None,
                    help="where the checkpoint directories go (default: "
                         "the temporary directory)")
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="bound on one worker launch")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)
    expect = [int(x) for x in args.expect_launches.split(",")] \
        if args.expect_launches else None
    record = run(steps=args.steps, interval=args.interval, kills=args.kills,
                 mode=args.mode, seed=args.seed, sleep_s=args.sleep_s,
                 midstep_sleep=args.midstep_sleep,
                 model=args.model, layers=args.layers, keep=args.keep,
                 cpu=args.cpu, expect_launches=expect, root=args.dir,
                 timeout_s=args.timeout_s, out=args.out)
    print(json.dumps(record, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
