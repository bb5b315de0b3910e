"""The port's bench entry point, ``python -m paddle_tpu_torch.bench``,
against the repo's ``bench.py`` on the CPU: the same flags (read from
``bench.py``'s source, which is not imported: it reaches ``paddle_tpu`` and
``tools/``), the same config table (metric names, batch, sequence length,
model presets and the stacked/recompute/moment settings), ``--smoke``'s one
JSON line with ``bench.py``'s keys and an agreeing cost check, and a
non-zero exit without a CUDA device."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from paddle_tpu.models import gpt2_large as j_gpt2_large
from paddle_tpu.models import gpt2_medium as j_gpt2_medium
from paddle_tpu.models import gpt2_small as j_gpt2_small
from paddle_tpu.models import gpt3_1p3b as j_gpt3_1p3b
from paddle_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
RECORD_KEYS = {"metric", "skipped", "value", "unit", "vs_baseline"}


def _bench_py_flags():
    tree = ast.parse((ROOT / "bench.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"}


def _run(*argv, env_extra=None, timeout=300):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch.bench",
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_flags_are_bench_py_flags():
    ours = {a for act in bench.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    assert _bench_py_flags() <= ours


# bench.py's table (bench.py:290-339): config, --seq, metric, batch, seq,
# the reference preset, stacked, moments
TABLE = [
    ("small", 0, "gpt2s_train_tokens_per_sec", 8, 512, j_gpt2_small, False,
     "float32"),
    ("medium", 0, "gpt2m_train_tokens_per_sec", 16, 512, j_gpt2_medium,
     False, "float32"),
    ("large", 0, "gpt2l_train_tokens_per_sec", 8, 1024, j_gpt2_large, True,
     "bfloat16"),
    ("1.3b", 0, "gpt3_1p3b_train_tokens_per_sec", 2, 2048, j_gpt3_1p3b,
     True, "bfloat16"),
    ("1.3b", 8192, "gpt3_1p3b_s8192_train_tokens_per_sec", 2, 8192,
     j_gpt3_1p3b, True, "bfloat16"),
    ("medium", 4096, "gpt2m_s4096_train_tokens_per_sec", 16, 4096,
     j_gpt2_medium, True, "bfloat16"),
    ("small", 1024, "gpt2s_s1024_train_tokens_per_sec", 8, 1024,
     j_gpt2_small, False, "float32"),
]


@pytest.mark.parametrize("row", TABLE, ids=lambda r: f"{r[0]}-s{r[1]}")
def test_gpt_config_table_matches_bench_py(row):
    config, seq_flag, metric, batch, seq, preset, stacked, moments = row
    args = bench.build_parser().parse_args(
        ["--config", config] + (["--seq", str(seq_flag)] if seq_flag
                                else []))
    s = bench.gpt_setup(args)
    assert (s["metric"], s["batch"], s["seq"], s["moment_dtype"]) == (
        metric, batch, seq, moments)
    cfg, ref = s["cfg"], preset()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.max_seq_len == (seq if seq_flag or config in ("small",
                                                             "medium")
                               else ref.max_seq_len)
    assert cfg.stacked == stacked
    if stacked:
        assert cfg.recompute == "full"


def test_overrides_follow_bench_py():
    args = bench.build_parser().parse_args(
        ["--config", "large", "--recompute", "dots", "--batch", "4",
         "--moment-dtype", "float32", "--input-pipeline"])
    s = bench.gpt_setup(args)
    assert s["cfg"].recompute == "dots" and s["batch"] == 4
    assert s["moment_dtype"] == "float32"
    assert s["metric"] == "gpt2l_train_tokens_per_sec_pipelined"


def test_smoke_prints_one_record_whose_cost_check_agrees():
    proc = _run("--smoke", "--steps", "2", "--windows", "1")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert RECORD_KEYS <= set(rec)
    assert rec["metric"] == "gpt_tiny_smoke_tokens_per_sec"
    assert rec["unit"] == "tokens/s" and rec["skipped"] is False
    assert rec["value"] > 0 and rec["device"] == "cpu"
    cost = rec["cost_model"]
    assert cost["available"] and cost["agrees"], cost
    assert cost["kernel_flops_per_token"] == 0     # the plain versions ran


@pytest.mark.parametrize("config", ["small", "bert", "resnet50"])
def test_without_a_gpu_the_bench_fails(config):
    proc = _run("--config", config, "--steps", "1", "--windows", "1",
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("config", ["bert", "resnet50"])
def test_smoke_takes_gpt_only(config):
    proc = _run("--smoke", "--config", config)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "gpt_tiny" in proc.stderr


@pytest.mark.parametrize("config", ["small", "bert", "resnet50"])
@pytest.mark.parametrize("no_amp", [True, False], ids=["no_amp", "amp"])
def test_no_amp_turns_tf32_off_on_the_card(monkeypatch, config, no_amp):
    """``--no-amp`` on a CUDA device runs with TF32 off for matmuls and
    cuDNN (float32 throughout, as chip_smoke.py's float32 checks run), and
    gives the flags back as they were; with AMP they are left alone."""
    import torch
    seen = []
    runner = {"resnet50": "run_resnet", "bert": "run_bert"}.get(config,
                                                                "run_gpt")
    monkeypatch.setattr(bench, "_device", lambda args: torch.device("cuda"))
    monkeypatch.setattr(bench, runner, lambda args, dev: seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    argv = ["--config", config] + (["--no-amp"] if no_amp else [])
    bench.run(bench.build_parser().parse_args(argv))
    assert seen == [(False, False) if no_amp else (True, True)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
