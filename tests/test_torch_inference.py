"""The port's model export and inference (``jit.save``/``jit.load``,
``inference.Config``/``Predictor``) against ``paddle_tpu``'s on the CPU.

The same weights (carried from the JAX model by ``convert.py``) and the same
seeded numpy inputs go through the reference's ``jit.save`` →
``Predictor.run`` and the port's ``jit.save`` → ``jit.load`` /
``Predictor.run``, in this process and in a fresh one. Tolerances: the MLP
fixture of ``tests/test_serving.py`` in float32 at rtol 1e-5, atol 1e-6 (as
``tests/test_serving.py``); ``ernie_tiny``'s classifier logits at atol 1e-5
(the two packages' attention sums in another order: the port's plain flash
version against the reference's dense path); the port's loaded program
against its own eager model bit for bit, which runs the same operators;
a model decorated to bf16 in both packages at atol 3e-2, with the port's
distance from the float32 logits at most 1.5x the reference's.
"""
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu.models.ernie import ErnieForSequenceClassification as JCls
from paddle_tpu.models.ernie import ernie_tiny as j_ernie_tiny
from paddle_tpu_torch import amp, convert, inference, jit
from paddle_tpu_torch.framework import exporting
from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                     ernie_tiny)
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops.flash_attention import (OP_NAME,
                                                  flash_attention_fwd_op)
from paddle_tpu_torch.static import InputSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6
ERNIE_ATOL = 1e-5
BF16_ATOL, BF16_FLOOR_FACTOR = 3e-2, 1.5


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def mlp_pair():
    """The reference's serving fixture (``tests/test_serving.py:24-33``) and
    the port's same MLP with its weights."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(),
                        jnn.Linear(16, 4)).eval()
    pm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                             torch.nn.Linear(16, 4)).eval()
    return jm, convert.load_jax_state(pm, _arrays(jm))


def ernie_pair():
    paddle.seed(0)
    jm = JCls(j_ernie_tiny(use_flash_attention=False), num_classes=2).eval()
    pm = ErnieForSequenceClassification(ernie_tiny(), num_classes=2,
                                        device="cpu")
    return jm, convert.load_jax_state(pm, _arrays(jm)).eval()


def jax_predictor(jm, prefix, shape, dtype, name):
    paddle.jit.save(jm, prefix, input_spec=[
        paddle.static.InputSpec(shape, dtype, name)])
    return jinference.create_predictor(jinference.Config(prefix))


def port_predictor(pm, prefix, shape, dtype, name):
    jit.save(pm, prefix, input_spec=[InputSpec(shape, dtype, name)])
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _ids(shape, seed, vocab=256):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int64)


def _run_subprocess(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


class TestSaveLoadAgainstReference:
    def test_mlp_same_process(self, tmp_path):
        jm, pm = mlp_pair()
        x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
        jp = jax_predictor(jm, str(tmp_path / "j"), [None, 8], "float32",
                           "x")
        ref = jp.run([x])[0]
        jit.save(pm, str(tmp_path / "p"),
                 input_spec=[InputSpec([None, 8], "float32", "x")])
        loaded = jit.load(str(tmp_path / "p"), device="cpu")
        out = loaded(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=MLP_RTOL, atol=MLP_ATOL)
        pp = port_predictor(pm, str(tmp_path / "q"), [None, 8], "float32",
                            "x")
        assert pp.get_input_names() == ["x"]
        np.testing.assert_allclose(pp.run([x])[0], ref, rtol=MLP_RTOL,
                                   atol=MLP_ATOL)

    def test_ernie_same_process(self, tmp_path):
        jm, pm = ernie_pair()
        ids = _ids((2, 16), 1)
        ref = jax_predictor(jm, str(tmp_path / "j"), [2, 16], "int64",
                            "ids").run([ids])[0]
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        out = pp.run([ids])[0]
        assert out.shape == ref.shape == (2, 2)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ERNIE_ATOL)
        with torch.no_grad():
            eager = pm(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(out, eager)

    @pytest.mark.parametrize("model", ["mlp", "ernie"])
    def test_cross_process(self, tmp_path, model):
        """Saved here, loaded and run in a fresh process that imports
        neither JAX nor the JAX package; both jit.load and the Predictor
        give the reference's outputs."""
        if model == "mlp":
            jm, pm = mlp_pair()
            x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
            shape, dtype, tol = [None, 8], "float32", (MLP_RTOL, MLP_ATOL)
        else:
            jm, pm = ernie_pair()
            x = _ids((3, 24), 2)
            shape, dtype, tol = [None, None], "int64", (0, ERNIE_ATOL)
        ref = jax_predictor(jm, str(tmp_path / "j"), list(x.shape), dtype,
                            "x").run([x])[0]
        p = str(tmp_path / "p")
        jit.save(pm, p, input_spec=[InputSpec(shape, dtype, "x")])
        np.save(str(tmp_path / "x.npy"), x)
        np.save(str(tmp_path / "ref.npy"), ref)
        out = _run_subprocess(f"""
import sys
import numpy as np, torch
from paddle_tpu_torch import inference, jit
x = np.load({str(tmp_path / 'x.npy')!r})
ref = np.load({str(tmp_path / 'ref.npy')!r})
m = jit.load({p!r}, device="cpu")
np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), ref,
                           rtol={tol[0]}, atol={tol[1]})
cfg = inference.Config({p!r})
cfg.disable_gpu()
pred = inference.create_predictor(cfg)
np.testing.assert_allclose(pred.run([x])[0], ref, rtol={tol[0]},
                           atol={tol[1]})
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "paddle_tpu"))
assert not bad, bad
print("PORT_SUBPROCESS_OK")
""")
        assert "PORT_SUBPROCESS_OK" in out

    def test_config_dir_discovery_and_handles(self, tmp_path):
        jm, pm = mlp_pair()
        x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
        ref = jax_predictor(jm, str(tmp_path / "jm"), [4, 8],
                            "float32", "img").run([x])[0]
        jit.save(pm, str(tmp_path / "p" / "model"),
                 input_spec=[InputSpec([4, 8], "float32", "img")])
        cfg = inference.Config(str(tmp_path / "p"))
        cfg.disable_gpu()
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(True)
        assert cfg.prog_file().endswith("model.pt2")
        pred = inference.create_predictor(cfg)
        pred.get_input_handle("img").copy_from_cpu(x)
        assert pred.run() is True
        out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_allclose(out, ref, rtol=MLP_RTOL, atol=MLP_ATOL)

    def test_save_requires_input_spec(self, tmp_path):
        _, pm = mlp_pair()
        with pytest.raises(ValueError, match="input_spec"):
            jit.save(pm, str(tmp_path / "m"))
        with pytest.raises(ValueError, match="input_spec"):
            paddle.jit.save(mlp_pair()[0], str(tmp_path / "j"))


class TestDynamicShapes:
    def test_one_artifact_takes_every_batch_and_length(self, tmp_path):
        """One ERNIE artifact with ``[None, None]`` ids: batch 1-16 and
        lengths up to the position table (128 in ernie_tiny), each equal to
        the reference's predictor saved at that shape."""
        jm, pm = ernie_pair()
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        for i, (b, s) in enumerate(((1, 16), (3, 5), (16, 128), (2, 77),
                                    (1, 1))):
            ids = _ids((b, s), 10 + i)
            ref = jax_predictor(jm, str(tmp_path / f"j{i}"), [b, s],
                                "int64", "ids").run([ids])[0]
            np.testing.assert_allclose(pp.run([ids])[0], ref, rtol=0,
                                       atol=ERNIE_ATOL, err_msg=f"{b}x{s}")

    def test_length_beyond_the_position_table_is_refused(self, tmp_path):
        _, pm = ernie_pair()
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        with pytest.raises(Exception, match="128"):
            pp.run([_ids((1, 129), 0)])

    def test_a_dimension_the_forward_fixes_is_refused(self, tmp_path):
        class Fixed(torch.nn.Module):
            def forward(self, x):
                return x + torch.ones(2, 3)     # the batch must be 2
        with pytest.raises(ValueError, match="any extent"):
            jit.save(Fixed(), str(tmp_path / "f"),
                     input_spec=[InputSpec([None, 3], "float32")])


class TestFlashOperator:
    def test_opcheck_through_the_plain_version(self):
        rng = np.random.RandomState(4)
        q, k, v = (torch.from_numpy(rng.randn(2, 19, 4, 64).astype(
            np.float32)) for _ in range(3))
        for causal in (False, True):
            torch.library.opcheck(flash_attention_fwd_op,
                                  (q, k, v, causal, 0.125, True))
        out, lse = flash_attention_fwd_op(q, k, v, False, 0.125, True)
        ref, ref_lse = ca.mha_fwd_reference(q, k, v, causal=False,
                                            scale=0.125)
        assert out.is_contiguous()
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
        np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())

    def test_exported_program_holds_one_operator_a_layer(self, tmp_path):
        """The export keeps the kernel: one operator node per encoder layer
        in the saved graph, and each run of the loaded program calls it once
        a layer (on CPU tensors, through the wrapper's plain version)."""
        _, pm = ernie_pair()
        jit.save(pm, str(tmp_path / "p"),
                 input_spec=[InputSpec([None, None], "int64", "ids")])
        art = exporting.load_artifact(str(tmp_path / "p"), "cpu")
        targets = [str(n.target) for n in art.program.graph.nodes
                   if n.op == "call_function"]
        n_layers = ernie_tiny().num_layers
        assert sum(t.startswith(OP_NAME.replace("::", ".")) for t in
                   targets) == n_layers
        before = ca.plain_calls
        art(torch.from_numpy(_ids((2, 9), 5)))
        assert ca.plain_calls - before == n_layers


class TestPrecisionAndRefusals:
    def test_bf16_model_saved_after_decorate(self, tmp_path):
        """``amp.decorate`` then ``jit.save``: the program runs in bf16 and
        hands ``ml_dtypes`` bfloat16 outputs, bit for bit the eager bf16
        model's; without ``ml_dtypes`` the same values as float32."""
        _, pm = ernie_pair()
        amp.decorate(pm, dtype="bfloat16")
        assert all(p.dtype == torch.bfloat16 for p in pm.parameters())
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        ids = _ids((2, 16), 6)
        out = pp.run([ids])[0]
        with torch.no_grad():
            eager = pm(torch.from_numpy(ids)).float().numpy()
        assert out.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(out.astype(np.float32), eager)

    def test_bf16_outputs_are_float32_without_ml_dtypes(self, tmp_path,
                                                         monkeypatch):
        _, pm = ernie_pair()
        amp.decorate(pm, dtype="bfloat16")
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        ids = _ids((2, 16), 6)
        want = pp.run([ids])[0].astype(np.float32)
        monkeypatch.setattr(inference, "ml_dtypes", None)
        out = pp.run([ids])[0]
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, want)

    def test_bf16_outputs_have_the_reference_dtype(self, tmp_path):
        """The same converted ``ernie_tiny`` decorated to bf16 in both
        packages, saved and run through each Predictor: the outputs' numpy
        dtype is the reference's (``np.asarray`` of a jax bf16 array, an
        ``ml_dtypes`` bfloat16 array), the values within BF16_ATOL."""
        jm, pm = ernie_pair()
        paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        amp.decorate(pm, level="O2", dtype="bfloat16")
        ids = _ids((2, 16), 6)
        ref = jax_predictor(jm, str(tmp_path / "j"), [2, 16], "int64",
                            "ids").run([ids])[0]
        out = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                             "ids").run([ids])[0]
        assert ref.dtype == ml_dtypes.bfloat16
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_allclose(out.astype(np.float32),
                                   ref.astype(np.float32), rtol=0,
                                   atol=BF16_ATOL)

    def test_decorate_matches_reference(self, tmp_path):
        """``amp.decorate`` against the reference's on the same converted
        ``ernie_tiny``: the same state entries cast to bf16, and the saved
        bf16 programs' logits within BF16_ATOL of each other (bf16 keeps 8
        significant bits; these logits are below 1) and the port's distance
        from the float32 logits within BF16_FLOOR_FACTOR x the
        reference's."""
        jm, pm = ernie_pair()
        ids = _ids((2, 16), 6)
        ref32 = jax_predictor(jm, str(tmp_path / "j32"), [2, 16], "int64",
                              "ids").run([ids])[0]
        paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        amp.decorate(pm, level="O2", dtype="bfloat16")
        jdt = {n: str(t.dtype) for n, t in
               list(jm.named_parameters()) + list(jm.named_buffers())}
        pdt = {n: str(t.dtype).replace("torch.", "")
               for n, t in pm.state_dict().items()}
        assert pdt == jdt and set(pdt.values()) == {"bfloat16"}
        ref = jax_predictor(jm, str(tmp_path / "j"), [2, 16], "int64",
                            "ids").run([ids])[0].astype(np.float32)
        out = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                             "ids").run([ids])[0].astype(np.float32)
        assert np.abs(ref32).max() < 1
        np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_ATOL)
        assert np.abs(out - ref32).max() <= \
            BF16_FLOOR_FACTOR * np.abs(ref - ref32).max()

    def test_left_out_paths_raise(self, tmp_path):
        _, pm = mlp_pair()
        prefix = str(tmp_path / "m")
        jit.save(pm, prefix, input_spec=[InputSpec([None, 8], "float32")])
        for prec in (inference.PrecisionType.Bfloat16,
                     inference.PrecisionType.Half):
            cfg = inference.Config(prefix)
            cfg.disable_gpu()
            cfg.set_precision(prec)
            with pytest.raises(NotImplementedError, match="5d"):
                inference.create_predictor(cfg)
        with pytest.raises(NotImplementedError, match="5d"):
            inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
        cfg = inference.Config(prefix)
        cfg.disable_gpu()
        pred = inference.create_predictor(cfg)
        # the fingerprint is ported (a fleet worker stamps its version
        # with it): a sha256 hex digest, the same on every call
        fp = pred.artifact_fingerprint()
        assert len(fp) == 64 and int(fp, 16) >= 0
        assert pred.artifact_fingerprint() == fp
        # the serving mesh is ported (item 5c, part 1): an inert mesh
        # keeps the key, a live one changes it; the fingerprint stays
        from paddle_tpu_torch.distributed.mesh_utils import build_mesh
        assert pred.attach_serving_mesh(None) is pred
        inert = pred._cache_identity()
        pred.attach_serving_mesh(build_mesh({"mp": 2}, devices=["cpu"] * 2))
        assert pred._cache_identity() != inert
        assert pred.artifact_fingerprint() == fp
        pred.attach_serving_mesh(None)
        assert pred._cache_identity() == inert
        (tmp_path / "empty").mkdir()
        with pytest.raises(ValueError, match="no .pt2"):
            inference.Config(str(tmp_path / "empty"))

    def test_the_card_is_the_default_device(self, tmp_path):
        """Without ``disable_gpu`` the Predictor runs on the CUDA device;
        without one it raises rather than falling back to the CPU."""
        _, pm = mlp_pair()
        prefix = str(tmp_path / "m")
        jit.save(pm, prefix, input_spec=[InputSpec([None, 8], "float32")])
        if torch.cuda.is_available():
            assert inference.create_predictor(
                inference.Config(prefix)).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                inference.create_predictor(inference.Config(prefix))
            with pytest.raises(RuntimeError, match="CUDA"):
                jit.load(prefix)


def test_bench_inference_cpu_smoke(tmp_path, capsys, monkeypatch):
    """``python -m paddle_tpu_torch.bench_inference --cpu --small``: the
    reference's keys, no device time on the CPU, bf16 within 5% of the
    float32 logits' largest."""
    import tempfile
    from paddle_tpu_torch import bench_inference
    out = str(tmp_path / "infer.json")
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    assert bench_inference.main(["--cpu", "--small", "--iters", "3",
                                 "--out", out]) == 0
    assert not list(scratch.iterdir())      # the saved artifacts removed
    import json
    res = json.load(open(out))
    assert res["device"] == "cpu"
    for key in ("ernie_tiny_b2_s16", "resnet18_b1_64"):
        row = res[key]
        for prec in ("float32", "bfloat16"):
            assert {"p50_ms", "p99_ms", "qps"} <= set(row[prec])
            assert "device_ms" not in row[prec]
        assert 0 <= row["bfloat16"]["max_rel_err_vs_f32"] < 0.05
        assert "speedup_p50" in row and "speedup_device" not in row
