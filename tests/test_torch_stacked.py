"""Port parity: the layer-stacked GPT decoder (``GPTStackedTransformer``,
``GPTConfig.recompute``) against the JAX package's, on ``gpt_tiny`` (head_dim
16, 2 layers) on the CPU.

Weights come from the JAX model (``gpt_tiny(stacked=True)``, seed 0) through
``convert.load_jax_state``, which moves the stacked ``[in, out]`` weights
untransposed; inputs from seeded numpy. Tolerances are
``test_torch_train.py``'s: logits atol 1e-4; losses and parameters after two
AdamW steps rtol 2e-4 / atol 2e-5 in float32; AMP by the rounding-floor rule
(the port's distance from the float32 run at most 1.5x the reference's own).
Cached logits are compared on live rows only (the reference's two paged
paths disagree on dead rows).
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu.serving.generation.model_fns import CachedDecoder as JDecoder
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny)
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_attention_bwd as cab
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving.generation import (CachedDecoder,
                                                 GenerationServer)
from test_torch_flags import kv_dtype_flag, pin_kv_dtype  # noqa: F401
from test_torch_train import ATOL, O2_FACTOR, RTOL, _ids, _l2
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

POLICIES = ("none", "full", "dots", "attn")
LOGITS_ATOL = 1e-4
LR = 1e-4
# flash forward launches a training step per layer under each policy: the
# recomputed forward runs the kernel again under "full" and "dots"; "attn"
# keeps the kernel's (out, lse)
FWD_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "attn": 1}


def _jax_model(recompute="full"):
    paddle.seed(0)
    return JGPT(j_gpt_tiny(stacked=True, recompute=recompute,
                           use_flash_attention=False))


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _port_model(arrays, recompute="full"):
    m = GPTForCausalLM(gpt_tiny(stacked=True, recompute=recompute),
                       device="cpu")
    return convert.load_jax_state(m, arrays)


@functools.lru_cache(maxsize=None)
def _jax_train(recompute, amp_level, steps=2, seed=0):
    """Losses and parameters after ``steps`` AdamW steps of the reference's
    stacked model (cached: several tests read the same run)."""
    jm = _jax_model(recompute)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    crit = JCriterion()
    step = JTrainStep(jm, lambda out, y: crit(out, y), opt,
                      amp_level=amp_level)
    t = paddle.to_tensor(_ids(seed))
    losses = [float(step(t, t).numpy()) for _ in range(steps)]
    return losses, _arrays(jm)


def _port_train(arrays, recompute, amp_level, steps=2, seed=0, model=None):
    m = model if model is not None else _port_model(arrays, recompute)
    opt = AdamW(learning_rate=LR, parameters=m.named_parameters())
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt,
                     amp_level=amp_level)
    t = torch.from_numpy(_ids(seed))
    losses = [float(step(t, t)) for _ in range(steps)]
    return losses, convert.export_jax_state(m)


def _key_bias(name, shape):
    """The key slots of the stacked qkv bias ``[L, nh * 3 * hd]`` (head-major
    ``[nh, 3, hd]``): softmax ignores a shift of the keys, so their exact
    gradient is zero and Adam turns float32 noise into updates of up to lr
    a step (``test_torch_train._assert_matches``)."""
    mask = np.zeros(shape, bool)
    if name == "gpt.decoder.qkv_b":
        mask.reshape(shape[0], gpt_tiny().num_heads, 3, -1)[:, :, 1] = True
    return mask


def _assert_matches(tag, port, ref, init, steps=2):
    (lp, pp), (lr_, pr) = port, ref
    np.testing.assert_allclose(lp, lr_, rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag}: losses")
    assert pp.keys() == pr.keys()
    for n in pr:
        kb = _key_bias(n, pr[n].shape)
        np.testing.assert_allclose(pp[n][~kb], pr[n][~kb], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag}: {n}")
        for got in (pp[n], pr[n]):
            if kb.any():
                moved = np.abs(got[kb] - init[n][kb]).max()
                assert moved <= steps * LR * (1 + 1e-3), (tag, n, moved)


def test_state_dict_names_shapes_and_no_transpose():
    jm = _jax_model()
    arrays = _arrays(jm)
    tm = _port_model(arrays)
    t = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: tuple(v.shape) for k, v in arrays.items()}
    assert tuple(t["gpt.decoder.qkv_w"].shape) == (2, 64, 192)
    assert len(tm.gpt.layers) == 0
    # the stacked weights cross as they are: [in, out], no transpose
    for name in ("gpt.decoder.qkv_w", "gpt.decoder.fc2_w",
                 "gpt.decoder.ln1_w"):
        np.testing.assert_array_equal(t[name].numpy(), arrays[name])
    back = convert.export_jax_state(tm)
    assert all(np.array_equal(back[n], arrays[n]) for n in arrays)
    assert tm.kv_cache_spec()["stacked"] is True


def test_seeded_init_and_unknown_recompute():
    a = GPTForCausalLM(gpt_tiny(stacked=True), device="cpu", seed=1)
    b = GPTForCausalLM(gpt_tiny(stacked=True), device="cpu", seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    dec = a.gpt.decoder
    assert torch.equal(dec.ln1_w, torch.ones(2, 64))
    assert not dec.qkv_b.any() and not dec.fc2_b.any()
    assert 0.015 < float(dec.fc1_w.detach().std()) < 0.025
    for bad in ("selective", "", "Full"):
        with pytest.raises(ValueError, match="recompute must be"):
            gpt_tiny(stacked=True, recompute=bad)
        with pytest.raises(ValueError, match="recompute must be"):
            j_gpt_tiny(stacked=True, recompute=bad)


@pytest.mark.parametrize("recompute", POLICIES)
def test_logits_match_reference(recompute):
    jm = _jax_model(recompute)
    jm.eval()
    tm = _port_model(_arrays(jm), recompute)
    ids = _ids(1, s=9)
    want = jm(paddle.to_tensor(ids)).numpy()
    got = tm(torch.from_numpy(ids))          # grad on: the remat path
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("recompute", POLICIES)
def test_two_steps_float32_match_jax(recompute):
    init = _arrays(_jax_model())
    ref = _jax_train(recompute, None)
    fwd0, bwd0 = ca.plain_calls, dict(cab.plain_calls)
    port = _port_train(init, recompute, None)
    n_layers = gpt_tiny().num_layers
    # on CPU tensors every launch is a plain-version call: per step, the
    # flash forward once a layer, or twice when the layer is recomputed
    assert ca.plain_calls - fwd0 == 2 * n_layers * FWD_PER_LAYER[recompute]
    assert all(cab.plain_calls[n] - bwd0[n] == 2 * n_layers
               for n in cab.KERNELS)
    _assert_matches(f"stacked {recompute}", port, ref, init)
    assert port[0][1] < port[0][0]


def test_optimizer_state_carries_across():
    """Two JAX steps with bf16 moments, then the weights, the moments (the
    stacked ones untransposed, in bf16) and the step count go across
    through convert.py; a third step in both packages agrees."""
    jm = _jax_model()
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters(),
                                  moment_dtype="bfloat16")
    jcrit = JCriterion()
    jstep = JTrainStep(jm, lambda out, y: jcrit(out, y), jopt)
    jt = paddle.to_tensor(_ids(8))
    for _ in range(2):
        jstep(jt, jt)
    arrays = _arrays(jm)
    state = {f"{n}_{an}": np.asarray(jopt._accumulators[an][id(p)])
             for n, p in jm.named_parameters() for an in jopt._accum_names}
    m = _port_model(arrays)
    opt = AdamW(learning_rate=LR, moment_dtype="bfloat16")
    convert.load_jax_optimizer_state(opt, m, state, jopt._step_count)
    mom = opt._get_accum("moment2", m.gpt.decoder.fc1_w)
    assert mom.dtype == torch.bfloat16 and mom.shape == (2, 64, 256)
    np.testing.assert_array_equal(
        mom.float().numpy(),
        state["gpt.decoder.fc1_w_moment2"].astype(np.float32))
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt)
    t = torch.from_numpy(_ids(8))
    loss = float(step(t, t))
    jloss = float(jstep(jt, jt).numpy())
    assert opt._step_count == jopt._step_count == 3
    _assert_matches("third step", ([loss], convert.export_jax_state(m)),
                    ([jloss], _arrays(jm)), arrays, steps=1)


def test_recompute_does_not_change_a_float32_result():
    """"none" and "full" (and the selective policies) compute the same
    float32 losses and gradients, bit for bit."""
    init = _arrays(_jax_model())
    ids = torch.from_numpy(_ids(2))
    grads = {}
    for recompute in POLICIES:
        m = _port_model(init, recompute)
        loss = GPTPretrainingCriterion()(m(ids), ids)
        loss.backward()
        grads[recompute] = [loss.detach()] + [p.grad for p in m.parameters()]
    for recompute in POLICIES[1:]:
        for a, b in zip(grads[recompute], grads["none"]):
            assert torch.equal(a, b), recompute


@pytest.mark.parametrize("recompute", ["full", "attn"])
def test_amp_o2_within_the_rounding_floor(recompute):
    """O2 casts the decoder's input and its twelve stacked parameters to
    bf16 once, at the ``gpt_stacked_decoder`` boundary: two steps held by
    the rounding-floor rule against the reference's O2."""
    arrays = _arrays(_jax_model())
    fl, fp = _jax_train(recompute, None)
    jl, jp = _jax_train(recompute, "O2")
    pl, pp = _port_train(arrays, recompute, "O2")
    ref_loss = max(abs(a - b) for a, b in zip(jl, fl))
    port_loss = max(abs(a - b) for a, b in zip(pl, fl))
    ref_par, port_par = _l2(jp, fp), _l2(pp, fp)
    assert 0 < ref_loss and 0 < ref_par
    assert port_loss <= O2_FACTOR * ref_loss, (port_loss, ref_loss)
    assert port_par <= O2_FACTOR * ref_par, (port_par, ref_par)
    assert pl[1] < pl[0]


def test_amp_o1_runs_the_stacked_decoder_in_float32():
    """The stacked decoder is on neither AMP list, so under O1 nothing is
    cast at its boundary and it runs in float32 (unlike the module stack,
    whose linears O1 casts); only the lm head's matmul runs in bf16."""
    arrays = _arrays(_jax_model())
    tm = _port_model(arrays)
    ids = torch.from_numpy(_ids(3, s=9))
    seen = []
    tm.gpt.decoder.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        h32 = tm.gpt.decoder(tm.gpt.embeddings(ids))
        with auto_cast(level="O1"):
            logits = tm(ids)
            h1 = tm.gpt.decoder(tm.gpt.embeddings(ids))
        with auto_cast(level="O2"):
            h2 = tm.gpt.decoder(tm.gpt.embeddings(ids))
    assert seen[1] == (torch.float32, torch.float32)
    assert torch.equal(h1, h32)
    assert logits.dtype == torch.bfloat16 and h2.dtype == torch.bfloat16
    # the same in the reference: its O1 decoder output is float32 and equal
    jm = _jax_model()
    jm.eval()
    with paddle.amp.auto_cast(level="O1"):
        jh = jm.gpt.decoder(jm.gpt.embeddings(paddle.to_tensor(
            ids.numpy())))
    assert str(jh.dtype).endswith("float32")
    np.testing.assert_allclose(h1.numpy(), jh.numpy(), atol=LOGITS_ATOL,
                               rtol=0)
    # two O1 steps by the rounding-floor rule
    fl, fp = _jax_train("full", None)
    jl, jp = _jax_train("full", "O1")
    pl, pp = _port_train(arrays, "full", "O1")
    assert max(abs(a - b) for a, b in zip(pl, fl)) <= O2_FACTOR * max(
        abs(a - b) for a, b in zip(jl, fl))
    assert _l2(pp, fp) <= O2_FACTOR * _l2(jp, fp)


def test_stacked_matches_the_port_per_layer_model():
    """The same weights in the port's per-layer module stack
    (``convert.stack_layer_state`` moves them across): equal losses and
    gradients, and equal parameters after two float32 AdamW steps."""
    per_layer = GPTForCausalLM(gpt_tiny(), device="cpu", seed=4)
    stacked = GPTForCausalLM(gpt_tiny(stacked=True), device="cpu", seed=9)
    stacked.load_state_dict(convert.stack_layer_state(
        per_layer.state_dict()))
    init = convert.export_jax_state(stacked)
    ids = torch.from_numpy(_ids(5))
    crit = GPTPretrainingCriterion()
    losses = []
    for m in (per_layer, stacked):
        loss = crit(m(ids), ids)
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL, atol=ATOL)
    want = convert.stack_layer_state({n: p.grad for n, p in
                                      per_layer.named_parameters()})
    for n, p in stacked.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    a, _ = _port_train(None, None, None, seed=6, model=per_layer)
    b = _port_train(None, None, None, seed=6, model=stacked)
    want = {n: t.numpy() for n, t in convert.stack_layer_state(
        per_layer.state_dict()).items()}
    _assert_matches("stacked vs per-layer", b, (a, want), init)


@pytest.mark.parametrize("recompute", POLICIES)
def test_stacked_weights_are_split_once(recompute):
    """The O(L²) trap is absent under every policy: each stacked parameter
    reaches the layers through ONE unbind (its backward is one stack),
    never through per-layer indexing (whose select backward would add a
    whole [L, ...] zero tensor per layer)."""
    tm = GPTForCausalLM(gpt_tiny(stacked=True, num_layers=3,
                                 recompute=recompute), device="cpu")
    ids = torch.from_numpy(_ids(7, s=9))
    for level in (None, "O2"):
        if level:
            with auto_cast(level=level):
                loss = tm(ids).float().mean()
        else:
            loss = tm(ids).mean()
        nodes, stack = set(), [loss.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is not None and fn not in nodes:
                nodes.add(fn)
                stack.extend(f for f, _ in fn.next_functions)
        names = [type(f).__name__ for f in nodes]
        assert not any(n.startswith("SelectBackward") for n in names)
        stacked = {id(p) for p in tm.gpt.decoder.parameters()}
        unbinds = []
        for fn in nodes:
            if not type(fn).__name__.startswith("UnbindBackward"):
                continue
            leaf = fn.next_functions[0][0]
            while leaf is not None and not hasattr(leaf, "variable"):
                leaf = leaf.next_functions[0][0]   # O2's cast
            if leaf is not None and id(leaf.variable) in stacked:
                unbinds.append(id(leaf.variable))
        assert sorted(unbinds) == sorted(stacked), level


def _tables(b, pps):
    return (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_cached_prefill_decode_chunked_match_jax(kv_dtype):
    """Stacked pools: one [L, pages, page, H, D] pool (an int8 (values,
    scales) pair of them), layer i reading and writing pool[i] in place;
    prefill, decode and a chunked window against the reference's
    ``_forward_cached`` on live rows."""
    jm = _jax_model()
    jm.eval()
    tm = _port_model(_arrays(jm))
    tm.eval()
    b, window, ps, pps = 2, 8, 4, 8
    rng = np.random.RandomState(3)
    lens = np.array([5, 3], np.int32)
    ids = np.zeros((b, window), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 256, n)
    tables = _tables(b, pps)
    jd = JDecoder(jm, max_batch=b, page_size=ps, pages_per_seq=pps,
                  use_pallas=False)
    td = CachedDecoder(tm, max_batch=b, page_size=ps, pages_per_seq=pps,
                       kv_dtype=kv_dtype, device="cpu")
    jk, jv = jm.init_kv_pools(1 + b * pps, ps, kv_dtype or None)
    tk, tv = tm.init_kv_pools(1 + b * pps, ps, kv_dtype or None)
    leaves = tk if kv_dtype else (tk,)
    assert all(t.shape[0] == 2 for t in leaves)
    jl, jk, jv, _ = jd.prefill(ids, lens, tables, jk, jv)
    tl, tk2, tv2 = td.prefill(ids, lens, tables, tk, tv)
    assert tk2 is tk and tv2 is tv            # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=0)
    ctx = lens.copy()
    tok = np.asarray(jl).argmax(-1).astype(np.int64)
    active = np.array([True, False])           # lane 1 dead from here
    for _ in range(4):
        jl, jk, jv, _ = jd.decode(tok, ctx, active, ctx + 1, tables, jk, jv)
        tl, tk, tv = td.decode(tok, ctx, active, ctx + 1, tables, tk, tv)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=LOGITS_ATOL, rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int64)
        ctx = ctx + active
    win = rng.randint(0, 256, (b, 4)).astype(np.int64)
    seg = np.array([3, 0], np.int32)
    jl, jk, jv, _ = jd.prefill_chunked(win, ctx, seg, tables, jk, jv)
    tl, tk, tv = td.prefill_chunked(win, ctx, seg, tables, tk, tv)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                               atol=LOGITS_ATOL, rtol=0)
    # every written slot of every layer holds the reference's K/V
    used = tables[0, :4]
    got = tk[1] if kv_dtype else tk           # scales, or the values
    want = np.asarray(jk[1] if kv_dtype else jk)
    np.testing.assert_allclose(got.numpy()[:, used], want[:, used],
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_kernels_take_stacked_pool_views(kv_dtype):
    """Layer i of the stacked decoder hands the paged kernel the
    contiguous view pool[i] (of every leaf of an int8 pool), at an offset
    of i layers: ``supported`` takes it at every layer, so no stacked
    call is routed to the plain version. head_dim 128, bf16 queries."""
    from paddle_tpu_torch.models.gpt import GPTConfig, layer_pool
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    cfg = GPTConfig(vocab_size=64, hidden_size=256, num_layers=3,
                    num_heads=2, max_seq_len=64, stacked=True)
    m = GPTForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    k, v = m.init_kv_pools(5, 16, kv_dtype or None)
    tables = torch.ones(2, 4, dtype=torch.int32)
    for kind, s in (("decode", 1), ("chunked", 5)):
        q = torch.zeros(2, s, 2, 128, dtype=torch.bfloat16)
        for i in range(cfg.num_layers):
            kp, vp = layer_pool(k, i), layer_pool(v, i)
            leaves = kp if kv_dtype else (kp,)
            assert all(t.is_contiguous() and t.storage_offset() > 0
                       for t in leaves) or i == 0
            assert cpa.supported(q, kp, vp, tables, 16, kind), (kind, i)


# engine configurations: (target stacked, prefix cache, kv dtype, draft:
# None | "stacked" | "flat"); a draft may be stacked or not, independently
# of its target, as in the reference, where pools are opaque pytrees
ENGINES = {
    "prefix_int8": (True, True, "int8", None),
    "spec_flat_draft": (True, True, "", "flat"),
    "flat_target_stacked_draft_int8": (False, False, "int8", "stacked"),
}


def _engine_pair(stacked, seed):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny(stacked=stacked, use_flash_attention=False))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(stacked=stacked), device="cpu")
    return jm, convert.load_jax_state(tm, _arrays(jm))


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_streams_match_reference(name):
    """GenerationServer on stacked pools: greedy and seeded-temperature
    streams token for token equal to the reference engine's with the same
    models, with the prefix cache, int8 pools and a draft of either
    structure; the page accounting closes."""
    stacked, prefix, kv_dtype, draft = ENGINES[name]
    jm, tm = _engine_pair(stacked, 0)
    jd = td = None
    if draft:
        jd, td = _engine_pair(draft == "stacked", 7)
    rng = np.random.RandomState(11)
    pre = rng.randint(1, 256, 24).tolist()
    prompts = [pre + rng.randint(1, 256, n).tolist() for n in (3, 7, 12, 5)]
    max_new, temps = [6, 9, 4, 7], [0.0, 0.8, 0.0, 1.0]

    def serve(srv):
        with srv:
            futs = [srv.submit_generate(p, max_new_tokens=n, temperature=t,
                                        seed=100 + i)
                    for i, (p, n, t) in enumerate(zip(prompts, max_new,
                                                      temps))]
            srv.start()
            out = [f.result(timeout=180) for f in futs]
        return out, srv.metrics_snapshot()

    with kv_dtype_flag(kv_dtype):
        want, jsnap = serve(JServer(jm, max_batch=2, page_size=8,
                                    prefix_cache=prefix, draft_model=jd,
                                    spec_k=3, name=f"j{name}", start=False))
        srv = GenerationServer(tm, max_batch=2, page_size=8,
                               prefix_cache=prefix, draft_model=td,
                               spec_k=3, device="cpu", name=name,
                               start=False)
        got, snap = serve(srv)
    assert got == want and [len(t) for t in got] == max_new
    assert isinstance(srv.kv.k, list) != stacked
    assert snap["kv_pages"]["pool_bytes"] == jsnap["kv_pages"]["pool_bytes"]
    assert snap["kv_leak_check"]["ok"]
    if prefix:
        assert snap["prefix"]["hits"] == jsnap["prefix"]["hits"] >= 2
    if draft:
        assert snap["spec"]["accepted"] == jsnap["spec"]["accepted"]
        assert srv.decoder.calls["verify"] > 0
        assert isinstance(srv._draft_k, list) != (draft == "stacked")
