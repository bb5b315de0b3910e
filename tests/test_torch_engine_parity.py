"""Port parity: the GenerationServer's prefix-cache, speculative-decoding and
int8-pool paths against the JAX package's GenerationServer, on ``gpt_tiny``
in float32 on the CPU with the same weights (``load_jax_state``).

Both engines get the same requests, submitted before their workers start,
so admission, batching, prefix hits and speculation happen in the same
order; greedy and seeded-temperature streams must be identical token for
token, and the engines' prefix and speculation counters equal. The int8
flag is set in both packages by a fixture that restores it.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving.generation import GenerationServer
from test_torch_flags import kv_dtype_flag, pin_kv_dtype  # noqa: F401
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

SUFFIX_LENS = [3, 7, 12, 5, 20, 9]
MAX_NEW = [6, 10, 4, 8, 5, 7]
TEMPS = [0.0, 0.8, 0.0, 1.0, 0.0, 0.7]


def make_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture
def int8_pools():
    with kv_dtype_flag("int8"):
        yield


def _prompts():
    """A shared 24-token preamble (three pages of 8) and unique tails."""
    rng = np.random.RandomState(11)
    pre = rng.randint(1, 256, 24).tolist()
    return [pre + rng.randint(1, 256, n).tolist() for n in SUFFIX_LENS]


def _serve(srv, prompts, max_new=MAX_NEW, temps=TEMPS):
    with srv:
        futs = [srv.submit_generate(p, max_new_tokens=n, temperature=t,
                                    seed=100 + i)
                for i, (p, n, t) in enumerate(zip(prompts, max_new, temps))]
        srv.start()
        out = [f.result(timeout=180) for f in futs]
        reasons = [f.finish_reason for f in futs]
    return out, reasons, srv.metrics_snapshot()


# config: (prefix cache, kv dtype, draft: None | "self" | "other")
CONFIGS = {
    "prefix": (True, "", None),
    "spec_draft": (False, "", "other"),
    "spec_self": (False, "", "self"),
    "int8": (False, "int8", None),
    "prefix_int8_spec": (True, "int8", "other"),
    "prefix_int8_self": (True, "int8", "self"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_streams_match_reference_engine(name):
    prefix, kv_dtype, draft = CONFIGS[name]
    jm, tm = make_pair()
    if draft == "other":        # a 2-layer draft with weights of its own
        jd, td = make_pair(seed=7)
    else:
        jd, td = (jm, tm) if draft == "self" else (None, None)
    prompts = _prompts()
    with kv_dtype_flag(kv_dtype):
        want, want_r, jsnap = _serve(JServer(
            jm, max_batch=4, page_size=8, prefix_cache=prefix,
            draft_model=jd, spec_k=3, name=f"j{name}", start=False),
            prompts)
        srv = GenerationServer(tm, max_batch=4, page_size=8,
                               prefix_cache=prefix, draft_model=td,
                               spec_k=3, device="cpu", name=name,
                               start=False)
        assert srv.kv.kv_dtype == ("int8" if kv_dtype else "")
        got, got_r, snap = _serve(srv, prompts)
    assert got == want
    assert got_r == want_r == ["length"] * len(prompts)
    assert [len(t) for t in got] == MAX_NEW
    assert snap["kv_leak_check"]["ok"] and srv.active_sequences == 0
    for key in ("hits", "tokens_reused"):
        assert snap["prefix"][key] == jsnap["prefix"][key]
    for key in ("proposed", "accepted"):
        assert snap["spec"][key] == jsnap["spec"][key]
    assert snap["kv_pages"]["pool_bytes"] == jsnap["kv_pages"]["pool_bytes"]
    if prefix:
        assert snap["prefix"]["hits"] >= 2
        assert snap["prefix"]["cached_pages"] == \
            jsnap["prefix"]["cached_pages"] > 0
    if draft:
        assert snap["spec"]["k"] == 3 and snap["spec"]["proposed"] > 0
        assert td is not None and srv.decoder.calls["verify"] > 0
        assert srv.decoder.calls["decode"] == 0     # every step verifies
    if draft == "self":
        # the draft is the target: greedy lanes reject nothing, and fall
        # short of 1 only where a last round proposes past a lane's budget
        g = snap["spec"]["greedy_acceptance_rate"]
        assert 0.5 < g <= 1.0


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_self_draft_accepts_everything(kv_dtype):
    """Draft == target, greedy: every proposal accepted, so 16 tokens take
    4 verify steps of k + 1 = 4, as in the reference."""
    jm, tm = make_pair()
    with kv_dtype_flag(kv_dtype):
        want, _, jsnap = _serve(JServer(jm, max_batch=2, page_size=8,
                                        draft_model=jm, spec_k=3,
                                        name="jselfspec", start=False),
                                [[5, 7, 9]], [16], [0.0])
        srv = GenerationServer(tm, max_batch=2, page_size=8, draft_model=tm,
                               spec_k=3, device="cpu", name="selfspec",
                               start=False)
        got, _, snap = _serve(srv, [[5, 7, 9]], [16], [0.0])
    assert got == want and len(got[0]) == 16
    assert snap["spec"]["acceptance_rate"] == 1.0 == \
        jsnap["spec"]["acceptance_rate"]
    assert snap["step_ms"]["decode"]["count"] == 4 == \
        jsnap["step_ms"]["decode"]["count"]
    assert srv.decoder.calls["verify"] == 4
    assert snap["kv_leak_check"]["ok"]


def test_int8_eos_and_budget_mid_speculation(int8_pools):
    """eos inside an accepted run and a budget smaller than one round stop
    the stream where the reference's stops."""
    jm, tm = make_pair()
    greedy, _, _ = _serve(GenerationServer(tm, max_batch=2, page_size=8,
                                           device="cpu", start=False),
                          [[5, 7, 9]], [12], [0.0])
    eos = int(greedy[0][4])
    outs = []
    for make in (lambda **kw: JServer(jm, draft_model=jm, name="jeos",
                                      start=False, **kw),
                 lambda **kw: GenerationServer(tm, draft_model=tm,
                                               device="cpu", name="eos",
                                               start=False, **kw)):
        a = _serve(make(max_batch=2, page_size=8, spec_k=4,
                        eos_token_id=eos), [[5, 7, 9]], [12], [0.0])
        b = _serve(make(max_batch=2, page_size=8, spec_k=6),
                   [[5, 7, 9]], [2], [0.0])
        outs.append((a[0], a[1], b[0], b[1]))
    assert outs[1] == outs[0]
    toks, reasons, capped, capped_r = outs[1]
    assert reasons == ["eos"] and toks[0][-1] == eos
    assert capped_r == ["length"] and len(capped[0]) == 2
