"""The Paddle-style encoder classifier (``test_torch_paddle_encoder_script.
py``): each package's ``paddle.save`` of the trained classifier's state
dict loads into the other's model and gives its logits (eval, float32
within 1e-5 relative and 1e-6 absolute)."""
import numpy as np

from test_torch_paddle_encoder_script import (SMALL, _packages, batches_for,
                                              eval_logits, train_script)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


def test_save_files_read_across_both_ways(tmp_path):
    """Each package's ``paddle.save`` of the classifier's state dict loads
    into the other's and gives its logits."""
    jp, tp = _packages()
    batches = batches_for(SMALL, 3, n=1)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    _, jm, _ = train_script(jp, SMALL, 1, 0, batches, save_dir=str(jdir))
    _, pm, _ = train_script(tp, SMALL, 1, 0, batches, save_dir=str(pdir))
    lengths = [SMALL["seq"]] * SMALL["batch"]
    logits = {jp: eval_logits(jp, jm, batches[0], lengths).numpy(),
              tp: eval_logits(tp, pm, batches[0], lengths).numpy()}
    for src_dir, src, src_model, dst, dst_model in (
            (jdir, jp, jm, tp, pm), (pdir, tp, pm, jp, jm)):
        sd = dst.load(str(src_dir / "model.pdparams"))
        assert list(sd) == list(src_model.state_dict())
        dst_model.set_state_dict(sd)
        np.testing.assert_allclose(
            eval_logits(dst, dst_model, batches[0], lengths).numpy(),
            logits[src], rtol=1e-5, atol=1e-6)
