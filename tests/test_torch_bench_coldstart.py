"""``python -m paddle_tpu_torch.tools.bench_coldstart --device cpu``: one
cold and one warm trial in fresh processes over a saved MLP. The cold
child warms the whole bucket lattice (every signature a compile-cache
miss), the warm child replays the cold child's manifest (each signature a
hit, no miss), each child's ``/metrics`` agrees with ``stats()``, and the
start-up split covers the time to the first response.
"""
import contextlib
import io
import json

from paddle_tpu_torch.tools import bench_coldstart


def test_cold_and_warm_trials_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_coldstart.main(["--device", "cpu", "--model", "mlp",
                                   "--trials", "1", "--json"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["metrics_consistent"] is True
    # the lattice: batch buckets 1, 2, 4; the manifest: the first request
    # (1 row) and the burst's 4-row bucket
    assert res["warmed"] == {"cold": [3], "warm": [2]}
    for side in ("cold", "warm"):
        split = res["split_median_s"][side]
        assert set(split) == set(bench_coldstart.PHASES)
        assert all(v >= 0 for v in split.values())
        assert split["cuda_context"] == split["kernel_library"] == 0.0
        total = res[f"{side}_median_s"]
        assert sum(split.values()) <= total + 1e-3
        assert split["imports"] + split["model"] > 0.5 * total
    assert res["card"] is None and res["trials"] == 1
