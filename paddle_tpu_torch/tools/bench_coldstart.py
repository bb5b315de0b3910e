"""Cold-start bench: process start to first serving response, cold against
warm, with the start-up split (the port of ``tools/bench_coldstart.py``).

Each trial spawns a fresh Python process that loads a saved artifact,
warms an ``InferenceServer`` and answers one request, once against an
EMPTY ``FLAGS_compile_cache_dir`` (cold: the full bucket lattice, every
signature's first dispatch measured by xstats) and once against the
directory the cold runs filled (warm: the warmup manifest replays exactly
the signatures the cold process's traffic dispatched, each one a
compile-cache hit that loads its first-dispatch record). A trial runs
from just before ``Popen`` to the first resolved response inside the
child, so the interpreter, the imports and the framework's start all
count: what a restart or an autoscaler's scale-out pays.

The child splits that time: ``imports`` (the interpreter and ``import
paddle_tpu_torch``, from just before ``Popen``), ``cuda_context`` (the
CUDA context on the card), ``kernel_library`` (loading the hand-written
kernels' library, built once by the parent), ``model`` (loading the
artifact into a ``Predictor``), ``warmup`` and ``first_request``. Every
child also scrapes its own ``/metrics`` and cross-checks
``paddle_compile_cache_{hits,misses}_total`` against
``compile_cache.stats()`` and against the split its mode expects
(cold: misses and no hits; warm: hits and no misses); ``consistent`` is
the AND over all trials.

    python -m paddle_tpu_torch.tools.bench_coldstart [--trials 5]
        [--model ernie_base|mlp] [--device cuda|cpu] [--json]

It runs on the card unless ``--device cpu`` is given (the tests use
``--device cpu --model mlp``); the default model is the float32 ERNIE-base
classifier that ``chip_smoke.py``'s inference phase serves, with its
server's buckets. Exits 1 when a trial's accounting is inconsistent.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PHASES = ("imports", "cuda_context", "kernel_library", "model", "warmup",
          "first_request")
# the inference phase's server: batch buckets up to 16, three sequence
# buckets (chip_smoke.py SERVER_MAX_BATCH, SERVER_BUCKETS)
MODELS = {"ernie_base": {"max_batch": 16, "seq_buckets": "128,256,512",
                         "seq": 200},
          "mlp": {"max_batch": 4, "seq_buckets": "", "seq": 0}}


# --------------------------------------------------------------- child
def _scrape_compile_cache(port):
    """paddle_compile_cache_{hits,misses}_total summed over sites, from
    the live /metrics page."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    text = opener.open(f"http://127.0.0.1:{port}/metrics",
                       timeout=10).read().decode()
    out = {"hits": 0, "misses": 0}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        for kind in out:
            if line.startswith(f"paddle_compile_cache_{kind}_total"):
                out[kind] += int(float(line.rsplit(None, 1)[-1]))
    return out


def run_child(args):
    # FLAGS_compile_cache_dir arrives through the environment (flags read
    # it at definition), so the cache is live from the first import
    import numpy as np

    import paddle_tpu_torch  # noqa: F401  (the framework's start counts)
    from paddle_tpu_torch import compile_cache, inference, serving
    from paddle_tpu_torch.observability.runtime import startup_split
    cuda = args.device == "cuda"
    split = startup_split(cuda, start=args.t0)
    t3 = time.time()
    cfg = inference.Config(args.prefix)
    if not cuda:
        cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    seq_buckets = [int(s) for s in args.seq_buckets.split(",") if s]
    srv = serving.InferenceServer(
        pred, max_batch_size=args.max_batch, name="coldstart",
        seq_buckets=seq_buckets or None, start=False, pipeline_depth=0,
        telemetry_port=0)
    t4 = time.time()
    split["model"] = round(t4 - t3, 4)
    manifest = srv.warmup_manifest
    if manifest is not None and len(manifest):
        mode, warmed = "warm", srv.warmup_from_manifest()
    else:
        # nothing recorded yet: a cold start warms the whole lattice
        mode, warmed = "cold", srv.warmup()
    srv.start()
    t5 = time.time()
    split["warmup"] = round(t5 - t4, 4)
    rng = np.random.RandomState(0)

    def one_feed():
        if args.model == "mlp":
            return rng.randn(1, 64).astype("float32")
        return rng.randint(1, 1000, (1, args.seq)).astype("int64")

    srv.submit([one_feed()]).result(timeout=600)
    t6 = time.time()
    split["first_request"] = round(t6 - t5, 4)
    first_response_s = t6 - args.t0
    # a short burst, so the manifest holds the lattice traffic lands on
    # (rows 1 and the 4-row bucket)
    for f in srv.submit_many([[one_feed()] for _ in range(3)]):
        f.result(timeout=600)
    stats = compile_cache.stats()
    scraped = _scrape_compile_cache(srv.telemetry.port)
    expected = {"cold": stats["misses"] > 0 and stats["hits"] == 0,
                "warm": stats["hits"] > 0 and stats["misses"] == 0}[mode]
    consistent = (scraped["hits"] == stats["hits"]
                  and scraped["misses"] == stats["misses"] and expected)
    print(json.dumps({
        "mode": mode, "first_response_s": round(first_response_s, 4),
        "warmed": warmed, "split_s": split,
        "accounting": {"hits": stats["hits"], "misses": stats["misses"]},
        "scraped": scraped, "consistent": consistent}))
    srv.shutdown()
    from paddle_tpu_torch.observability import stop_telemetry_server
    stop_telemetry_server()
    return 0


# -------------------------------------------------------------- parent
def _save_model(prefix, model, device):
    import torch

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    if model == "mlp":
        torch.manual_seed(0)
        net = torch.nn.Sequential(
            torch.nn.Linear(64, 256), torch.nn.Tanh(),
            torch.nn.Linear(256, 256), torch.nn.Tanh(),
            torch.nn.Linear(256, 16)).eval()
        spec = [InputSpec([None, 64], "float32", "x")]
    else:
        from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                             ernie_base)
        cfg = ernie_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        net = ErnieForSequenceClassification(cfg, num_classes=2,
                                             device=device, seed=0).eval()
        spec = [InputSpec([None, None], "int64", "input_ids")]
    jit.save(net, prefix, input_spec=spec)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _trial(prefix, cache_dir, args, shape):
    env = dict(os.environ, FLAGS_compile_cache_dir=cache_dir,
               FLAGS_serving_telemetry_port="-1")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.bench_coldstart",
         "--child", "--prefix", prefix, "--t0", repr(t0),
         "--device", args.device, "--model", args.model,
         "--max-batch", str(shape["max_batch"]),
         "--seq-buckets", shape["seq_buckets"], "--seq", str(shape["seq"])],
        capture_output=True, text=True, env=env, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"child failed:\n{r.stdout}\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _medians(results):
    return {p: statistics.median(r["split_s"][p] for r in results)
            for p in PHASES}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5,
                    help="trials a side (medians reported)")
    ap.add_argument("--model", default="ernie_base", choices=sorted(MODELS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    ap.add_argument("--json", action="store_true",
                    help="only the final JSON line")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--prefix", help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--max-batch", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--seq-buckets", default="", help=argparse.SUPPRESS)
    ap.add_argument("--seq", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_child(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("bench_coldstart: no CUDA device is available (pass "
                  "--device cpu to run on the CPU)", file=sys.stderr)
            return 2
        # built once here, so every child only loads it
        from paddle_tpu_torch.ops import _build
        _build.load_library()
    shape = MODELS[args.model]
    tmp = tempfile.mkdtemp(prefix="coldstart-")
    prefix = os.path.join(tmp, "model")
    cache_dir = os.path.join(tmp, "cache")
    log = (lambda *_: None) if args.json else \
        (lambda msg: print(msg, file=sys.stderr))
    try:
        log(f"# saving {args.model} ...")
        _save_model(prefix, args.model, args.device)
        trials = max(1, args.trials)
        runs = {"cold": [], "warm": []}
        consistent = True
        for side in ("cold", "warm"):
            for i in range(trials):
                if side == "cold":
                    shutil.rmtree(cache_dir, ignore_errors=True)
                # the LAST cold run's cache and manifest seed the warm
                # side: the restart-after-serving scenario
                res = _trial(prefix, cache_dir, args, shape)
                if res["mode"] != side:
                    raise RuntimeError(f"a {side} trial ran {res}")
                consistent &= bool(res["consistent"])
                runs[side].append(res)
                log(f"# {side}[{i}]: {res['first_response_s']:.3f} s "
                    f"{res['accounting']} {res['split_s']}")
        cold = statistics.median(r["first_response_s"] for r in runs["cold"])
        warm = statistics.median(r["first_response_s"] for r in runs["warm"])
        print(json.dumps({
            "metric": "serving_coldstart_speedup",
            "value": round(cold / warm, 4) if warm else 0.0, "unit": "x",
            "model": args.model, "device": args.device,
            "card": _card() if args.device == "cuda" else None,
            "cold_median_s": round(cold, 4),
            "warm_median_s": round(warm, 4),
            "cold_s": [r["first_response_s"] for r in runs["cold"]],
            "warm_s": [r["first_response_s"] for r in runs["warm"]],
            "split_median_s": {s: _medians(runs[s]) for s in runs},
            "warmed": {s: [r["warmed"] for r in runs[s]] for s in runs},
            "trials": trials, "metrics_consistent": consistent}))
        return 0 if consistent else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
