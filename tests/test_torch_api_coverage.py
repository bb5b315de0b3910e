"""How much of the JAX package's Paddle surface the port offers.

For ``paddle_tpu``, ``paddle_tpu.tensor``, ``paddle_tpu.nn``,
``paddle_tpu.nn.functional``, ``paddle_tpu.amp``, ``paddle_tpu.optimizer``
and ``paddle_tpu.linalg`` (``tests/fixtures/api_golden.json``'s
``surfaces``) it prints how many names the port's counterpart has; a name
that raises ``NotImplementedError`` and the reference's helper names do not
count. It fails when a name of its own list of covered names goes missing.
"""
import json
from pathlib import Path

import pytest

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "api_golden.json"
# the reference's module-level helpers that its surfaces list: JAX
# internals, imports, aliases of its submodules and the submodule names
HELPERS = {"jax", "jnp", "np", "annotations", "apply_op", "unwrap",
           "flag_value", "current_jax_device", "slice_builtin", "dtype_mod",
           "einsum_mod", "random_mod", "creation", "linalg", "logic",
           "manipulation", "math", "random", "search", "stat"}
# the top-level names this slice ports beside the tensor surface
TOP = {"Tensor", "Parameter", "to_tensor", "grad", "no_grad", "enable_grad",
       "set_grad_enabled", "is_grad_enabled", "dtype", "bool", "bool8",
       "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
       "float32", "float64", "complex64", "complex128", "get_default_dtype",
       "set_default_dtype", "Place", "CPUPlace", "CUDAPlace",
       "CUDAPinnedPlace", "TPUPlace", "XPUPlace", "NPUPlace", "set_device",
       "get_device", "device_count", "is_compiled_with_cuda",
       "is_compiled_with_rocm", "is_compiled_with_tpu",
       "is_compiled_with_xpu", "synchronize", "seed", "get_rng_state",
       "set_rng_state", "get_flags", "set_flags", "ParamAttr", "save",
       "load", "in_dynamic_mode", "amp", "io", "jit", "inference", "nn",
       "optimizer", "profiler", "static", "vision", "distributed", "tensor",
       "framework", "core", "L1Decay", "L2Decay", "regularizer",
       "DataParallel", "LazyGuard", "Model", "autograd", "batch", "callbacks",
       "check_shape", "device", "disable_signal_handler", "disable_static",
       "enable_static", "finfo", "iinfo", "flags_snapshot", "flops",
       "summary", "hapi", "metric", "get_cuda_rng_state",
       "set_cuda_rng_state", "set_printoptions", "incubate", "linalg",
       "elastic", "compile_cache", "observability", "serving"}
# every name of the reference's paddle.amp and paddle.optimizer
AMP = {"AmpScaler", "GradScaler", "amp_guard", "auto_cast", "decorate",
       "grad_scaler"}
OPTIMIZER = {"Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "Lamb",
             "LarsMomentum", "LarsMomentumOptimizer", "Momentum", "Optimizer",
             "RMSProp", "SGD", "lr", "optimizer"}
# every name of the reference's paddle.linalg
LINALG = {"bincount", "bmm", "cholesky", "cholesky_solve", "cond",
          "corrcoef", "cov", "cross", "det", "dist", "dot", "eig", "eigh",
          "eigvals", "eigvalsh", "histogram", "householder_product", "inv",
          "lstsq", "lu", "lu_unpack", "matmul", "matrix_exp", "matrix_norm",
          "matrix_power", "matrix_rank", "mm", "multi_dot", "mv", "norm",
          "ormqr", "pca_lowrank", "pinv", "qr", "slogdet", "solve", "svd",
          "svd_lowrank", "t", "transpose_last2", "triangular_solve",
          "vector_norm"}
# every name of the reference's paddle.nn and paddle.nn.functional (helpers
# excluded)
NN = {"AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
      "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
      "AlphaDropout", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BCELoss",
      "BCEWithLogitsLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
      "BatchNorm3D", "BeamSearchDecoder", "BiRNN", "Bilinear", "CELU",
      "CTCLoss", "ChannelShuffle", "ClipGradByGlobalNorm", "ClipGradByNorm",
      "ClipGradByValue", "Conv1D", "Conv1DTranspose", "Conv2D",
      "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "CosineEmbeddingLoss",
      "CosineSimilarity", "CrossEntropyLoss", "Dropout", "Dropout2D",
      "Dropout3D", "ELU", "Embedding", "F", "Flatten", "Fold", "GELU", "GLU",
      "GRU", "GRUCell", "GroupNorm", "HSigmoidLoss", "Hardshrink",
      "Hardsigmoid", "Hardswish", "Hardtanh", "HingeEmbeddingLoss", "Identity",
      "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "KLDivLoss",
      "L1Loss", "LSTM", "LSTMCell", "Layer", "LayerDict", "LayerList",
      "LayerNorm", "LeakyReLU", "Linear", "LocalResponseNorm", "LogSigmoid",
      "LogSoftmax", "MSELoss", "MarginRankingLoss", "MaxPool1D", "MaxPool2D",
      "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "Maxout",
      "Mish", "MultiHeadAttention", "MultiLabelSoftMarginLoss",
      "MultiMarginLoss", "NLLLoss", "PReLU", "Pad1D", "Pad2D", "Pad3D",
      "PairwiseDistance", "ParamAttr", "ParameterList", "PixelShuffle",
      "PixelUnshuffle", "RNN", "RNNCellBase", "RNNTLoss", "RReLU", "ReLU",
      "ReLU6", "SELU", "Sequential", "Sigmoid", "Silu", "SimpleRNN",
      "SimpleRNNCell", "SmoothL1Loss", "SoftMarginLoss", "Softmax",
      "Softmax2D", "Softplus", "Softshrink", "Softsign", "SpectralNorm",
      "Swish", "SyncBatchNorm", "Tanh", "Tanhshrink", "ThresholdedReLU",
      "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
      "TransformerEncoder", "TransformerEncoderLayer", "TripletMarginLoss",
      "TripletMarginWithDistanceLoss", "Unfold", "Upsample",
      "UpsamplingBilinear2D", "UpsamplingNearest2D", "ZeroPad2D", "clip",
      "create_parameter_with_attr", "decode", "dynamic_decode", "functional",
      "initializer", "initializer_utils", "layer", "utils", "utils_helpers"}
NN_F = {"Tensor", "activation", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
        "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
        "adaptive_max_pool3d", "affine_grid", "alpha_dropout", "attention",
        "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm", "bilinear",
        "binary_cross_entropy", "binary_cross_entropy_with_logits", "celu",
        "channel_shuffle", "class_center_sample", "common", "conv", "conv1d",
        "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
        "conv3d_transpose", "cosine_embedding_loss", "cosine_similarity",
        "cross_entropy", "ctc_loss", "diag_embed", "dice_loss", "dropout",
        "dropout2d", "dropout3d", "elu", "elu_", "embedding",
        "flash_attention", "fold", "gather_tree", "gelu", "glu", "grid_sample",
        "group_norm", "gumbel_softmax", "hardshrink", "hardsigmoid",
        "hardswish", "hardtanh", "hinge_embedding_loss", "hsigmoid_loss",
        "huber_loss", "instance_norm", "interpolate", "kl_div", "l1_loss",
        "label_smooth", "layer_norm", "leaky_relu", "linear",
        "local_response_norm", "log_loss", "log_sigmoid", "log_softmax",
        "loss", "margin_cross_entropy", "margin_ranking_loss", "max_pool1d",
        "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
        "max_unpool3d", "maxout", "mish", "mse_loss",
        "multi_label_soft_margin_loss", "multi_margin_loss", "nll_loss",
        "norm", "normalize", "npair_loss", "one_hot", "pad",
        "pairwise_distance", "pixel_shuffle", "pixel_unshuffle", "pooling",
        "prelu", "relu", "relu6", "relu_", "rnnt_loss", "rrelu",
        "scaled_dot_product_attention", "selu", "sequence_mask", "sigmoid",
        "sigmoid_focal_loss", "silu", "smooth_l1_loss", "soft_margin_loss",
        "softmax", "softmax_", "softmax_with_cross_entropy", "softplus",
        "softshrink", "softsign", "sparse_attention", "spectral_norm",
        "square_error_cost", "swish", "tanh", "tanh_", "tanhshrink",
        "temporal_shift", "thresholded_relu", "triplet_margin_loss",
        "triplet_margin_with_distance_loss", "unfold", "upsample", "zeropad2d"}
# the operations plane's and the serving fleet's surfaces (ROADMAP queue 1
# item 5b): the names the port offers; every other name of these modules
# raises naming its item
OBS = {"BurnRule", "Counter", "DEFAULT_MS_BUCKETS", "Gauge", "Histogram",
       "LatencySLO", "MetricRegistry", "PROMETHEUS_CONTENT_TYPE",
       "PercentileWindow", "SLOMonitor", "Span", "SpanBuffer", "StepProfiler",
       "TelemetryServer", "TraceContext", "add_alert_sink",
       "add_health_check", "add_readiness_check", "current_context",
       "default_buffer", "default_monitor", "default_profiler",
       "default_registry", "export_chrome_trace", "exposition",
       "get_telemetry_server", "healthz", "httpd", "json_snapshot",
       "json_text", "latency_slo", "new_context", "parse_traceparent",
       "prometheus_text", "readyz", "record_exemplar", "record_span",
       "record_step", "registry", "remove_alert_sink", "remove_health_check",
       "remove_readiness_check", "request_context", "sanitize_metric_name",
       "set_default_monitor", "set_default_profiler", "slo", "sloz_payload",
       "start_span", "start_telemetry_server", "stepprof",
       "stop_telemetry_server", "tracez_payload", "tracing", "use_context",
       "goodput", "GoodputLedger", "default_ledger", "set_default_ledger",
       "goodput_report", "goodputz_payload", "training",
       "TrainingTelemetryCallback", "instrument_optimizers",
       "uninstrument_optimizers",
       # the runtime and numerics plane (ROADMAP queue 1 item 11)
       "runtime", "install_jax_monitoring",
       "install_device_memory_collector", "mirror_profiler_spans",
       "install_build_info", "xstats", "ExecEntry", "ExecRegistry",
       "ProfileRing", "default_exec_registry", "default_profile_ring",
       "register_executable", "device_peaks", "execz_payload",
       "profilez_payload", "capture_profile", "numerics", "CanaryRunner",
       "note_serving_logits", "note_shadow_divergence",
       "numericsz_payload", "run_device_canary"}
TRACING = {"Span", "SpanBuffer", "TraceContext", "chrome_trace_events",
           "clear_exemplars", "current_context", "default_buffer",
           "exemplars", "export_chrome_trace", "group_traces",
           "merge_span_dicts", "new_context", "parse_traceparent",
           "process_name", "promote", "record_exemplar", "record_span",
           "request_context", "sample_decision", "set_default_buffer",
           "set_process_name", "start_span", "tracez_payload", "use_context"}
SCHED = {"AdmissionController", "AutoscaleMetrics", "DEFAULT_TENANT",
         "FleetAutoscaler", "PRIORITY_CLASSES", "SchedMetrics",
         "SchedulerPolicy", "TenantPolicy", "TokenBucket",
         "WeightedFairQueue", "merge_schedz_payloads", "normalize_tenant",
         "priority_rank", "register_autoscaler", "register_controller",
         "schedz_payload"}
# every name of the reference's serving.fleet
FLEET = {"CircuitBreaker", "Deadline", "FleetMetrics", "FleetRouter",
         "NoReadyReplicaError", "PredictorBackend", "ProcessReplicaFactory",
         "ReplicaApp", "ReplicaError", "ReplicaSupervisor",
         "ReplicaWedgedError", "RouterApp", "StubBackend",
         "SubprocessReplica", "ThreadReplicaFactory", "WedgeMonitor",
         "WedgeWatchdog", "arm_canary", "arm_wedge_watchdog", "codec",
         "merge_prometheus_texts", "resilience"}
# every name of the reference's elastic (ROADMAP item 5b part 2)
ELASTIC = {"AsyncCheckpointHandle", "CheckpointCorruptError",
           "CheckpointManager", "DEFAULT_PREEMPT_SIGNALS", "PreemptionHandler",
           "RestoreResult", "latest_checkpoint", "list_checkpoints",
           "load_sharded", "prune_checkpoints", "save_sharded"}
# every name of the reference's compile_cache (ROADMAP item 5a)
COMPILE_CACHE = {"CacheStore", "CompileCache", "WarmupManifest",
                 "avals_signature", "bytes_fingerprint", "cache_key",
                 "compile_relevant_flags", "default_cache",
                 "environment_fingerprint", "fingerprint",
                 "function_fingerprint", "layer_fingerprint",
                 "mark_compile_relevant", "mesh_fingerprint",
                 "reset_default_cache", "stats"}
GENERATION = {"CachedDecoder", "DecodeMetrics", "GenerationServer",
              "PagedKVCache", "PrefixCache", "StreamingFuture",
              "accept_tokens", "engines_statusz", "sample_next_tokens",
              "supports_cached_decode"}
PLANE = {"paddle_tpu.observability": OBS,
         "paddle_tpu.observability.tracing": TRACING,
         "paddle_tpu.serving.scheduling": SCHED,
         "paddle_tpu.serving.generation": GENERATION,
         "paddle_tpu.serving.fleet": FLEET,
         "paddle_tpu.elastic": ELASTIC,
         "paddle_tpu.compile_cache": COMPILE_CACHE}
# the multi-device surfaces (ROADMAP queue 1 item 5c, part 1): the names the
# port offers; what waits for part 2 raises naming it
DIST = {"DataParallel", "Group", "ParallelEnv", "ParallelMode", "ReduceOp",
        "all_gather", "all_gather_object", "all_reduce", "all_to_all",
        "all_to_all_single", "alltoall", "alltoall_single", "apply_sharding",
        "barrier", "broadcast", "broadcast_object_list", "build_mesh",
        "collective", "communication", "constrain", "constrain_batch",
        "constrain_seq", "destroy_process_group", "env", "fleet", "gather",
        "get_backend", "get_global_mesh", "get_group", "get_rank",
        "get_world_size", "gloo_barrier", "gloo_init_parallel_env",
        "gloo_release", "group", "init_parallel_env", "io", "irecv",
        "is_available", "is_initialized", "isend", "launch", "mesh_utils",
        "new_group", "parallel", "recv", "reduce", "reduce_scatter",
        "scatter", "scatter_object_list", "send", "set_global_mesh",
        "shard", "shard_params", "shard_tensor_data", "spawn", "spec_tree",
        "spec_tree_hash", "split", "stream", "wait", "with_constraint"}
DIST_FLEET = {"CommunicateTopology", "DistributedStrategy", "Fleet",
              "HybridCommunicateGroup", "PaddleCloudRoleMaker",
              "UserDefinedRoleMaker", "barrier_worker", "distributed_model",
              "distributed_optimizer", "distributed_strategy", "fleet_api",
              "get_hybrid_communicate_group", "init", "is_first_worker",
              "is_initialized", "meta_parallel", "save_inference_model",
              "save_persistables", "topology", "utils", "worker_index",
              "worker_num"}
SERVING = {"BucketSpec", "DeadlineExceededError", "DynamicBatcher",
           "InferenceServer", "QueueFullError", "QuotaExceededError",
           "Request", "ServerClosedError", "ServingMesh", "ServingMetrics",
           "ShapeBucketPolicy", "fleet", "generation", "metrics",
           "next_pow2", "scheduling", "serving_mesh_from_flags"}
MULTI = {"paddle_tpu.distributed": DIST,
         "paddle_tpu.distributed.fleet": DIST_FLEET,
         "paddle_tpu.serving": SERVING}
PORTS = {"paddle_tpu": "paddle_tpu_torch",
         "paddle_tpu.tensor": "paddle_tpu_torch.tensor",
         "paddle_tpu.nn": "paddle_tpu_torch.nn",
         "paddle_tpu.nn.functional": "paddle_tpu_torch.nn.functional",
         "paddle_tpu.amp": "paddle_tpu_torch.amp",
         "paddle_tpu.optimizer": "paddle_tpu_torch.optimizer",
         "paddle_tpu.linalg": "paddle_tpu_torch.linalg",
         **{name: name.replace("paddle_tpu", "paddle_tpu_torch", 1)
            for name in PLANE},
         "paddle_tpu.distributed": "paddle_tpu_torch.distributed",
         "paddle_tpu.distributed.fleet": "paddle_tpu_torch.distributed.fleet",
         "paddle_tpu.serving": "paddle_tpu_torch.serving"}
# the modules the port offers whole
WHOLE = {"paddle_tpu.nn": NN, "paddle_tpu.nn.functional": NN_F,
         "paddle_tpu.amp": AMP, "paddle_tpu.optimizer": OPTIMIZER,
         "paddle_tpu.linalg": LINALG}


def _offered(module, name) -> bool:
    """Present, and not a stub: the port leaves a name it does not port
    absent, or makes it raise ``NotImplementedError`` when used (a
    class's constructor, a function's call), which would not count; such
    stubs carry ``__not_ported__``."""
    obj = getattr(module, name, None)
    if obj is None and not hasattr(module, name):
        return False
    return not getattr(obj, "__not_ported__", False)


def _surface(ref_name):
    import importlib
    names = json.loads(GOLDEN.read_text())["surfaces"][ref_name]
    names = [n for n in names if n not in HELPERS]
    port = importlib.import_module(PORTS[ref_name])
    have = [n for n in names if _offered(port, n)]
    return names, have, port


@pytest.mark.parametrize("ref_name", sorted(PORTS))
def test_surface_coverage(ref_name):
    names, have, port = _surface(ref_name)
    print(f"{ref_name}: the port has {len(have)} of {len(names)} names "
          f"(helpers excluded); missing: "
          f"{sorted(set(names) - set(have))}")
    if ref_name in WHOLE:
        # the whole surface: every name of the reference's module
        assert set(names) == WHOLE[ref_name]
    if ref_name == "paddle_tpu":
        assert len(have) >= 421
    if ref_name == "paddle_tpu.observability":
        assert (len(have), len(names)) == (87, 87)
    if ref_name == "paddle_tpu.elastic":
        assert (len(have), len(names)) == (11, 11)
    if ref_name == "paddle_tpu.compile_cache":
        assert (len(have), len(names)) == (16, 16)
    if ref_name == "paddle_tpu.distributed":
        assert (len(have), len(names)) == (62, 76)
    if ref_name == "paddle_tpu.distributed.fleet":
        assert (len(have), len(names)) == (22, 29)
    if ref_name == "paddle_tpu.serving":
        assert (len(have), len(names)) == (17, 18)
    if ref_name == "paddle_tpu.tensor":
        # every op of paddle.tensor, also at the top level, as there
        assert len(have) >= 300
        import paddle_tpu_torch
        assert all(_offered(paddle_tpu_torch, n) for n in have)
        covered = set(have)
    else:
        covered = {"paddle_tpu": TOP, **WHOLE, **PLANE, **MULTI}[ref_name]
    lost = sorted(n for n in covered if not _offered(port, n))
    assert not lost, f"{ref_name}: covered names went missing: {lost}"


@pytest.mark.parametrize("ref_name", sorted(PLANE))
def test_missing_names_raise_with_their_item(ref_name):
    """Every name of an operations-plane surface that the port does not
    offer is a stand-in that raises NotImplementedError naming its ROADMAP
    queue 1 item, when called or when an attribute is read."""
    names, have, port = _surface(ref_name)
    assert set(have) == PLANE[ref_name]
    for n in sorted(set(names) - set(have)):
        obj = getattr(port, n)
        assert obj.__not_ported__, n
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
            obj()
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
            obj.anything

