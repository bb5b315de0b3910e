#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]
        [--phases card,build,kernels,tiny,model,engine,serving,train,stacked,
                  recipe,families,inference,api,nn,hapi,ops,fleet,elastic,
                  runtime]

Phases, each failing loudly (exit code 1, no result line):

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the hand-written kernels from ``paddle_tpu_torch/csrc``.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving and training shapes (the paged kernels over bf16,
              float32 and int8 pools, at the window and decode kernels'
              tile edges and with pages of 128 slots; the backward kernels
              also launched twice and compared bit for bit), with its median
              device time (CUDA events
              around calls queued behind a device-side sleep), its host
              launch overhead, the
              plain version's time, the least time the card could take
              (bytes over 3.35 TB/s or operations over the peak rate of
              their type, whichever is larger) and, where one PyTorch call
              computes the same function, that call's time (the flash
              kernels also at the long-context shape, B=2 S=8192, and in
              float16 at the training, serving and long shapes, with a
              float16 cotangent that overflowed, whose inf and NaN must
              reach every gradient). float32 rows also print the bound at
              the float FMA rate (fma_bound_ms) and, where a redesign
              replaced a kernel, its time before in the row's log line
              (ms_before, PERF.md's figure, not measured in the run). With
              ``--parent DIR`` the paged rows, the timed float32 flash
              forward rows and the float32 backward rows at the training
              and BERT shapes also time DIR's kernels (another tree's csrc,
              e.g. the parent commit's) in turns with this tree's: parent,
              this, this, parent. The float32 backward rows cover a causal
              edge at D=64, a K/V length other than Q's, an lse cotangent,
              rows off 16-byte alignment and a NaN made on the card in dO
              (NaN exactly where the plain version has it); the training
              row also prints the kernels' and the plain version's
              distance from a float64 backward (ref64_err); each backward
              kernel is timed alone through its C entry point, by CUDA
              events, on the operands the wrapper hands it (torch.profiler
              only names the kernels a call ran). The forward is also
              timed at Sq != Sk, full attention (cached decode steps, one
              query against 128 and 512 keys, and a cross-attention of 128
              queries over 512, at the nn phase's widths, bf16) beside
              SDPA and its bound. The paged
              rows in float32 (the decode and window kernels over float and
              int8 pools, at the bf16 rows' shapes and edges) are launched
              twice and compared bit for bit, and a NaN made on the card in
              a key must be NaN in exactly the plain version's rows. The
              build phase prints every kernel's registers and spills and
              fails if a float32 backward kernel or a float32 paged kernel
              spills.
4. tiny     — gpt_tiny (head_dim 16, which no kernel takes) decodes and
              trains a step on the card through the default path: the
              callers route every attention to the plain versions
              (plain_calls rise, launches stay 0), and the logits and loss
              match the use_kernels=False run.
5. model    — GPT-3 1.3B in bf16 from a seeded generator: one cached
              prefill and teacher-forced decode steps, once through the
              kernels and once through their plain versions; the same
              weights in float32 hold the two paths together tightly and
              give the bf16 rounding floor, against which the bf16 kernel
              path is held; then the same over int8 pools, with a chunked
              suffix and a verify window in the sequence; a profile of
              decode steps shows where the step's time goes.
6. engine   — GenerationServer over the same model serving 16 requests;
              the serving kernels' launch counts are read around this run.
7. serving  — the reference's default engine on the same model: prefix
              cache on, int8 KV pools, self-speculation (the model drafts
              for itself, spec_k=4); 16 requests sharing a 1024-token
              system prompt in two waves, so the second wave's admissions
              hit the first's pages; launch counts by kind and pool type
              read around this run, and a profile of one speculative
              iteration (k draft decode steps and the verify window).
              Greedy acceptance of the bf16 model and of a float32 copy
              over their own and int8 pools, each run's paged launches by
              kernel held against the decoders' calls, with its wall time
              and iteration ms; then one profiled float32 decode step and
              one verify window over float and int8 pools (the paged
              kernels' device ms against the step's, the busy share).
8. train    — GPT-3 1.3B training through TrainStep (AdamW with bf16
              moments, AMP O2, b=2, s=2048): the full model, 2 warm-up
              steps and a timed run_steps(10) around which the forward and
              backward kernels' launch counts are read; tokens/s, MFU, peak
              memory and a profile of one step with the device's busy
              share; then a parity run at full width and 4 layers (float32
              kernels against plain versions on gradients, losses and
              parameters; bf16 O2 against the plain path's rounding
              floor).
9. stacked  — the layer-stacked decoder (gpt3_1p3b(stacked=True)) with the
              engine model's weights: cached prefill, decode, chunked and
              verify windows over stacked bf16 and int8 pools against the
              per-layer model, and GenerationServer runs on stacked pools
              with the prefix cache on; a 4-layer float32 parity under
              every recompute policy against the per-layer model (kernels
              and plain versions; "none" and "full" bit for bit; O2 against
              the plain path's floor); then the north-star training run
              under each policy ("full", "attn", "dots", "none") at b=2,
              s=2048 and the long-context row (recompute "full",
              max_seq_len=8192, b=2, s=8192), each with its launches per
              step against the policy's expected count.
10. recipe  — training as the reference's users run it: gpt3_1p3b in
              float16 (O2) with GradScaler() at its defaults on the float16
              flash kernels (launches a step, skipped steps, final scale);
              a 4-layer float16 parity against the plain path's rounding
              floor and a forced overflow (init scale 2^40) that must skip
              its steps with parameters and moments bit for bit unchanged
              and halve the scale, on both paths; dropout 0.1 at full
              width through the reference's dense attention (no flash
              launch; one seed bit for bit, another different; each
              site's kept fraction within 5 sigma of 0.9); the north star
              fed by io.DataLoader (2 workers, the shared-memory ring)
              against the same-batch run; and a 4-layer run stopped,
              saved (model, optimizer, scaler, generator), rebuilt, loaded
              and resumed, bit for bit against an uninterrupted one.
11. families — bench.py's other configurations through
              paddle_tpu_torch.bench's own functions (short windows):
              GPT-2 small, medium and large at bench.py's batch and length
              (launches a step: L or 2L forward, L dq and dk/dv, no plain
              call; the counted FLOPs agree with the hand formula);
              BERT-base MLM+NSP at b=32 s=512 on the bidirectional flash
              kernels (12 launches of each a step, no plain or dense call,
              a profile of one step), a 4-layer parity (float32 kernels
              against plain versions; O2 against the plain path's floor),
              a padding mask (the dense path, 12 calls a step, no flash
              launch) and dropout 0.1 with recompute (one seed bit for bit;
              recompute's gradients against stored activations'); ERNIE
              base fine-tuning with task types and a padding mask, and
              ernie_3_0_10b's forward in bf16 at full width and depth (48
              flash launches, finite outputs); ResNet-50 at b=128, 224²,
              NHWC, O2 (its BatchNorm statistics move), and a resnet18
              step on the card against the same step on the CPU (its
              update, float32 with a TF32 control, and float64).
              The kernels phase times the three flash kernels at these
              configurations' shapes (bidirectional D=64 and D=128, causal
              D=64).
12. inference — single-model inference as the reference's README shows
              it: ERNIE-base (12 layers, hidden 768, 12 heads of 64, dropout
              0, weights from --seed) saved with jit.save (torch.export,
              batch and sequence dynamic) in float32, in bf16 after
              amp.decorate, and from a CPU copy; a fresh process loads each
              through inference.Predictor, runs b=8 s=128 (12 flash launches
              a forward, no plain call; float32 within 1e-4 x std of the
              eager plain path, bf16 within 1.5x the bf16 plain path's
              distance from it) and times Predictor.run (p50/p99, QPS,
              device ms); ResNet-50 b=8 224 through the Predictor against
              the eager model. Then InferenceServer (max batch 16, buckets
              128/256/512, pipeline depth 2) over each precision: warmup,
              512 single-row requests of 16-512 tokens from 4 client
              threads (12 flash launches a batch, fewer batches than
              requests, responses in order, each within the limits of
              Predictor.run and of the eager plain path on that request
              alone, padded to its bucket) and a profiled window of 128
              more (the device's busy share). The kernels phase holds the
              flash forward against its plain version, and times it, at
              these shapes in float32 and in bf16: B=8 S=128 and B=16 at
              S=128, 256, 512.
13. api     — the Paddle-shaped API (``import paddle_tpu_torch as paddle``):
              the Paddle-style GPT script of
              tests/test_torch_paddle_script.py (loaded by path; nn.Layer,
              Embedding, LayerList, LayerNorm, Linear, GELU,
              F.scaled_dot_product_attention, a tied LM head through
              paddle.matmul, F.cross_entropy, AdamW with
              ClipGradByGlobalNorm, paddle.save) at GPT-2 small's full
              width and depth (hidden 768, 12 heads of 64, vocab 50304, 12
              layers), B=8, S=1024, three steps from one set of weights:
              float32 through the kernels against the plain route (the
              train phase's limits on losses, every step's gradients and
              the parameters), bf16 O2 (amp.decorate + auto_cast) against
              the plain O2 path's rounding floor, 12 launches a step of
              each flash kernel and no plain call in each precision, step
              4 after a resume from the paddle.save files (a fresh model
              and optimizer) bit for bit; ms a step, a profiled step of
              each precision (the busy share), the host µs of paddle.add,
              paddle.matmul and a Linear against torch's (on the card and
              on the CPU), and the flash kernels at this shape beside SDPA
              and their bound.
14. nn      — the rest of paddle.nn: the Paddle-style text classifier of
              tests/test_torch_paddle_encoder_script.py (loaded by path;
              token and position Embedding, LayerNorm,
              nn.TransformerEncoder of TransformerEncoderLayer(768, 12,
              3072, dropout=0.1, activation="gelu", attn_dropout=0.0), a
              pooler, a classifier with ParamAttr(regularizer=L2Decay),
              CrossEntropyLoss(label_smoothing=0.1), AdamW with
              ClipGradByGlobalNorm) at BERT-base's widths (12 layers, vocab
              30528, 512 positions), B=32, S=512, three steps from one set
              of weights: float32 through the kernels against the plain
              route (the same dropout masks from the same seed; the train
              phase's limits, the key projections' biases by Adam's
              bound and the parameters outside a band of 1e-3 of each
              tensor's largest gradient; step 1's distance of each route
              from a float64 run, the kernels' query projections within
              1.5x the plain route's), bf16 O2 against the plain O2 path's
              rounding floor,
              12 launches a step of each flash kernel, no plain and no
              dense call in each precision; one evaluation forward under a
              bool padding mask [B, 1, 1, S] on the dense route (12 dense
              calls, no launch) against the plain route and the unmasked
              flash forward; ms a step and a profiled step of each
              precision (the busy share); the flash kernels at this shape
              beside SDPA and their bound. Then the sweep: every layer
              class the slice ported (convolutions, pools, norms,
              paddings, the common layers, losses, RNNs and cells, the
              transformer layers) and the functionals without a layer,
              built at a small size with the same weights on the card and
              on the CPU, forward and backward in float32 with TF32 off,
              each held to 1e-5 of its largest value (1e-4 where the card
              sums in another order over longer chains); a cached greedy
              decode through TransformerDecoder.gen_cache at head_dim 64,
              whose flash launches at Sq != Sk are each held against the
              plain version, against the plain route and the CPU; beam
              search over an LSTMCell, card against CPU. The worst error
              per layer is printed on a line of its own.
15. hapi    — paddle.Model (tests/test_torch_api_hapi.py, loaded by path):
              the nn phase's classifier at the same widths and shape in
              paddle.Model, prepared with Lamb (a linear warm-up, no
              decay on biases and norms), CrossEntropyLoss and Accuracy;
              fit for one epoch of 6 batches with 2 evaluation batches and
              the LRScheduler, ModelCheckpoint and EarlyStopping callbacks,
              evaluate and predict, through the kernels and the plain
              route in float32 (the train phase's limits on the losses
              and the last step's gradients, the parameters within 1e-6
              outside the noise band and LAMB's bound, 2 lr trust a step,
              inside it) and under amp_configs="O2" (the rounding floor);
              12 launches of each flash kernel a training step and 12
              forward launches an evaluation step, no plain and no dense
              call; the logged accuracy against the steps' logits;
              Model.save then load into a fresh model, predict bit for
              bit; ms a step and the busy share of each precision. Then
              the optimizer sweep: each new optimizer three steps on a
              small net, card against CPU.
16. ops     — the serving operations plane: GenerationServer over
              gpt3_1p3b (bf16 pools, the prefix cache on) with
              telemetry_port=0 and a two-tenant AdmissionController: 6
              "bulk" streams (priority batch, 1024-token prompts, 256 new
              tokens, a quota that refuses a 7th with QuotaExceededError)
              fill all but 16 pages, fewer than one "rt" reservation, so 3
              "rt" streams (realtime, 256 + 64) park a bulk stream, which
              resumes from its full history (chunked prefill on the window
              kernel over the prompt pages still cached). Head sampling at 1.0; over HTTP on 127.0.0.1 while
              it runs, /metrics (text, which must parse, and JSON),
              /healthz, /readyz, /statusz (the engine's section with
              tenant_queue_depth), /schedz (both tenants), /tracez, /sloz
              and (since the elastic slice) /goodputz answer 200, and
              (since the runtime slice) /execz, /profilez and /numericsz
              200 with their bodies' keys. Every stream ends with its max_new_tokens; the parked
              count of /metrics equals the engine's; every request's trace
              holds its queue, prefill and decode_step spans; the stepprof
              decode envelopes equal the engine's decode steps; launches
              by kernel equal 24 x the decoder's calls (decode, window,
              flash for cold prefills), no plain call; /readyz reads 503
              while a shutdown drains, the leak check is clean after it.
              TTFT of the rt streams against the bulk wave's; the decode
              step's ms with telemetry and sampling on against off (fresh
              engines in turns off, on, on, off) and a profiled window of
              decode steps (device ms, busy share): since the compile-cache
              slice the profiled run is one torch.profiler session opened
              while its engine is idle, whose prefills must name
              flash_fwd_wgmma_kernel and whose window (a span on the
              calling thread) the paged decode and combine kernels; one
              try, a blind profile fails. Then
              InferenceServer
              over ERNIE-base saved by jit.save in float32 under two
              tenants (64 requests of 16-512 tokens each, telemetry on):
              typed quota refusals, 12 flash launches a batch and no plain
              call, an exemplar on paddle_serving_latency_ms whose trace is
              in /tracez, every output within 1e-4 x std of Predictor.run
              on the request alone.
17. fleet   — the serving fleet (float32, the reference's default serving
              precision). Leg A: two thread replicas
              (ReplicaSupervisor(ThreadReplicaFactory), the single-process
              mode), each a PredictorBackend over ERNIE-base saved by
              jit.save with gpt3_1p3b at 12 of its 24 layers since the
              runtime slice (one model object, an engine and 1,025 pages
              each) for generation, behind RouterApp; from 4
              clients over HTTP, 16 greedy /generate streams (prompts of
              64-1024 tokens, half sharing a 128-token preamble, 64 new
              tokens) and 128 /submit_many requests of 16-512 tokens. Each
              stream token for token the same model's GenerationServer on
              that prompt alone (where one parts, the top-2 logit margin
              there within 1e-4 x std); both replicas served streams;
              responses within 1e-4 x std of Predictor.run alone; flash
              launches = 12 x the decoders' prefills + 12 x the predictor
              batches, paged launches by kernel = 12 x the decoders' decode
              and chunked calls, 0 plain calls; /metrics?merged=1 with the
              engines' families under replica="0" and "1"; one stream's
              /tracez?trace_id= with the router's span and the engine's
              queue, prefill and decode_step spans; /statusz 2 ready;
              /execz, /numericsz, /profilez 200 with the merged bodies'
              keys; leak checks
              clean. Leg B: worker processes (ProcessReplicaFactory, the
              port's worker) under FleetAutoscaler (1-2 replicas), sharing
              one FLAGS_compile_cache_dir and one --name (so one manifest
              for each program): the first worker warms the whole
              lattice (--warmup lattice; every signature a compile-cache
              miss) and its traffic writes the fleet's manifest, every
              later spawn starts with --warmup manifest and reports ready
              only after its replay: its /readyz startup shows 0 misses and
              one hit a manifest signature; a burst of 256 requests scales
              out and the second worker takes traffic; swap_weights to a second version under
              traffic (0 failures, every response its version's
              Predictor.run within 1e-4 x std); a SIGKILL mid-batch (only
              in-flight requests fail, typed; respawned, 2 ready again);
              quiet scales in (the decision log and /schedz); each worker
              that exits cleanly dumps its counters (a sitecustomize.py on
              its PYTHONPATH): 12 flash launches a batch of its /metrics, 0
              plain calls; at the end the first worker's compile-cache
              misses are its lattice's (the swap's replacement replayed the
              manifest) and the relaunch's 0; the wedge drill on a --stub
              worker (/readyz reads wedged, the request behind the poison a
              typed 503, respawned). Printed with no limit: QPS and p50/p99
              through the router against one in-process InferenceServer,
              spawn to ready, the swap, kill to ready, the streams' TTFT,
              each worker's start-up split (imports, CUDA context, kernel
              library, model, warmup).
18. elastic — elastic training (paddle_tpu_torch.elastic, the goodput
              ledger, the training telemetry). Leg A: gpt3_1p3b (stacked,
              recompute "full", full width, 6 of its 24 layers since
              the runtime slice, to keep the smoke in its time) trains 11
              steps at
              b=2 s=2048, bf16 O2, AdamW with float32 moments under a
              LinearWarmup schedule, batches from the port's generator,
              under CheckpointManager (async saves every 4 steps, keep=1);
              a fresh model, optimizer and schedule from another seed (the
              generator reseeded) restores step 8's checkpoint and runs
              steps 9-11: losses, parameters and AdamW moments bit for bit,
              12/6/6 flash forward/dq/dk-dv launches a step and 0 plain
              calls, the goodput identity (ckpt_save, ckpt_restore and
              recovery above 0), 2 saves, last committed step 8, 3 steps
              lost. Checkpoints go to the temporary directory (TMPDIR),
              which must hold two, else the phase fails; it is printed. Leg
              B: python -m paddle_tpu_torch.tools.faultinject over
              elastic_ckpt_worker --model gpt --layers 4 (12 steps, saves
              every 3, keep=2): an uninterrupted run, then a SIGKILL
              mid-step, mid-save and mid-commit and a SIGTERM in the middle
              of a step, each relaunched; every loss bitwise the
              uninterrupted run's, the final digests equal, steps lost
              within 2x the interval, the SIGTERM's final save committed at
              the next step boundary, 8/4/4 launches a step in each
              completed worker and 0 plain calls; the workers share one
              compile cache (FLAGS_compile_cache_dir in the drill's
              environment, which every worker inherits): each
              relaunch's TrainStep hits for its batch signature (0 misses)
              and each worker's start-up split to its first step is
              printed. Leg C: the hapi phase's
              float32 encoder under LAMB through Model.fit with
              ElasticCheckpoint (every 4 steps) and
              TrainingTelemetryCallback, the optimizers instrumented:
              /goodputz over HTTP answers 200 and closes, the training and
              LAMB step counters equal the steps, a second fit on a fresh
              model resumes at the last save with the first fit's
              parameters at that step bit for bit, the float32 kernels
              launch 12 a step with 0 plain calls. Printed with no limit,
              beside the card's name and power limit: checkpoint bytes,
              each save's synchronous half and writer seconds, restore
              seconds, step ms with and without a save in flight, the
              goodput fractions, kills survived, steps lost per kill, the
              median restore ms, spawn to first step and the SIGTERM's
              wait for the step boundary and final save.
19. runtime — the runtime and numerics plane (observability/{runtime,
              xstats,numerics}.py). Leg A: gpt3_1p3b in bf16. A direct gate
              first: one decode, one chunked and one verify call of a
              CachedDecoder (bf16, then int8 pools), each from the same
              cloned pools with the shadow off, on, and through a decoder
              on the plain versions: the shadow leaves logits, pools
              (bytes), tables and the generators bit for bit, runs 24 plain
              calls, and publishes paddle_numerics_shadow_divergence equal
              to the float to the max|kernel - plain| computed here; the
              decode step's ms with the plane off, the tripwires only, and
              both. Then GenerationServer (prefix cache, self-speculation at
              spec_k=4) with FLAGS_numerics_shadow_rate and
              FLAGS_numerics_sample_rate at 1.0 over bf16 and over int8
              pools: 8 requests of 64-512 prompt tokens, 32 new tokens, the
              last sharing the first's 256-token system prompt (a chunked
              call): paged launches by kind 24 x the decoders' calls, plain
              calls 24 x the shadowed calls, every tripwire finite, no
              anomaly, /numericsz with the decode, chunked and verify
              sections (the int8 scale drift over int8 pools), clean leak
              checks. Over bf16 pools the compile cache is on (an empty
              directory): every record stored is one miss and the warmup
              manifest holds exactly the traffic's signatures; a second
              engine on the same model replays the manifest
              (warmup_from_manifest) and serves the same requests: no
              miss, no xstats entry created after the replay, the streams
              bit for bit the first engine's, paddle_compile_cache_*_total
              on /metrics equal to compile_cache.stats(), the stored
              decode record's FLOPs equal to the phase's own measurement
              of that signature; printed: both engines' first-token
              seconds, the replay's seconds, the host ms of the skipped
              measurements. The fault: the shadow off, FLAGS_profile_on_anomaly
              on, NaN written into one page of one live request's K pool:
              the first decode that reads it records one non-finite anomaly
              of kind decode, promoted into /tracez; exactly one capture in
              /profilez; the other streams are a clean run's token for
              token. Leg B: gpt3_1p3b(stacked=True, recompute="full") at
              b=2 s=2048, bf16 O2, AdamW, FLAGS_check_nan_inf on, 4 steps:
              the grad norm published one step late within 1e-3 of the
              phase's vector_norm of the step's gradients, finite fraction
              1.0, 48/24/24 launches a step and 0 plain calls, /execz's
              train_step FLOPs per token within 15% of 6N + 12LHS or
              8N + 24LHS, paddle_mfu{kind="train"} in (0, 1); step ms with
              and without the tripwires; a 4-layer float16 run under
              GradScaler whose forced overflow the tripwire classes as the
              reference does (non-finite gradients, finite loss, the halved
              scale). Leg C: /profilez?duration_ms=500 on another thread
              during leg B's steps names the three training kernels, a
              second capture inside the rate limit answers 429; the
              device-memory gauge equals torch.cuda.memory_allocated(),
              paddle_build_info carries the card and the kernel library's
              hash, goodput's compile category is above 0; /execz lists
              every site. Leg D: run_device_canary() equals its golden twin;
              two thread replicas of float32 ERNIE-base behind the router
              sweep their canary every 0.5 s; one replica's checksum is
              corrupted (a patch of this phase): its /readyz answers 503 and
              its breaker opens, 32 requests all go to the other with 0
              failures, and the merged /execz, /numericsz and /profilez
              answer 200 with both replicas.
  mesh        multi-device, part 1, on one card. Leg A: gpt3_1p3b bf16 at
              full depth served tensor-parallel over 2 and 4 slots of the
              card (distributed.mesh_utils.build_mesh with repeated
              devices): the model phase's plan (prefill, 8 decodes over
              bf16 pools; 4 decodes, a 40-token chunk, a 5-token verify
              and 2 decodes over int8 pools) through CachedDecoder(mesh=),
              the tokens forced from the unsharded run: each step's logits
              within 1.5x the bf16 plain path's distance from float32,
              every pool shard its own contiguous [pages, 16, heads/mp,
              128], flash launches layers x mp a prefill, paged launches
              at least layers x mp a decode step, 0 plain calls; a float32
              copy (full width, 4 layers) at mp=2: the unsharded decoder's
              greedy tokens over 32 steps, logits within 1e-4 x std;
              GenerationServer(mesh=) at mp=2 with self-speculation over 8
              requests sharing a prefix, twice: equal streams, clean leak
              checks, a prefix hit, /statusz bytes a slot, another mesh
              fingerprint than the unsharded engine's. Printed: decode
              step and prefill ms at mp 1/2/4, first token. Leg B: two
              ranks by python -m paddle_tpu_torch.distributed.launch
              (tools/dp_worker.py; gloo, both on the card): every
              collective once on CUDA tensors against numpy, gpt3_1p3b's
              width at 2 layers (a cut of this new path for the smoke's
              time), bf16 O2, AdamW, 3 steps of DataParallel on halves of
              a b=4 s=2048 batch: parameters bit for bit equal across the
              ranks after each step, the averaged gradient at the initial
              weights within 1.5x the bf16 plain path's distance from
              float32, the flash kernels launched in each rank, 0 plain
              calls, launcher exit 0 and no child left.

The fleet phase's worker processes and the elastic drill's workers are
forked from a server that imported torch (and the parts of it the workers
import) once (``framework/forkserver.py``); every spawn, kill and relaunch
of those drills is as before.

Outside the default run, ``--phases card,build,opsprobe`` probes the
profiler: for each setting of the engine's telemetry (head sampling rate
0 or 1, the telemetry endpoint off or on), fresh processes each open one
torch.profiler session while a gpt3_1p3b engine is idle and then several
while its worker thread decodes, and report the sessions that named none
of the paged kernels.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of ``paddle_tpu``.

A fatal signal (a segmentation fault in native code) prints every
thread's Python stack to standard error (``faulthandler``). After the last
line the script stops the telemetry endpoint, waits for the profile
captures, synchronises the card and leaves through ``os._exit``: the
interpreter's teardown (the CUDA and CUPTI libraries' static destructors
beside the daemon threads of the HTTP servers) is not run once the result
is out. The live threads and child processes at that point are logged.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
# float32 work on tensor cores is three TF32 products a product (3xTF32, the
# float32 flash forward's arithmetic), so its peak is the TF32 rate over 3
# (two over int8 pools in the paged rows, which count their work so);
# float32 rows also print the bound at the 67 TFLOP/s of float FMAs
# (fma_bound_ms), the bound of the FMA kernel that came before.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
              "torch.float32": 495e12 / 3}
FMA_FLOPS_F32 = 67e12

ALL_PHASES = ("card", "build", "kernels", "tiny", "model", "engine",
              "serving", "train", "stacked", "recipe", "families",
              "inference", "api", "nn", "hapi", "ops", "fleet", "elastic",
              "runtime", "mesh")

# bf16 kernels against their plain versions: max |kernel - plain| over a
# row / rms(plain row) (row_err), set from the readings of the sound
# kernels (NVIDIA H100 80GB HBM3, 700 W) with a margin of about 1.5x.
# Rounding the output costs up to 2^-8 of an element, a few times the row's
# rms at its largest elements: the paged kernel read at most 0.0215. The
# flash kernel also rounds its probabilities to bf16 for the second
# product: against a plain version that did not, it read at most 0.0349
# (that rounding alone read 0.0331). The plain version now rounds them as
# the kernel does, so the flash readings sit well under this limit.
BF16_ROW_LIMIT = {"flash_fwd": 0.05, "paged_attention": 0.03}
# float16 flash forward, by the same rule: its first readings (NVIDIA H100
# 80GB HBM3, 700 W), against a plain version that did not round the
# probabilities, were 0.0032 to 0.0043 over seven cases (that rounding
# alone: 0.0032 to 0.0043; float16 keeps 3 more bits than bf16)
F16_ROW_LIMIT = 0.0065

# model logits, max |a - b| / std(b) per step: the float32 model's kernel
# and plain paths; the bf16 kernel path's distance from the float32 model
# against the bf16 plain path's own (its rounding floor)
F32_MODEL_LIMIT = 1e-4
BF16_FLOOR_FACTOR = 1.5
# Over int8 pools the float32 paths, run apart, differ by more: each path
# quantizes the K/V it computed, and a float32 difference of ~1e-7 that
# straddles a rounding boundary of the int8 grid moves that element by a
# whole step (1/127 of its row's absmax), in every later step that reads
# it. Read (NVIDIA H100 80GB HBM3, 700 W): 1.35e-5 at the prefill, then
# 1.5e-4 to 2.7e-4, growing with the steps; this sanity limit is about 3.7x
# that. F32_MODEL_LIMIT holds the same steps run in lockstep, both paths
# reading the same int8 pools (_lockstep_f32: copying the kernel path's
# pools to the plain path before each step still read 1.8e-4 at the
# 40-token chunked step, whose tokens attend to their own fresh, separately
# quantized K/V), and every paged call inside the kernel runs is also
# computed by the plain version on the same q and pools (INNER_*).
F32_INT8_MODEL_LIMIT = 1e-3
INNER_F32_TOL = 2e-5


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``: the timed calls are all
    enqueued behind a device-side sleep, so the GPU runs them back to back
    and the CUDA events around each one see kernel time, not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    # hold the stream while the host enqueues (sleep counted in cycles of
    # a clock of at most 2 GHz, with a 2x margin over the host's time)
    torch.cuda._sleep(int(min(4.0, 2.0 * one_s * iters + 0.005) * 2e9))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn`` (launch overhead: Python, checks,
    enqueue), averaged over back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()) \
        if a.numel() else 0.0


def row_err(got, want) -> float:
    """max over rows of max|got - want| / rms(want row), a row being the
    last dimension (one head of one position). Attention outputs shrink
    as the context grows (about sqrt(e / n) for unit-normal inputs), so
    an absolute tolerance says little about long rows; this measure scales
    each row by its own size. Rows that are zero in ``want`` (dead rows)
    must be exactly zero in ``got``."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt()
    live = rms > 0
    require(bool((g[~live] == 0).all()), "dead rows are not zero")
    if not bool(live.any()):
        return 0.0
    return float(((g - w).abs().amax(-1)[live] / rms[live]).max())


def check_close(name, got, want, dtype, row_limit) -> tuple:
    """The stated tolerances: atol/rtol 2e-5 in float32, 2e-2 in bf16;
    bf16 also holds each row at ``row_limit`` of its own rms. Returns
    (max abs err, row-scaled err)."""
    import torch
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = max_abs_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    require(bool(torch.isfinite(got.float()).all()),
            f"{name}: non-finite output")
    require(ok, f"{name}: max abs err {err:.3e} beyond atol/rtol {tol}")
    rel = row_err(got, want)
    if dtype in (torch.bfloat16, torch.float16):
        require(rel <= row_limit,
                f"{name}: row-scaled err {rel:.4f} beyond {row_limit}")
    return err, rel


# ------------------------------------------------------------- phases
def phase_card(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stdout}")
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"card: {state['smi']}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def phase_build(state):
    from paddle_tpu_torch.observability import goodput, runtime
    from paddle_tpu_torch.ops import _build
    # the process's goodput ledger accounts the run from here, and the
    # compile-event listener is live: the build (the port's one run-time
    # compile) is its `compile` seconds and one paddle_jax_events_total
    goodput.default_ledger().start()
    runtime.install_jax_monitoring()
    t0 = time.perf_counter()
    _build.load_library()
    state["build_s"] = time.perf_counter() - t0
    log(f"build: {state['build_s']:.1f} s (nvcc {_build.build_seconds():.1f}"
        f" s)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(_build.build_log())
    # every entry function's registers and spills, and ptxas' performance
    # warnings (C75xx, e.g. C7512: wgmma serialized for want of registers)
    for line in _build.build_log().splitlines():
        if any(s in line for s in ("registers", "spill", "Compiling entry",
                                   "(C75")):
            log(f"  ptxas: {line.strip()}")
    # the float32 backward kernels (3xTF32 on mma.sync) must not spill
    kernels = _ptxas_kernels(_build.build_log())
    state["ptxas_f32_bwd"] = {name: kernels[name] for name in kernels
                              if "dq_tf32" in name or "dkv_tf32" in name}
    if not _build.build_log():
        log("build: the library was built before this process; no ptxas "
            "lines to read")
        return
    require(len(state["ptxas_f32_bwd"]) == 4,
            f"build: expected dq_tf32_kernel and dkv_tf32_kernel at D 64 and "
            f"128 in ptxas' log, found {sorted(state['ptxas_f32_bwd'])}")
    # the float32-query paged kernels: the 3xTF32 window kernel (float and
    # int8 pools, D 64 and 128, 64-row and split blocks) and the decode and
    # combine kernels' float instantiations
    state["ptxas_f32_paged"] = {
        name: kernels[name] for name in kernels
        if "window_f32_kernel" in name or (
            ("paged_attention_decode_kernel" in name
             or "paged_attention_combine_kernel" in name)
            and name.split("_kernel", 1)[1].startswith("If"))}
    require(len(state["ptxas_f32_paged"]) == 14,
            f"build: expected 8 float32 window, 4 float32 decode and 2 "
            f"float32 combine instantiations in ptxas' log, found "
            f"{sorted(state['ptxas_f32_paged'])}")
    for name, info in {**state["ptxas_f32_bwd"],
                       **state["ptxas_f32_paged"]}.items():
        log(f"build: {name}: {info['registers']} registers, spill stores "
            f"{info['spill_stores']} B, spill loads {info['spill_loads']} B")
        require(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                f"build: {name} spills ({info})")


def _template_args(s: str) -> str:
    """The mangled template-argument list at the start of ``s``
    (``I...E``), or "": literals ``L<type><value>E``, named types
    ``<length><name>`` and one-letter builtin types."""
    if not s.startswith("I"):
        return ""
    i = 1
    while i < len(s) and s[i] != "E":
        if s[i] == "L":
            i = s.index("E", i) + 1
        elif s[i].isdigit():
            j = i
            while s[j].isdigit():
                j += 1
            i = j + int(s[i:j])
        else:
            i += 1
    return s[:i + 1]


def _kernel_name(mangled: str) -> str:
    """A kernel's identifier and template arguments from its mangled name,
    e.g. ``dq_tf32_kernelILi64EE`` or
    ``paged_attention_window_f32_kernelIfLi128ELi4EE`` (each identifier in
    it follows its length in digits)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            n = int(digits[i:])
            ident = mangled[m.end():m.end() + n]
            if n and ident.endswith("_kernel") and ident.isidentifier():
                return ident + _template_args(mangled[m.end() + n:])
    return mangled


def _ptxas_kernels(build_log: str) -> dict:
    """ptxas' -v lines per entry function: {name: {registers, spill_stores,
    spill_loads}} (the name as :func:`_kernel_name` gives it)."""
    import re
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {"registers": None, "spill_stores": None,
                         "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# times of the kernels a redesign replaced (PERF.md's kernel table, rows 1
# and 1f; NVIDIA H100 80GB HBM3, 700 W), printed in the row's log line
# beside this run's, never in the kernels line (not this run's numbers): the
# bf16 forward's mma.sync kernel and the float32 forward's FMA kernel (the
# D=128 float32 row read with --parent on the FMA kernel's tree)
FLASH_MS_BEFORE = {
    "flash_fwd B=8 S=2048 H=16 D=128 bfloat16 causal": 2.147,
    "flash_fwd B=8 S=128 H=12 D=64 float32 full": 0.0343,
    "flash_fwd B=16 S=128 H=12 D=64 float32 full": 0.0462,
    "flash_fwd B=16 S=256 H=12 D=64 float32 full": 0.1621,
    "flash_fwd B=16 S=512 H=12 D=64 float32 full": 0.6000,
    "flash_fwd B=8 S=2048 H=16 D=128 float32 causal": 9.261}


def _flash_case(b, s, h, d, dtype, causal, seed, report=False,
                separate=False, scale=None, unaligned=False, parent=None,
                ref64=False, sk=None):
    """The forward kernel against ``mha_fwd_reference``; q/k/v as strided
    views of one [B, S, H, 3, D] tensor, as the GPT layer hands them to the
    prefill, or (``separate``) as three contiguous tensors, or
    (``unaligned``, float32 only) as views one element into their storage,
    so no row is 16-byte aligned; ``scale`` defaults to 1/sqrt(D). With
    ``report`` and the ``parent`` tree's forward (``--parent``), both are
    timed in turns (parent, this tree, this tree, parent). ``ref64``
    (float32) also reports the kernel's and the plain version's distance
    from float64 attention (no gate reads it). ``sk`` (full attention
    only): s queries against k/v of that length, as views of one
    [B, Sk, H, 2, D] tensor beside q, as a cached decode step or a
    cross-attention hands them."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_attention as ca
    g = torch.Generator(device="cuda").manual_seed(seed)
    if sk is not None:
        require(not causal, "Sq != Sk rows are full attention")
        q = torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
        k, v = torch.randn(b, sk, h, 2, d, device="cuda",
                           generator=g).to(dtype).unbind(3)
    elif separate:
        q, k, v = (torch.randn(b, s, h, d, device="cuda",
                               generator=g).to(dtype) for _ in range(3))
    elif unaligned:
        n = b * s * h * d
        q, k, v = (torch.randn(n + 1, device="cuda", generator=g).to(
            dtype)[1:].view(b, s, h, d) for _ in range(3))
    else:
        qkv = torch.randn(b, s, h, 3, d, device="cuda", generator=g).to(
            dtype)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    custom_scale = scale is not None
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out, lse = ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = ca.mha_fwd_reference(q, k, v, causal=causal, scale=scale)
    name = (f"flash_fwd B={b} S={s}{f' Sk={sk}' if sk else ''} H={h} D={d} "
            f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            f"{' separate q/k/v' if separate else ''}"
            f"{' unaligned' if unaligned else ''}"
            f"{f' scale={scale:g}' if custom_scale else ''}")
    err, rel = check_close(name, out, ref, dtype,
                           F16_ROW_LIMIT if dtype == torch.float16
                           else BF16_ROW_LIMIT["flash_fwd"])
    lerr = max_abs_err(lse, ref_lse)
    require(lerr <= 1e-3, f"{name}: lse max abs err {lerr:.3e}")
    elt = torch.empty((), dtype=dtype).element_size()
    kv_len = s if sk is None else sk
    pairs = s * (s + 1) // 2 if causal else s * kv_len
    # q and out, k and v once each, and lse
    nbytes = (2 * s + 2 * kv_len) * b * h * d * elt + b * h * s * 4
    flops = 4.0 * d * b * h * pairs
    bms, by = bound_ms(nbytes, flops, dtype)
    row = {"case": name, "max_abs_err": err, "row_err": rel,
           "lse_err": lerr, "bound_ms": bms, "bound_by": by}
    if dtype == torch.float32:
        row["fma_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                  flops / FMA_FLOPS_F32) * 1e3
    if ref64:
        out64, lse64 = _mha_f64(q, k, v, causal, scale)
        row.update({"ref64_err": max_abs_err(out, out64),
                    "plain_ref64_err": max_abs_err(ref, out64),
                    "lse_ref64_err": max_abs_err(lse, lse64),
                    "plain_lse_ref64_err": max_abs_err(ref_lse, lse64)})
        del out64, lse64
    if report:
        def kern():
            ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        if parent is not None:
            def old():
                parent(q, k, v, causal=causal, scale=scale)
            got, got_lse = parent(q, k, v, causal=causal, scale=scale)
            row["parent_max_abs_err"] = max_abs_err(got, ref)
            row["parent_lse_err"] = max_abs_err(got_lse, ref_lse)
            p1, c1, c2, p2 = (device_ms(f) for f in (old, kern, kern, old))
            row["ms"], row["ms_turns"], row["parent_ms"] = c1, [c1, c2], \
                [p1, p2]
            row["faster_than_parent"] = max(c1, c2) < min(p1, p2)
        else:
            row["ms"] = device_ms(kern)
        row["host_us"] = host_us(kern)
        row["plain_ms"] = device_ms(lambda: ca.mha_fwd_reference(
            q, k, v, causal=causal, scale=scale), iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["ms_over_bound"] = row["ms"] / bms
        if name in FLASH_MS_BEFORE:
            row["ms_before"] = FLASH_MS_BEFORE[name]
    log("  " + json.dumps(row))
    return row


def _flash_nan_case(d, seed):
    """float32, causal, B=2 S=300 H=8: one key element of one (batch, head)
    set to 0/0 on the card (the card's NaN, 0x7fffffff). The kernel's out
    and lse must be NaN in exactly the entries where the plain version's
    are (the rows at or after that key, in its batch and head) and agree
    with it elsewhere at atol/rtol 2e-5 (lse 1e-3)."""
    import torch
    from paddle_tpu_torch.ops import cuda_attention as ca
    b, s, h = 2, 300, 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
               for _ in range(3))
    zero = torch.zeros((), device="cuda")
    k[1, 150, 3, 5] = zero / zero
    out, lse = ca.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = ca.mha_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    name = f"flash_fwd B={b} S={s} H={h} D={d} float32 causal NaN key"
    nan = ref.isnan()
    require(bool(nan.any()), f"{name}: the plain version has no NaN")
    require(torch.equal(out.isnan(), nan),
            f"{name}: {int(out.isnan().sum())} NaN outputs, the plain "
            f"version {int(nan.sum())}")
    require(torch.equal(lse.isnan(), ref_lse.isnan()),
            f"{name}: lse NaN rows differ from the plain version's")
    err = max_abs_err(out[~nan], ref[~nan])
    require(torch.allclose(out[~nan], ref[~nan], atol=2e-5, rtol=2e-5),
            f"{name}: max abs err {err:.3e} beyond atol/rtol 2e-5")
    fin = ~ref_lse.isnan()
    lerr = max_abs_err(lse[fin], ref_lse[fin])
    require(lerr <= 1e-3, f"{name}: lse max abs err {lerr:.3e}")
    row = {"case": name,
           "nan_bits": hex(int(k[1, 150, 3, 5].view(torch.int32))
                           & 0xffffffff),
           "nan_rows": int(ref_lse.isnan().sum()), "max_abs_err": err,
           "lse_err": lerr}
    log("  " + json.dumps(row))
    return row


def _mha_f64(q, k, v, causal, scale):
    """Attention in float64 (out [B, Sq, H, D], lse [B*H, Sq]): the
    yardstick of the float32 rows' own rounding."""
    import torch
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    logits = qd @ kd.transpose(-1, -2) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        logits.masked_fill_(~torch.ones(sq, sk, dtype=torch.bool,
                                        device=q.device).tril(sk - sq),
                            -math.inf)
    lse = torch.logsumexp(logits, -1)
    out = torch.softmax(logits, -1) @ vd
    return out.transpose(1, 2), lse.reshape(-1, logits.shape[-2])


def grad_err(got, want) -> float:
    """``row_err`` for gradients: max over rows of max|got - want| over the
    row's rms, each row's rms floored at the rms of the whole tensor. A row
    of ds sums to zero (sum_k p (dp - delta) = 0), so a query that sees one
    key has a dq row of pure rounding noise; the floor measures such rows
    against the size of the gradient instead of against their own noise."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp(min=float(w.pow(2).mean().sqrt()))
    if not float(rms.max()):
        return max_abs_err(g, w)
    return float(((g - w).abs().amax(-1) / rms).max())


def kernel_device_ms(fn, names, iters: int = 10) -> dict:
    """Device time per call of ``fn`` of the kernels whose names contain
    each of ``names`` (torch.profiler over ``iters`` calls after a
    warm-up): the paged wrapper's split kernels and their combine kernel,
    which events around the call cannot tell apart. A trace that misses a
    kernel's records is taken once more."""
    fn()
    for attempt in range(2):
        rows, _ = _profile_rows(fn, iters)
        out = {n: sum(ms for key, ms, _ in rows if n in key) for n in names}
        if all(v > 0 for v in out.values()):
            break
        log(f"  profiler trace {attempt + 1} saw no device time for some of "
            f"{names}: {out}; kernels in it: {[key for key, _, _ in rows]}")
    require(all(v > 0 for v in out.values()),
            f"profiler saw no device time for {names}: {out}")
    return out


def _bwd_kernel_names(fn) -> list:
    """The backward kernels (dq and dk/dv) that one profiled call of ``fn``
    ran, by name (torch.profiler names them; CUDA events time them)."""
    rows, _ = _profile_rows(fn, 1)
    names = sorted({key for key, _, _ in rows
                    if "dq_" in key or "dkv_" in key})
    require(any("dq_" in n for n in names) and any("dkv_" in n
                                                   for n in names),
            f"the profiler saw no backward kernel: {names}")
    return names


def _bwd_operands(q, k, v, out, lse, do, ct, scale, causal):
    """What the backward wrapper hands the two kernels, made once: ``((q,
    k, v, dO, lse, δ), ck)``, in float32 K and V less their means with the
    lse that keeps p (``ck`` the keys' mean, for dQ's lse-cotangent term,
    else None); float32 rows copied to 16-byte alignment, and 16-bit query
    windows padded to a multiple of 4 rows, as the wrapper does."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    if q.dtype != torch.float32:
        delta = cab._delta(out, do, ct)
        b, sq, h, _ = q.shape
        if sq % 4 and b * h > 1:
            sp = sq + (-sq) % 4
            q, do = cab._pad_rows(q, sp), cab._pad_rows(do, sp)
            lse, delta = (F.pad(x.reshape(b * h, sq), (0, sp - sq))
                          for x in (lse, delta))
            if causal:
                k, v = cab._pad_rows(k, sp), cab._pad_rows(v, sp)
        return (q, k, v, do, lse, delta), None
    k, v, lse, delta, ck = cab._centered(q, k, v, out, lse, do, ct, scale)
    q, k, v, do = (ca._rows_aligned(t) for t in (q, k, v, do))
    return (q, k, v, do, lse, delta), ck


def _bwd_case(b, s, h, d, dtype, causal, seed, lse_ct=False, sk=None,
              unaligned=False, parent=None, ref64=False, name_kernels=False):
    """The backward kernels against ``mha_bwd_reference`` (p and ds rounded
    to the input type, as the kernels and the TPU reference round them) on
    the forward kernel's out and lse, q/k/v as views of one fused
    [B, S, H, 3, D] tensor; with ``sk`` (full attention only) k/v of that
    length as views of one fused [B, Sk, H, 2, D] tensor beside q; with
    ``unaligned`` (float32) q, k, v and dO as views one element into their
    storage, so no row is 16-byte aligned. With ``parent`` (``--parent``,
    float32) the parent tree's two kernels and this tree's are timed in
    turns (parent, this, this, parent) on the same inputs; ``ref64`` also
    reports the kernels' and the plain version's distance from a float64
    backward (no gate reads it). Each kernel is timed alone by CUDA events
    (``flash_bwd_dq_ms``, ``flash_bwd_dkv_ms``); ``name_kernels`` also lists
    the kernels a profiled call of the wrapper ran. Returns the row; the
    limits are checked by :func:`check_bwd`."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    g = torch.Generator(device="cuda").manual_seed(seed)
    if unaligned:
        n = b * s * h * d
        q, k, v = (torch.randn(n + 1, device="cuda", generator=g).to(
            dtype)[1:].view(b, s, h, d) for _ in range(3))
        sk = s
    elif sk is None:
        sk = s
        qkv = torch.randn(b, s, h, 3, d, device="cuda", generator=g).to(
            dtype)
        q, k, v = qkv.unbind(3)
    else:
        q = torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
        kv = torch.randn(b, sk, h, 2, d, device="cuda", generator=g).to(
            dtype)
        k, v = kv.unbind(3)
    if unaligned:
        do = torch.randn(b * s * h * d + 1, device="cuda", generator=g).to(
            dtype)[1:].view(b, s, h, d)
    else:
        do = torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
    ct = (0.1 * torch.randn(b * h, s, device="cuda", generator=g)
          if lse_ct else None)
    scale = 1.0 / math.sqrt(d)
    out, lse = ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    got = cab.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  scale=scale, lse_ct=ct)
    torch.cuda.synchronize()
    want = cab.mha_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                 scale=scale, lse_ct=ct)
    name = (f"flash_bwd B={b} S={s}{f' Sk={sk}' if sk != s else ''} H={h} "
            f"D={d} {str(dtype)[6:]} {'causal' if causal else 'full'}"
            f"{' lse_ct' if lse_ct else ''}{' unaligned' if unaligned else ''}")
    row = {"case": name, "dtype": str(dtype)}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        require(bool(torch.isfinite(x.float()).all()),
                f"{name}: non-finite {gname}")
        row[f"{gname}_max_abs_err"] = max_abs_err(x, y)
        row[f"{gname}_grad_err"] = grad_err(x, y)
        row[f"{gname}_max_abs"] = float(y.float().abs().max())
    again = cab.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                    scale=scale, lse_ct=ct)
    row["repeatable"] = all(bool(torch.equal(x, y))
                            for x, y in zip(got, again))
    if ref64:
        want64 = _mha_bwd_f64(q, k, v, do, causal, scale, ct)
        row["ref64_err"] = max(max_abs_err(x, y)
                               for x, y in zip(got, want64))
        row["plain_ref64_err"] = max(max_abs_err(x, y)
                                     for x, y in zip(want, want64))
        del want64
    elt = torch.empty((), dtype=dtype).element_size()
    pairs = s * (s + 1) // 2 if causal else s * sk
    # q, dO, k, v once each, lse and delta; outputs dq, or dk and dv
    ins = (2 * s + 2 * sk) * b * h * d * elt + 2 * b * h * s * 4
    flops = {}
    for kname, n_prod, out_rows in (("flash_bwd_dq", 3, s),
                                    ("flash_bwd_dkv", 4, 2 * sk)):
        flops[kname] = 2.0 * d * b * h * pairs * n_prod
        bms, by = bound_ms(ins + out_rows * b * h * d * elt, flops[kname],
                           dtype)
        row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = bms, by

    def bwd():
        cab.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                scale=scale, lse_ct=ct)
    # each kernel alone through its C entry point, on the operands the
    # wrapper hands it (made once: δ, and in float32 K and V less their
    # means), timed by CUDA events behind the device-side sleep
    from paddle_tpu_torch.ops import _build
    ops, ck = _bwd_operands(q, k, v, out, lse, do, ct, scale, causal)
    this, _ = _bwd_entries(_build.load_library(), *ops, causal, scale)
    for kname, call in this.items():
        row[f"{kname}_ms"] = device_ms(call)
    # the wrapper's own passes apart: δ alone, and in float32 the centring
    # of K and V with its δ (which replaces δ alone)
    row["delta_only_ms"] = device_ms(lambda: cab._delta(out, do, ct))
    if dtype == torch.float32:
        row["centering_ms"] = device_ms(lambda: cab._centered(
            q, k, v, out, lse, do, ct, scale))
    if name_kernels:
        row["kernels_seen"] = _bwd_kernel_names(bwd)
    if parent is not None:
        # the parent tree's kernels and this tree's in turns
        old, got_old = _bwd_entries(parent, *ops, causal, scale)
        for kname, mine in this.items():
            theirs = old[kname]
            p1, c1, c2, p2 = (device_ms(f) for f in (theirs, mine, mine,
                                                     theirs))
            row[f"{kname}_ms_turns"] = [c1, c2]
            row[f"{kname}_parent_ms"] = [p1, p2]
            row[f"{kname}_faster_than_parent"] = max(c1, c2) < min(p1, p2)
        torch.cuda.synchronize()
        if ck is not None and ct is not None:
            cab._lse_ct_term(got_old[0], ct, ck, scale)
        row["parent_max_abs_err"] = max(max_abs_err(x, y)
                                        for x, y in zip(got_old, want))
    if name in BWD_MS_BEFORE:
        row["ms_before"] = BWD_MS_BEFORE[name]
    for kname in flops:
        row[f"{kname}_tflops"] = flops[kname] / (row[f"{kname}_ms"] * 1e-3) \
            / 1e12
    row["bwd_ms"] = device_ms(bwd)
    # the wrapper's own work beside the kernels: δ, its allocations and, in
    # float32, the centring of K and V
    row["delta_ms"] = row["bwd_ms"] - row["flash_bwd_dq_ms"] - \
        row["flash_bwd_dkv_ms"]
    row["host_us"] = host_us(bwd)
    row["plain_ms"] = device_ms(lambda: cab.mha_bwd_reference(
        q, k, v, out, lse, do, causal=causal, scale=scale, lse_ct=ct),
        iters=5)

    def port_fwd_bwd():
        o, l_ = ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        cab.flash_attention_bwd(q, k, v, o, l_, do, causal=causal,
                                scale=scale)
    row["port_fwd_bwd_ms"] = device_ms(port_fwd_bwd)
    # the library's yardstick: fwd+bwd of scaled_dot_product_attention,
    # and its backward alone
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    # (an unaligned dO is copied for the library: its backward faults on
    # one)
    dot = (do.clone() if unaligned else do).transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           scale=scale)
        torch.autograd.grad(o, (qt, kt, vt), dot)
    row["library_ms"] = device_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           scale=scale)
    row["library_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True))
    log("  " + json.dumps(row))
    return row


def _bwd_entries(lib, q, k, v, do, lse, delta, causal, scale):
    """The two backward kernels of ``lib`` (this tree's library or
    ``--parent``'s, whose C interface is this tree's) as calls of their C
    entry points on these inputs (:func:`_bwd_operands`): ``({kernel
    name: call}, (dq, dk, dv))``,
    the outputs allocated once and written by each call. Each call launches
    one kernel and nothing else, so CUDA events time it alone; the launches
    do not count in the wrapper's ``launches``."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    b, sq, h, d = q.shape
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                  for x in (q, k, v))
    strides = cab._strides(q, k, v, do)
    tail = (b, h, sq, k.shape[1], d, strides, float(scale),
            int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)])
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())

    def dq_call():
        err = lib.pt_flash_bwd_dq(*ins, dq.data_ptr(), *tail,
                                  torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"pt_flash_bwd_dq: CUDA error {err}")

    def dkv_call():
        err = lib.pt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail,
                                   torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"pt_flash_bwd_dkv: CUDA error {err}")
    dq_call()
    dkv_call()
    return {"flash_bwd_dq": dq_call, "flash_bwd_dkv": dkv_call}, (dq, dk, dv)


def _mha_bwd_f64(q, k, v, do, causal, scale, lse_ct=None):
    """The attention backward in float64 from q, k, v and dO ([B, S, H, D];
    with ``lse_ct``, δ less the lse cotangent): the yardstick of the float32
    rows' own rounding. Returns (dq, dk, dv) as [B, S, H, D] float64."""
    import torch
    qd, kd, vd, dod = (x.double().transpose(1, 2) for x in (q, k, v, do))
    logits = qd @ kd.transpose(-1, -2) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        logits.masked_fill_(~torch.ones(sq, sk, dtype=torch.bool,
                                        device=q.device).tril(sk - sq),
                            -math.inf)
    p = torch.softmax(logits, -1)
    del logits
    dp = dod @ vd.transpose(-1, -2)
    delta = (p * dp).sum(-1, keepdim=True)
    if lse_ct is not None:
        delta = delta - lse_ct.double().reshape(delta.shape)
    dv = p.transpose(-1, -2) @ dod
    ds = p * (dp - delta) * scale
    del p, dp
    return ((ds @ kd).transpose(1, 2), (ds.transpose(-1, -2) @ qd).transpose(
        1, 2), dv.transpose(1, 2))


def _bwd_nan_case(d, seed):
    """float32, full attention, B=2 S=300 H=8: one element of dO set to 0/0
    on the card (the card's NaN). The kernels' dq, dk and dv must be NaN in
    exactly the entries where ``mha_bwd_reference``'s are (that query's dq
    row, every dk row of its batch and head, and that dim of every dv row
    there: δ of the row is NaN, and 0 times NaN is NaN) and agree with it
    elsewhere within the float32 limit. Full attention: under a causal mask
    the plain version multiplies the masked p (0) by the NaN too, which
    the kernels, skipping tiles their mask empties, and the reference's
    vjp do not."""
    import torch
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    b, s, h = 2, 300, 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for _ in range(4))
    zero = torch.zeros((), device="cuda")
    do[1, 150, 3, 5] = zero / zero
    out, lse = ca.flash_attention_fwd(q, k, v, causal=False)
    got = cab.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    want = cab.mha_bwd_reference(q, k, v, out, lse, do, causal=False)
    torch.cuda.synchronize()
    name = f"flash_bwd B={b} S={s} H={h} D={d} float32 full NaN in dO"
    row = {"case": name,
           "nan_bits": hex(int(do[1, 150, 3, 5].view(torch.int32))
                           & 0xffffffff)}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        nan = y.isnan()
        require(bool(nan.any()), f"{name}: the plain {gname} has no NaN")
        require(torch.equal(x.isnan(), nan),
                f"{name}: {gname} {int(x.isnan().sum())} NaN, the plain "
                f"version {int(nan.sum())}")
        err = max_abs_err(x[~nan], y[~nan])
        lim = BWD_F32_TOL * (1.0 + float(y[~nan].abs().max()))
        require(err <= lim, f"{name}: {gname} max abs err {err:.3e} beyond "
                            f"{lim:.3e}")
        row[f"{gname}_nan"] = int(nan.sum())
        row[f"{gname}_max_abs_err"] = err
    log("  " + json.dumps(row))
    return row


# the float32 backward pair's times before its redesign (PERF.md rows 2f
# and 3f, the FMA kernels; NVIDIA H100 80GB HBM3, 700 W), printed in the
# row's log line beside this run's, never in the kernels line
BWD_MS_BEFORE = {
    "flash_bwd B=2 S=2048 H=16 D=128 float32 causal": {
        "flash_bwd_dq": 3.1165, "flash_bwd_dkv": 3.2834},
    "flash_bwd B=32 S=512 H=12 D=64 float32 full": {
        "flash_bwd_dq": 1.7118, "flash_bwd_dkv": 2.0621}}


# backward kernels against mha_bwd_reference, set from the first readings
# (NVIDIA H100 80GB HBM3, 700 W) with a margin of about 1.6x: bf16 grad_err
# (see there) read at most 0.0217 over dq, dk and dv (the output rounding
# and the bf16 rounding of p and ds falling on the other side of a tie);
# float32 max |kernel - plain| read at most 9.5e-7 against gradients of up
# to 5.4, held at the forward cases' 2e-5 scaled by the gradient's size
BWD_BF16_GRAD_LIMIT = 0.035
BWD_F32_TOL = 2e-5
# float16, by the same rule: grad_err read 0.0011 to 0.0040 over five cases
# (S=8192 the largest; NVIDIA H100 80GB HBM3, 700 W)
BWD_F16_GRAD_LIMIT = 0.006


def _bwd_overflow_f16(seed) -> dict:
    """float16 with a cotangent that overflowed (entries beyond float16's
    range are inf, as a loss scaled past the range leaves them): the
    kernels let inf and NaN through to every gradient, as the plain version
    and the reference's casts do, so dynamic loss scaling sees the
    overflow and skips the step. Nothing may clamp it."""
    import torch
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = 2, 256, 16, 128
    q, k, v = torch.randn(b, s, h, 3, d, device="cuda",
                          generator=g).half().unbind(3)
    do = (3e4 * torch.randn(b, s, h, d, device="cuda", generator=g)).half()
    scale = 1.0 / math.sqrt(d)
    out, lse = ca.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    got = cab.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                  scale=scale)
    want = cab.mha_bwd_reference(q, k, v, out, lse, do, causal=True,
                                 scale=scale)
    torch.cuda.synchronize()
    row = {"case": f"flash_bwd B={b} S={s} H={h} D={d} float16 causal, dO "
                   f"3e4 x N(0, 1) (inf beyond float16's range)",
           "dO_non_finite": int((~torch.isfinite(do)).sum())}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        row[f"{gname}_non_finite_kernel"] = int((~torch.isfinite(x)).sum())
        row[f"{gname}_non_finite_plain"] = int((~torch.isfinite(y)).sum())
    log("  " + json.dumps(row))
    require(row["dO_non_finite"] > 0, "overflow case: dO is finite")
    for gname in ("dq", "dk", "dv"):
        require(row[f"{gname}_non_finite_kernel"] > 0,
                f"overflow case: the kernels' {gname} is finite: an "
                f"overflow was clamped")
        require(row[f"{gname}_non_finite_plain"] > 0,
                f"overflow case: the plain version's {gname} is finite")
    return row


def check_bwd(row) -> None:
    import torch
    name = row["case"]
    require(row["repeatable"], f"{name}: two launches differ")
    half = {str(torch.bfloat16): BWD_BF16_GRAD_LIMIT,
            str(torch.float16): BWD_F16_GRAD_LIMIT}
    for gname in ("dq", "dk", "dv"):
        if row["dtype"] in half:
            err, lim = row[f"{gname}_grad_err"], half[row["dtype"]]
            require(err <= lim, f"{name}: {gname} grad_err {err:.4f} beyond "
                                f"{lim}")
        else:
            err = row[f"{gname}_max_abs_err"]
            lim = BWD_F32_TOL * (1.0 + row[f"{gname}_max_abs"])
            require(err <= lim, f"{name}: {gname} max abs err {err:.3e} "
                                f"beyond {lim:.3e}")


def _paged_inputs(b, s, h, d, page_size, pages_per_seq, dtype, kind, seed,
                  kv="model", one_long=False, q_offset=False):
    """Pools filled with unit-normal values (the trash page too; ``kv=
    "int8"``: those values quantized into (values, scales) pools), a
    shuffled page table with trash-page tails past each row's context,
    ragged contexts and one dead row. ``one_long`` (decode): the first row
    holds the table's whole capacity and the others are short.
    ``q_offset``: q as a view one element into its storage, so its rows are
    not 16-byte aligned."""
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv_rows
    g = torch.Generator(device="cuda").manual_seed(seed)
    num_pages = 1 + b * pages_per_seq
    shape = (num_pages, page_size, h, d)
    k_pool = torch.randn(shape, device="cuda", generator=g).to(dtype)
    v_pool = torch.randn(shape, device="cuda", generator=g).to(dtype)
    if kv == "int8":
        k_pool, v_pool = (
            tuple(t.reshape(num_pages, page_size, *t.shape[1:]).contiguous()
                  for t in quantize_kv_rows(p.reshape(-1, h, d)))
            for p in (k_pool, v_pool))
    q = torch.randn(b, s, h, 3, d, device="cuda", generator=g).to(dtype)[
        :, :, :, 0]
    if q_offset:
        q = torch.randn(b, s, h, d + 1, device="cuda", generator=g).to(
            dtype)[..., 1:]
    cap = pages_per_seq * page_size
    perm = 1 + torch.randperm(num_pages - 1, device="cuda", generator=g)
    tables = perm.reshape(b, pages_per_seq).to(torch.int32)
    if kind == "decode":
        ctx = torch.linspace(1, cap, b, device="cuda").round().to(
            torch.int32)
        if one_long:
            ctx = torch.linspace(1, min(cap, 200), b,
                                 device="cuda").round().to(torch.int32)
            ctx[0] = cap
        ctx[b // 2] = 0                                  # a dead lane
        valid = (ctx > 0)[:, None].expand(b, s).contiguous()
        positions = (ctx - 1).clamp(min=0)[:, None].expand(b, s).contiguous()
    else:
        start = torch.linspace(3, cap - s, b, device="cuda").round().to(
            torch.int32)
        seg = torch.full((b,), s, dtype=torch.int32, device="cuda")
        seg[1] = max(1, s // 3)
        seg[b // 2] = 0                                  # a dead row
        offs = torch.arange(s, device="cuda", dtype=torch.int32)[None]
        positions = start[:, None] + offs
        valid = offs < seg[:, None]
        ctx = start + seg
    used = (ctx.long() + page_size - 1) // page_size
    cols = torch.arange(pages_per_seq, device="cuda")[None]
    tables = torch.where(cols < used[:, None], tables,
                         torch.zeros_like(tables))       # trash-page tails
    return q, k_pool, v_pool, tables, ctx, valid, positions


def _paged_case(b, s, h, d, page_size, pages_per_seq, dtype, kind, seed,
                report=False, kv="model", one_long=False, q_offset=False,
                parent=None):
    """The paged kernel against ``paged_attention_reference``, launched
    twice (float32 rows must agree bit for bit); with ``report`` its device
    time, host time and the plain version's time, and, given the ``parent``
    tree's kernel (``--parent``), both kernels timed in turns (parent, this
    tree, this tree, parent)."""
    import torch
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    q, kp, vp, tables, ctx, valid, positions = _paged_inputs(
        b, s, h, d, page_size, pages_per_seq, dtype, kind, seed, kv=kv,
        one_long=one_long, q_offset=q_offset)
    scale = 1.0 / math.sqrt(d)
    kw = dict(page_size=page_size, kind=kind, scale=scale)
    out = cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions, **kw)
    again = cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions,
                                **kw)
    torch.cuda.synchronize()
    ref = cpa.paged_attention_reference(q, kp, vp, tables, ctx, valid,
                                        positions, **kw)
    name = (f"paged_attention {kind} B={b} S={s} H={h} D={d} "
            f"page={page_size} {str(dtype)[6:]}"
            + (" int8 pools" if kv == "int8" else "")
            + (" one long row" if one_long else "")
            + (" unaligned q" if q_offset else ""))
    err, rel = check_close(name, out, ref, dtype,
                           BF16_ROW_LIMIT["paged_attention"])
    repeatable = torch.equal(out, again)
    require(repeatable or dtype != torch.float32,
            f"{name}: two launches differ")
    # the live context this call needs: per row of the batch, the longest
    # visible prefix among its window positions
    if kind == "decode":
        n_live = ctx.long()[:, None].expand(b, s)
    else:
        n_live = torch.where(valid, torch.minimum(positions.long() + 1,
                                                  ctx.long()[:, None]),
                             torch.zeros_like(positions, dtype=torch.long))
    n_live = n_live.clamp(min=0)
    elt = torch.empty((), dtype=dtype).element_size()
    kv_tokens = int(n_live.max(dim=1).values.sum())
    # a K or V row of one head: D values in q's type, or D int8 values and
    # their f32 scale
    row_bytes = d + 4 if kv == "int8" else d * elt
    nbytes = (2 * b * s * h * d * elt + 2 * kv_tokens * h * row_bytes
              + tables.numel() * 4 + ctx.numel() * 4 + 8 * b * s)
    flops = 4.0 * d * h * float(n_live.sum())
    # float32 q over int8 pools: two TF32 products a product, not three
    # (an int8 value has no low part), so its peak is the TF32 rate over 2
    f32_int8 = dtype == torch.float32 and kv == "int8"
    bms, by = bound_ms(nbytes, flops * (2 / 3 if f32_int8 else 1), dtype)
    row = {"case": name, "kernel": cpa.kernel_for(kind, dtype, s),
           "max_abs_err": err, "row_err": rel, "repeatable": repeatable,
           "bound_ms": bms, "bound_by": by}
    if dtype == torch.float32:
        # the bound of the FMA kernel that came before
        row["fma_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                  flops / FMA_FLOPS_F32) * 1e3
    if report:
        def kern():
            cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions,
                                **kw)
        if parent is not None:
            def old():
                parent(q, kp, vp, tables, ctx, valid, positions, **kw)
            got = parent(q, kp, vp, tables, ctx, valid, positions, **kw)
            row["parent_max_abs_err"] = max_abs_err(got, ref)
            p1, c1, c2, p2 = (device_ms(f) for f in (old, kern, kern, old))
            row["ms"], row["ms_turns"], row["parent_ms"] = c1, [c1, c2], \
                [p1, p2]
            row["faster_than_parent"] = max(c1, c2) < min(p1, p2)
        else:
            row["ms"] = device_ms(kern)
        # the split kernels' own time and their combine kernel's
        names = (("decode_kernel",) if row["kernel"].startswith(
            "paged_decode_split") else ("window_kernel",)
            if dtype == torch.bfloat16 else ("window_f32_kernel",))
        if kind == "decode" and s == 1 or s <= 16:
            names += ("combine_kernel",)
        row["kernel_ms_by_name"] = kernel_device_ms(kern, names)
        row["host_us"] = host_us(kern)
        row["plain_ms"] = device_ms(lambda: cpa.paged_attention_reference(
            q, kp, vp, tables, ctx, valid, positions, **kw), iters=5)
        row["library_ms"] = None
        row["ms_over_bound"] = row["ms"] / bms
    log("  " + json.dumps(row))
    return row


def _paged_nan_case(kind, s, d, seed):
    """float32 q and pools: one element of one key set to 0/0 on the card
    (the card's NaN, 0x7fffffff), a key that one row sees at every live
    position (decode: the row holding the table's whole context, so its
    parts meet in the combine kernel; chunked: row 0). The kernel's output
    must be NaN in exactly the entries where the plain version's is (that
    row's positions, in the key's head) and agree with it elsewhere at
    atol/rtol 2e-5."""
    import torch
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    b, h, page_size, pps = 8, 16 if d == 128 else 4, 16, 128
    q, kp, vp, tables, ctx, valid, positions = _paged_inputs(
        b, s, h, d, page_size, pps, torch.float32, kind, seed)
    # a token the row sees at every live position: half its context
    r = b - 1 if kind == "decode" else 0
    t = int(ctx[r]) // 2 if kind == "decode" else int(positions[r, 0]) // 2
    slot = int(tables[r, t // page_size]) * page_size + t % page_size
    zero = torch.zeros((), device="cuda")
    kp.view(-1, h, d)[slot, h // 2, d // 3] = zero / zero
    kw = dict(page_size=page_size, kind=kind, scale=1.0 / math.sqrt(d))
    out = cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions, **kw)
    ref = cpa.paged_attention_reference(q, kp, vp, tables, ctx, valid,
                                        positions, **kw)
    torch.cuda.synchronize()
    name = (f"paged_attention {kind} B={b} S={s} H={h} D={d} float32 "
            f"NaN key")
    nan = ref.isnan()
    require(bool(nan.any()), f"{name}: the plain version has no NaN")
    require(torch.equal(out.isnan(), nan),
            f"{name}: {int(out.isnan().sum())} NaN outputs, the plain "
            f"version {int(nan.sum())}")
    err = max_abs_err(out[~nan], ref[~nan])
    require(torch.allclose(out[~nan], ref[~nan], atol=INNER_F32_TOL,
                           rtol=INNER_F32_TOL),
            f"{name}: max abs err {err:.3e} beyond atol/rtol "
            f"{INNER_F32_TOL}")
    row = {"case": name, "kernel": cpa.kernel_for(kind, torch.float32, s),
           "nan_bits": hex(int(kp.view(-1, h, d)[slot, h // 2, d // 3].view(
               torch.int32)) & 0xffffffff),
           "nan_rows": int(nan.any(-1).sum()), "max_abs_err": err}
    log("  " + json.dumps(row))
    return row


def _parent_lib(parent_dir, source):
    """One kernel source of another tree (``--parent DIR``, e.g. the parent
    commit's ``paddle_tpu_torch/csrc`` unpacked with ``git archive``),
    built into a library of its own, for timing in turns with this
    tree's."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    csrc = Path(parent_dir).resolve() / "paddle_tpu_torch" / "csrc"
    require((csrc / source).exists(), f"--parent: no {source} under {csrc}")
    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libparent_{Path(source).stem}.so"
    t0 = time.perf_counter()
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                 str(csrc), str(csrc / source), "-o", str(so)])
    log(f"kernels: parent tree's {source} ({csrc}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    return ctypes.CDLL(str(so))


def _parent_flash(parent_dir):
    """The parent tree's flash forward (``pt_flash_fwd``, whose C interface
    is this tree's), as a callable with the wrapper's signature."""
    import ctypes
    import torch
    from paddle_tpu_torch.ops import _build
    fn = _parent_lib(parent_dir, "flash_fwd.cu").pt_flash_fwd
    fn.argtypes = _build._SIGNATURES["pt_flash_fwd"]
    fn.restype = ctypes.c_int

    def call(q, k, v, *, causal, scale):
        b, sq, h, d = q.shape
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, sq, k.shape[1], d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], float(scale),
                 int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"parent flash forward: CUDA error {err}")
        return out, lse
    return call


def _parent_flash_bwd(parent_dir):
    """The parent tree's backward pair (``pt_flash_bwd_dq`` and
    ``pt_flash_bwd_dkv``, whose C interfaces are this tree's), as a library
    with its entry points bound."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    lib = _parent_lib(parent_dir, "flash_bwd.cu")
    for name in ("pt_flash_bwd_dq", "pt_flash_bwd_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _parent_paged(parent_dir):
    """The parent tree's paged kernel (``pt_paged_attention`` and its
    workspace query, whose C interfaces are this tree's), as a callable
    with the wrapper's signature."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.paged_attention import is_quantized_pool
    lib = _parent_lib(parent_dir, "paged_attention.cu")
    fn, floats = lib.pt_paged_attention, lib.pt_paged_workspace_floats
    fn.argtypes = _build._SIGNATURES["pt_paged_attention"]
    floats.argtypes, floats.restype = \
        _build._RESTYPES["pt_paged_workspace_floats"]
    codes = _build.DTYPE_CODES
    kinds = {"decode": 0, "chunked": 1}

    def call(q, kp, vp, tables, ctx, valid, positions, *, page_size, kind,
             scale):
        kv, ks = (kp[0], kp[1]) if is_quantized_pool(kp) else (kp, None)
        vv, vs = (vp[0], vp[1]) if is_quantized_pool(vp) else (vp, None)
        b, s, h, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        tab, cl, pos = (t.to(torch.int32).contiguous()
                        for t in (tables, ctx, positions))
        val = valid.to(torch.bool).contiguous()
        n_work = floats(b, s, h, d, page_size, tab.shape[1], kinds[kind],
                        codes[str(q.dtype)])
        work = torch.empty(max(n_work, 1), dtype=torch.float32,
                           device=q.device)
        err = fn(q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
                 ks.data_ptr() if ks is not None else None,
                 vs.data_ptr() if vs is not None else None, out.data_ptr(),
                 tab.data_ptr(), cl.data_ptr(), val.data_ptr(),
                 pos.data_ptr(), b, s, h, d, kv.shape[0], page_size,
                 tab.shape[1], q.stride(0), q.stride(1), q.stride(2),
                 float(scale), kinds[kind], codes[str(q.dtype)],
                 codes[str(kv.dtype)], work.data_ptr(), work.numel(),
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"parent paged kernel: CUDA error {err}")
        return out
    return call


# (B, S, H, D, causal) of bench.py's other configurations: bert (b=32
# s=512, 12 heads of 64, bidirectional), small (b=8 s=512, 12 of 64),
# medium (b=16 s=512, 16 of 64), large (b=8 s=1024, 20 of 64), and
# ERNIE-10B's forward (b=4 s=512, 32 of 128); the first four train, so the
# backward kernels are held at them too
FAMILY_FLASH_SHAPES = ((32, 512, 12, 64, False), (8, 512, 12, 64, True),
                       (16, 512, 16, 64, True), (8, 1024, 20, 64, True),
                       (4, 512, 32, 128, False))
FAMILY_TRAIN_SHAPES = FAMILY_FLASH_SHAPES[:4]
# (Sq, Sk) of the forward's rows at Sq != Sk: cached decode steps against
# 128 and 512 keys, a cross-attention of 128 queries over 512
CROSS_SHAPES = ((1, 128), (1, 512), (128, 512))


def phase_kernels(state):
    import torch
    seed = state["seed"]
    rows = []
    parent_flash = (_parent_flash(state["parent"]) if state.get("parent")
                    else None)
    log(f"kernels: flash_fwd vs mha_fwd_reference (atol/rtol 2e-5 f32, "
        f"2e-2 bf16; bf16 row_err <= {BF16_ROW_LIMIT['flash_fwd']})")
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            for s in (1, 17, 128, 1000, 2048):
                rows.append(_flash_case(
                    b, s, 16, 128, dtype, True, seed + s + b, report=True,
                    parent=parent_flash if dtype == torch.float32 else None))
    rows.append(_flash_case(2, 300, 16, 64, torch.float32, False,
                            seed + 1))
    # float32 at the training shape (the float32 parities'), the float32
    # kernel's relabelled V order against a causal edge at D=64 (ragged,
    # many tiles), rows that are not 16-byte aligned (the wrapper copies
    # them for the kernel's 16-byte loads) and a NaN made on the card
    state["flash_f32_train"] = _flash_case(
        TRAIN_BATCH, TRAIN_SEQ, 16, 128, torch.float32, True, seed + 25,
        report=True, parent=parent_flash, ref64=True)
    rows.append(state["flash_f32_train"])
    rows.append(_flash_case(2, 1000, 16, 64, torch.float32, True,
                            seed + 23))
    for d in (64, 128):
        rows.append(_flash_case(2, 300, 8, d, torch.float32, True,
                                seed + 24, unaligned=True))
        rows.append(_flash_nan_case(d, seed + 26))
    rows.append(_flash_case(2, 77, 8, 64, torch.bfloat16, True,
                            seed + 2))
    # the training step's shape, and the bf16 kernel's tile edges (blocks of
    # 128 query rows, tiles of 128 keys), a full window of a ragged length
    # and three separate contiguous tensors
    rows.append(_flash_case(2, 2048, 16, 128, torch.bfloat16, True,
                            seed + 15, report=True))
    for s in (127, 129, 255):
        rows.append(_flash_case(2, s, 16, 128, torch.bfloat16, True,
                                seed + 16 + s))
    rows.append(_flash_case(2, 300, 16, 128, torch.bfloat16, False,
                            seed + 17))
    rows.append(_flash_case(2, 1000, 16, 128, torch.bfloat16, True,
                            seed + 18, separate=True))
    # a negative scale takes the kernel's other softmax (no folded scale)
    rows.append(_flash_case(2, 300, 16, 128, torch.bfloat16, True,
                            seed + 19, scale=-1.0 / math.sqrt(128)))
    state["flash_rows"] = rows
    # the main path's prefill: 8 rows in the 2048 bucket, bf16
    state["flash_main"] = next(
        r for r in rows if r["case"].startswith("flash_fwd B=8 S=2048")
        and "bfloat16" in r["case"])
    state["flash_train"] = next(
        r for r in rows if r["case"].startswith("flash_fwd B=2 S=2048")
        and "bfloat16" in r["case"])
    # the long-context training row (stacked decoder, s=8192)
    state["flash_long"] = _flash_case(TRAIN_BATCH, LONG_SEQ, 16, 128,
                                      torch.bfloat16, True, seed + 22,
                                      report=True)
    rows.append(state["flash_long"])
    # float16 (fp16 AMP training, the recipe phase): the training shape, the
    # serving batch and the long-context row, timed, and the tensor-core
    # kernel's edges (ragged tiles, D=64, a full window, separate tensors, a
    # negative scale)
    log(f"kernels: flash_fwd float16 (atol/rtol 2e-2; row_err <= "
        f"{F16_ROW_LIMIT})")
    f16 = torch.float16
    state["flash_f16_train"], state["flash_f16_main"], \
        state["flash_f16_long"] = (
            _flash_case(b, s, 16, 128, f16, True, seed + 50 + b, report=True)
            for b, s in ((TRAIN_BATCH, TRAIN_SEQ), (8, 2048),
                         (TRAIN_BATCH, LONG_SEQ)))
    rows += [state["flash_f16_train"], state["flash_f16_main"],
             state["flash_f16_long"],
             _flash_case(2, 129, 16, 128, f16, True, seed + 53),
             _flash_case(2, 1000, 16, 64, f16, True, seed + 54),
             _flash_case(2, 300, 16, 128, f16, False, seed + 55),
             _flash_case(2, 1000, 16, 128, f16, True, seed + 56,
                         separate=True),
             _flash_case(2, 300, 16, 128, f16, True, seed + 57,
                         scale=-1.0 / math.sqrt(128))]

    log(f"kernels: paged_attention vs paged_attention_reference (same; "
        f"bf16 row_err <= {BF16_ROW_LIMIT['paged_attention']})")
    parent = (_parent_paged(state["parent"]) if state.get("parent")
              else None)
    prow = []
    for kv in ("model", "int8"):
        if kv == "int8":
            log("kernels: paged_attention over int8 pools vs the plain "
                "version (dequantized to float32; same tolerances)")
        for dtype in (torch.bfloat16, torch.float32):
            sd = seed + (13 if kv == "int8" else 3)
            prow.append(_paged_case(8, 1, 16, 128, 16, 128, dtype, "decode",
                                    sd, report=True, kv=kv,
                                    parent=parent))
            for s in (5, 300):
                prow.append(_paged_case(
                    8, s, 16, 128, 16, 128, dtype, "chunked",
                    seed + s + (13 if kv == "int8" else 0), report=True,
                    kv=kv, parent=parent))
        # the window and decode kernels' edges, in bf16 and float32:
        # windows of one row, at and across the 16-row tile and the 64-row
        # tiles (S=300: five, the last of 44 rows); one row holding the
        # table's whole 2048 context beside short ones (16 or 32 chunks
        # against one); head_dim 64; q rows off 16-byte alignment (the
        # window kernels' scalar q loads)
        for dtype in (torch.bfloat16, torch.float32):
            for s in (1, 16, 17, 64, 65):
                prow.append(_paged_case(8, s, 16, 128, 16, 128, dtype,
                                        "chunked", seed + 30 + s, kv=kv))
            prow.append(_paged_case(8, 1, 16, 128, 16, 128, dtype,
                                    "decode", seed + 31, kv=kv,
                                    one_long=True))
            prow.append(_paged_case(5, 1, 4, 64, 4, 40, dtype, "decode",
                                    seed + 5, kv=kv))
            prow.append(_paged_case(5, 17, 4, 64, 16, 20, dtype, "chunked",
                                    seed + 14, kv=kv))
            for s in (5, 70):
                prow.append(_paged_case(4, s, 16, 128, 16, 16, dtype,
                                        "chunked", seed + 32, kv=kv,
                                        q_offset=True))
        # pages of 128 slots (the kernels resolve each token's page, so no
        # page size is refused)
        for dtype in (torch.bfloat16, torch.float32):
            for kind, s in (("decode", 1), ("chunked", 65)):
                prow.append(_paged_case(4, s, 16, 128, 128, 16, dtype, kind,
                                        seed + 40 + s, kv=kv))
    prow.append(_paged_case(3, 5, 4, 64, 64, 6, torch.float32,
                            "chunked", seed + 4))
    for dtype in (torch.bfloat16, torch.float32):
        prow.append(_paged_case(5, 5, 4, 64, 16, 20, dtype, "chunked",
                                seed + 14, kv="int8"))
    # a NaN made on the card in a key, through the decode kernel (and the
    # combine kernel), a split window and a 64-row window
    state["paged_nan_rows"] = [
        _paged_nan_case(kind, s, d, seed + 45 + s + d)
        for kind, s, d in (("decode", 1, 128), ("decode", 1, 64),
                           ("chunked", 5, 128), ("chunked", 65, 128))]
    state["paged_rows"] = prow

    def main_row(kind, s, dtype, kv):
        return next(r for r in prow if r["case"].startswith(
            f"paged_attention {kind} B=8 S={s} ") and r["case"].endswith(
                dtype + (" int8 pools" if kv == "int8" else "")))
    state["paged_main"] = main_row("decode", 1, "bfloat16", "model")
    state["paged_int8_main"] = main_row("decode", 1, "bfloat16", "int8")
    # the float32 rows the kernels line reports: decode, and the S=5 and
    # S=300 windows, over float and int8 pools
    state["paged_f32_rows"] = {
        kv: [main_row(kind, s, "float32", kv) for kind, s in
             (("decode", 1), ("chunked", 5), ("chunked", 300))]
        for kv in ("model", "int8")}

    log(f"kernels: flash_bwd_dq, flash_bwd_dkv vs mha_bwd_reference (bf16 "
        f"grad_err <= {BWD_BF16_GRAD_LIMIT}; f32 max abs err <= "
        f"{BWD_F32_TOL} x (1 + max |plain|); two launches bit for bit)")
    parent_bwd = (_parent_flash_bwd(state["parent"]) if state.get("parent")
                  else None)
    brow = [_bwd_case(2, 2048, 16, 128, torch.bfloat16, True, seed + 6,
                      name_kernels=True),
            _bwd_case(2, 2048, 16, 128, torch.float32, True, seed + 7,
                      parent=parent_bwd, ref64=True, name_kernels=True),
            _bwd_case(8, 1000, 16, 128, torch.bfloat16, True, seed + 8),
            _bwd_case(2, 40, 16, 128, torch.bfloat16, True, seed + 9),
            _bwd_case(2, 40, 4, 64, torch.float32, True, seed + 9),
            _bwd_case(2, 300, 16, 128, torch.bfloat16, False, seed + 10),
            _bwd_case(2, 300, 8, 64, torch.float32, False, seed + 10),
            _bwd_case(2, 256, 16, 128, torch.bfloat16, True, seed + 11,
                      lse_ct=True),
            # the bf16 kernels at D=64, and with a K/V length other than
            # Q's at both kernels' tile edges (blocks of 128 rows, tiles of
            # 64)
            _bwd_case(2, 1000, 16, 64, torch.bfloat16, True, seed + 20),
            _bwd_case(2, 300, 16, 128, torch.bfloat16, False, seed + 21,
                      sk=520),
            # BERT-base's float32 shape (the families phase's parity)
            _bwd_case(32, ENCODER_SEQ, 12, 64, torch.float32, False,
                      seed + 24, parent=parent_bwd),
            # the float32 kernels' edges: D=64 causal over many ragged
            # tiles, a K/V length other than Q's, an lse cotangent, rows
            # that are not 16-byte aligned (the wrapper copies them)
            _bwd_case(2, 1000, 16, 64, torch.float32, True, seed + 25),
            _bwd_case(2, 300, 16, 128, torch.float32, False, seed + 26,
                      sk=520),
            _bwd_case(2, 256, 16, 128, torch.float32, True, seed + 27,
                      lse_ct=True),
            _bwd_case(2, 300, 8, 64, torch.float32, True, seed + 28,
                      unaligned=True),
            _bwd_case(2, 300, 8, 128, torch.float32, True, seed + 29,
                      unaligned=True)]
    # a NaN made on the card in dO reaches the plain version's entries
    state["bwd_nan_rows"] = [_bwd_nan_case(d, seed + 30 + d)
                             for d in (64, 128)]
    # the long-context training shape (stacked decoder, s=8192)
    state["bwd_long"] = _bwd_case(TRAIN_BATCH, LONG_SEQ, 16, 128,
                                  torch.bfloat16, True, seed + 23)
    brow.append(state["bwd_long"])
    # float16: the training shape, the long-context shape and the edges
    f16 = torch.float16
    state["bwd_f16_main"] = _bwd_case(TRAIN_BATCH, TRAIN_SEQ, 16, 128, f16,
                                      True, seed + 60)
    state["bwd_f16_long"] = _bwd_case(TRAIN_BATCH, LONG_SEQ, 16, 128, f16,
                                      True, seed + 61)
    brow += [state["bwd_f16_main"], state["bwd_f16_long"],
             _bwd_case(2, 40, 16, 128, f16, True, seed + 62),
             _bwd_case(2, 1000, 16, 64, f16, True, seed + 63),
             _bwd_case(2, 300, 16, 128, f16, False, seed + 64, sk=520)]
    # bench.py's other configurations (the families phase): BERT-base's
    # bidirectional D=64, GPT-2 small's, medium's and large's causal D=64,
    # and (the forward only) ERNIE-10B's bidirectional D=128
    log("kernels: flash_fwd, flash_bwd_dq, flash_bwd_dkv at bench.py's "
        "other shapes (bf16)")
    state["flash_family_rows"] = [
        _flash_case(b, s, h, d, torch.bfloat16, causal, seed + 70 + i,
                    report=True)
        for i, (b, s, h, d, causal) in enumerate(FAMILY_FLASH_SHAPES)]
    rows += state["flash_family_rows"]
    state["bwd_family_rows"] = [
        _bwd_case(b, s, h, d, torch.bfloat16, causal, seed + 80 + i)
        for i, (b, s, h, d, causal) in enumerate(FAMILY_TRAIN_SHAPES)]
    brow += state["bwd_family_rows"]
    # the forward at Sq != Sk, full attention, at the nn phase's widths:
    # cached decode steps of nn.MultiHeadAttention.Cache (one query against
    # 128 and 512 keys) and a TransformerDecoder's cross-attention (128
    # queries against a 512-token memory)
    log("kernels: flash_fwd at Sq != Sk (cached decode, cross-attention; "
        "bf16)")
    state["flash_cross_rows"] = [
        _flash_case(NN_CFG["batch"], sq, NN_CFG["heads"], 64, torch.bfloat16,
                    False, seed + 100 + i, report=True, sk=sk)
        for i, (sq, sk) in enumerate(CROSS_SHAPES)]
    rows += state["flash_cross_rows"]
    for row in brow:
        check_bwd(row)
    state["bwd_rows"] = brow
    state["bwd_main"] = brow[0]      # the training shape, bf16
    state["bwd_f32_main"] = brow[1]  # the training shape, float32
    state["bwd_f32_bert"] = next(
        r for r in brow if r["case"].startswith("flash_bwd B=32 S=512")
        and r["dtype"] == str(torch.float32))
    # the inference phase's shapes (ERNIE-base: bidirectional, 12 heads of
    # 64), in float32 and in bf16: the Predictor's b=8 s=128, then the
    # server's full batch B=16 at each bucket
    log("kernels: flash_fwd at the inference phase's shapes")
    infer_shapes = [(INFER_BATCH, INFER_SEQ)] + [
        (SERVER_MAX_BATCH, s) for s in SERVER_BUCKETS]
    state["flash_f32_infer_rows"] = [
        _flash_case(b, s, 12, 64, torch.float32, False, seed + 90 + i,
                    report=True, parent=parent_flash, ref64=True)
        for i, (b, s) in enumerate(infer_shapes)]
    state["flash_f32_main"] = next(
        r for r in rows if r["case"].startswith("flash_fwd B=8 S=2048")
        and "float32" in r["case"])
    state["flash_bf16_infer_rows"] = [
        _flash_case(b, s, 12, 64, torch.bfloat16, False, seed + 95 + i,
                    report=True)
        for i, (b, s) in enumerate(infer_shapes)]
    rows += state["flash_f32_infer_rows"] + state["flash_bf16_infer_rows"]
    state["bwd_overflow"] = _bwd_overflow_f16(seed + 65)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernels.json").write_text(json.dumps(
        {"card": state.get("smi"), "flash_fwd": rows,
         "paged_attention": prow, "paged_nan": state["paged_nan_rows"],
         "flash_bwd": brow,
         "flash_bwd_nan": state["bwd_nan_rows"],
         "flash_bwd_f16_overflow": state["bwd_overflow"]}, indent=1))


PAGE_SIZE = 16
MAX_BATCH = 8


def _tiny_runs(cfg, seed, use_kernels):
    """gpt_tiny in float32 on the card: a cached prefill, 4 decode steps
    and a verify window (teacher-forced by a fixed stream), then one
    TrainStep step (AdamW) from the same weights. Returns (logits per step,
    the loss)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.models.gpt import GPTAttention
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving.generation import CachedDecoder
    rng = np.random.RandomState(seed)
    b, pps = 4, cfg.max_seq_len // PAGE_SIZE
    lens = np.array([5, 17, 40, 64], np.int32)
    ids = rng.randint(0, cfg.vocab_size, (b, 64))
    feed = rng.randint(0, cfg.vocab_size, (5, b))
    window = rng.randint(0, cfg.vocab_size, (b, SPEC_K + 1))
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           seed=seed)
    model.eval()
    dec = CachedDecoder(model, max_batch=b, page_size=PAGE_SIZE,
                        pages_per_seq=pps, use_kernels=use_kernels,
                        device="cuda")
    k, v = model.init_kv_pools(1 + b * pps, PAGE_SIZE)
    last, k, v = dec.prefill(ids, lens, tables, k, v)
    outs = [last.float()]
    ctx = lens.copy()
    for tok in feed[:4]:
        logits, k, v = dec.decode(tok, ctx, np.ones(b, bool), ctx + 1,
                                  tables, k, v)
        outs.append(logits.float())
        ctx = ctx + 1
    logits, k, v = dec.verify(window, ctx, np.full(b, SPEC_K + 1, np.int32),
                              tables, k, v)
    outs.append(logits.float())
    model.train()
    for mod in model.modules():
        if isinstance(mod, GPTAttention):
            mod.use_kernels = use_kernels
    crit = GPTPretrainingCriterion()
    step = TrainStep(model, lambda out, y: crit(out, y),
                     AdamW(learning_rate=TRAIN_LR,
                           parameters=model.named_parameters()))
    x = torch.from_numpy(ids).cuda()
    loss = float(step(x, x))
    return outs, loss


def phase_tiny(state):
    """The shapes no kernel takes: gpt_tiny (hidden 64 over 4 heads, so
    head_dim 16) serves and trains on the card through the default path,
    whose attention calls the callers route to the plain versions, as the
    reference routes them to its dense and gather paths. Every kernel's
    launch count must stay 0 and every plain version's count rise; the
    logits and the loss must match the same model run with
    use_kernels=False within float32 tolerance (both take the same plain
    versions, so they should agree exactly)."""
    import torch
    from paddle_tpu_torch.models import gpt_tiny
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    cfg = gpt_tiny()
    for mod in (ca, cpa):
        mod.launches = 0
        mod.plain_calls = 0
    for name in cab.KERNELS:
        cab.launches[name] = cab.plain_calls[name] = 0
    outs, loss = _tiny_runs(cfg, state["seed"], use_kernels=True)
    torch.cuda.synchronize()
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              "paged_attention": (cpa.launches, cpa.plain_calls),
              **{n: (cab.launches[n], cab.plain_calls[n])
                 for n in cab.KERNELS}}
    ref_outs, ref_loss = _tiny_runs(cfg, state["seed"], use_kernels=False)
    dist = [max_abs_err(a, r) / float(r.std())
            for a, r in zip(outs, ref_outs)]
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    out = {"config": "gpt_tiny", "head_dim": cfg.hidden_size // cfg.num_heads,
           "launches": {k: c[0] for k, c in counts.items()},
           "plain_calls": {k: c[1] for k, c in counts.items()},
           "logits_max_err_over_std": max(dist), "loss": loss,
           "loss_rel": loss_rel}
    log("tiny: " + json.dumps(out))
    for name, (launched, plain) in counts.items():
        require(launched == 0, f"tiny: {name} launched {launched} times for "
                               f"shapes it does not take")
        require(plain > 0, f"tiny: {name}'s plain version was never routed "
                           f"to")
    require(all(bool(torch.isfinite(a).all()) for a in outs)
            and math.isfinite(loss), "tiny: non-finite logits or loss")
    require(max(dist) <= F32_MODEL_LIMIT,
            f"tiny: logits differ from the use_kernels=False run by "
            f"{max(dist):.2e} x std")
    require(loss_rel <= TRAIN_F32_LOSS_RTOL,
            f"tiny: loss differs from the use_kernels=False run by "
            f"{loss_rel:.2e}")
    state["tiny"] = out


def _model(state):
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    if "model" not in state:
        t0 = time.perf_counter()
        model = GPTForCausalLM(gpt3_1p3b(), device="cuda",
                               dtype=torch.bfloat16, seed=state["seed"])
        model.eval()
        torch.cuda.synchronize()
        state["model"] = model
        log(f"model: gpt3_1p3b bf16, {model.num_params() / 1e9:.3f} B "
            f"params, built in {time.perf_counter() - t0:.1f} s")
    return state["model"]


CHUNK_LEN = 40          # the model phase's chunked suffix
SPEC_K = 4              # the serving phase's proposals a step
# the model phase's plan over int8 pools (the mesh phase's too)
MESH_PLAN8 = ["decode"] * 4 + ["chunked", "verify"] + ["decode"] * 2


def _model_inputs(cfg, seed):
    """The model phase's batch: 8 rows of 64-1536 tokens in the 2048
    window, their block tables, and the chunked and verify tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b, pps = MAX_BATCH, cfg.max_seq_len // PAGE_SIZE
    lens = rng.permutation(np.linspace(64, 1536, b).astype(np.int32))
    window = 2048
    ids = np.zeros((b, window), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg.vocab_size, n)
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    extra = {"chunk": rng.randint(0, cfg.vocab_size, (b, CHUNK_LEN)),
             "verify": rng.randint(0, cfg.vocab_size, (b, SPEC_K))}
    return ids, lens, tables, extra


def _mesh_ref(runs, feed):
    """A comparison's logits kept on the host for the mesh phase: the
    unsharded kernel run's, the bf16 and float32 plain runs', and the
    forced tokens."""
    return {"feed": feed, **{label: [t.cpu() for t in runs[label]]
                             for label in ("kernels", "plain", "plain_f32")}}


def _model_step(dec, what, tok, ctx, tables, k, v, extra):
    """One step of a comparison's plan after ``ctx`` cached tokens a row:
    ``decode`` of ``tok``, ``chunked`` (a CHUNK_LEN-token suffix from
    ``extra``) or ``verify`` (a SPEC_K + 1 window: ``tok``, then
    ``extra``'s). Returns (logits, k, v, the new ctx)."""
    import numpy as np
    b = len(ctx)
    if what == "decode":
        logits, k, v = dec.decode(tok, ctx, np.ones(b, bool), ctx + 1, tables,
                                  k, v)
        return logits, k, v, ctx + 1
    if what == "chunked":
        seg = np.full(b, CHUNK_LEN, np.int32)
        logits, k, v = dec.prefill_chunked(extra["chunk"], ctx, seg, tables,
                                           k, v)
        return logits, k, v, ctx + CHUNK_LEN
    window = np.concatenate([tok[:, None], extra["verify"]], 1)
    seg = np.full(b, SPEC_K + 1, np.int32)
    logits, k, v = dec.verify(window, ctx, seg, tables, k, v)
    return logits, k, v, ctx + SPEC_K + 1


def _lockstep_f32(m32, ids, lens, tables, plan, extra, feed, ref32=None):
    """The float32 model over int8 pools, its kernel and plain paths in
    lockstep over ONE set of pools: at each step the kernel path runs first
    and writes the step's K/V, then the plain path runs with its pool
    writes switched off, so every attention of both paths reads the same
    int8 values. With ``ref32`` (the same weights in the other decoder
    structure) the plain path is ``ref32``'s, reading the kernel path's
    pools through per-layer views. Returns max |kernel - plain| /
    std(plain) of the logits per step (the prefill first)."""
    import torch
    from paddle_tpu_torch.models.gpt import layer_pool
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving.generation import CachedDecoder
    b, pps = tables.shape
    ref32 = m32 if ref32 is None else ref32
    kern, plain = (CachedDecoder(mdl, max_batch=b, page_size=PAGE_SIZE,
                                 pages_per_seq=pps, use_kernels=use_kernels,
                                 kv_dtype="int8", device="cuda")
                   for mdl, use_kernels in ((m32, True), (ref32, False)))
    k, v = m32.init_kv_pools(1 + b * pps, PAGE_SIZE, "int8")
    pk, pv = k, v
    if ref32.config.stacked != m32.config.stacked:
        pk, pv = ([layer_pool(pool, i) for i in range(m32.config.num_layers)]
                  for pool in (k, v))
    write_pool = pa.write_pool

    def reading(fn, *args):
        pa.write_pool = lambda pool, slots, kv: pool
        try:
            return fn(*args)
        finally:
            pa.write_pool = write_pool

    outs = [[kern.prefill(ids, lens, tables, k, v)[0].float()],
            [reading(plain.prefill, ids, lens, tables, pk, pv)[0].float()]]
    ctx = lens.copy()
    for step, what in enumerate(plan):
        outs[0].append(_model_step(kern, what, feed[step], ctx, tables, k, v,
                                   extra)[0].float())
        logits, _, _, ctx = reading(_model_step, plain, what, feed[step],
                                    ctx, tables, pk, pv, extra)
        outs[1].append(logits.float())
    dist = [max_abs_err(a, p) / float(p.std()) for a, p in zip(*outs)]
    del k, v, pk, pv, outs
    torch.cuda.empty_cache()
    return dist


def _model_runs(model, m32, ids, lens, tables, kv, plan, extra,
                ref32=None, tag="model"):
    """The four runs of one comparison (bf16 kernels, bf16 plain, float32
    plain, float32 kernels; the float32 plain run on ``ref32`` when given,
    the same weights in the other decoder structure, else on ``m32``),
    each a cached prefill and then ``plan``'s
    steps: ``decode`` (teacher-forced by the bf16 kernel run's argmax),
    ``chunked`` (a CHUNK_LEN-token suffix from ``extra``) or ``verify`` (a
    SPEC_K + 1 window: the forced token, then ``extra``'s). Pools in the
    model's dtype (``kv=""``) or int8. In the kernel runs every paged
    attention call is also computed by the plain version on the same
    inputs. Returns {label: [logits per step]}, the forced tokens and the
    in-model comparison by q's dtype (the step times then include the plain
    calls)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.generation import CachedDecoder
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    b, pps = tables.shape
    runs, feed, inner = {}, [], {}
    kernel = cpa.paged_attention

    def held(q, kp, vp, *args, **kw):
        """The paged kernel, and its plain version on the same inputs (a
        comparison: not counted in ``plain_calls``); the kernels launched,
        by name."""
        before = dict(cpa.launches_by_kernel)
        out = kernel(q, kp, vp, *args, **kw)
        plain = cpa.plain_calls
        ref = cpa.paged_attention_reference(q, kp, vp, *args, **kw)
        cpa.plain_calls = plain
        rec = inner.setdefault(str(q.dtype)[6:], {"calls": 0, "max_abs_err":
                                                  0.0, "row_err": 0.0,
                                                  "allclose": True,
                                                  "launches_by_kernel": {}})
        rec["calls"] += 1
        by = rec["launches_by_kernel"]
        for name, n in _launch_delta(cpa.launches_by_kernel, before).items():
            by[name] = by.get(name, 0) + n
        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err(out, ref))
        rec["row_err"] = max(rec["row_err"], row_err(out, ref))
        rec["allclose"] &= bool(torch.allclose(
            out.float(), ref.float(), atol=INNER_F32_TOL, rtol=INNER_F32_TOL))
        return out

    try:
        for label, mdl, use_kernels in (("kernels", model, True),
                                        ("plain", model, False),
                                        ("plain_f32",
                                         m32 if ref32 is None else ref32,
                                         False),
                                        ("kernels_f32", m32, True)):
            cpa.paged_attention = held if use_kernels else kernel
            dec = CachedDecoder(mdl, max_batch=b, page_size=PAGE_SIZE,
                                pages_per_seq=pps, use_kernels=use_kernels,
                                kv_dtype=kv, device="cuda")
            k, v = mdl.init_kv_pools(1 + b * pps, PAGE_SIZE, kv or None)
            outs = []
            plain_before = cpa.plain_calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, k, v = dec.prefill(ids, lens, tables, k, v)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            outs.append(last.float())
            ctx = lens.copy()
            t0 = time.perf_counter()
            for step, what in enumerate(plan):
                if label == "kernels":
                    prev = outs[-1] if outs[-1].dim() == 2 else outs[-1][:, -1]
                    feed.append(prev.argmax(-1).cpu().numpy())
                logits, k, v, ctx = _model_step(dec, what, feed[step], ctx,
                                                tables, k, v, extra)
                outs.append(logits.float())
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / len(plan)
            runs[label] = outs
            if use_kernels:
                # paged calls the kernel runs routed to the plain version
                inner.setdefault("plain_calls", {})[label] = \
                    cpa.plain_calls - plain_before
            log(f"{tag}: {kv or 'bf16/f32'} pools, {label:11s} prefill "
                f"{prefill_ms:.1f} ms, step {step_ms:.2f} ms "
                f"({'/'.join(plan)})")
            del k, v
            torch.cuda.empty_cache()
    finally:
        cpa.paged_attention = kernel
    return runs, feed, inner


def _model_check(runs, inner, vocab, what, f32_limit, tag="model"):
    """The kernel-vs-plain limits over one comparison's runs."""
    import numpy as np
    import torch

    def dist(a, ref):
        return max_abs_err(a, ref) / float(ref.float().std())

    for label, outs in runs.items():
        for i, a in enumerate(outs):
            require(bool(torch.isfinite(a).all()) and a.shape[-1] == vocab,
                    f"{tag}: {what} {label} step {i} logits bad")
    ratios = [dist(a, p) for a, p in zip(runs["kernels"], runs["plain"])]
    k_f32 = [dist(a, r) for a, r in zip(runs["kernels"], runs["plain_f32"])]
    floors = [dist(p, r) for p, r in zip(runs["plain"], runs["plain_f32"])]
    f32 = [dist(a, p) for a, p in zip(runs["kernels_f32"], runs["plain_f32"])]
    agree = [float((a.argmax(-1) == p.argmax(-1)).float().mean())
             for a, p in zip(runs["kernels"], runs["plain"])]
    log(f"{tag}: {what}: float32, max |kernel - plain| / std per step "
        + " ".join(f"{x:.2e}" for x in f32) + f" (limit {f32_limit})")
    log(f"{tag}: {what}: bf16, max |kernel - plain f32| / std per step "
        + " ".join(f"{x:.4f}" for x in k_f32))
    log(f"{tag}: {what}: bf16 floor, max |plain - plain f32| / std per step "
        + " ".join(f"{x:.4f}" for x in floors)
        + f" (kernel path limit {BF16_FLOOR_FACTOR} x its max)")
    log(f"{tag}: {what}: bf16, max |kernel - plain| / std per step "
        + " ".join(f"{x:.4f}" for x in ratios))
    log(f"{tag}: {what}: argmax agreement kernel/plain {np.mean(agree):.4f} "
        f"(min {min(agree):.3f})")
    log(f"{tag}: {what}: paged kernel vs plain inside the kernel runs "
        + json.dumps(inner))
    require(inner.get("float32", {}).get("allclose", False),
            f"{tag}: {what}: float32 paged calls differ from the plain "
            f"version beyond atol/rtol {INNER_F32_TOL}: {inner}")
    # every paged call of the kernel runs launched the kernel of its q type
    require(not any(inner["plain_calls"].values()),
            f"{tag}: {what}: paged calls of the kernel runs went to the plain "
            f"version: {inner['plain_calls']}")
    for dtype, suffix in (("bfloat16", "_bf16"), ("float32", "_f32")):
        by = inner.get(dtype, {}).get("launches_by_kernel", {})
        require(by and all(n.endswith(suffix) for n in by)
                and sum(by.values()) == inner[dtype]["calls"],
                f"{tag}: {what}: {dtype} paged launches by kernel {by}")
    require(inner.get("bfloat16", {}).get("row_err", 1.0)
            <= BF16_ROW_LIMIT["paged_attention"],
            f"{tag}: {what}: bf16 paged calls beyond row_err "
            f"{BF16_ROW_LIMIT['paged_attention']}: {inner}")
    require(max(f32) <= f32_limit,
            f"{tag}: {what}: float32 kernel path differs from the plain path "
            f"by {max(f32):.2e} x std (limit {f32_limit})")
    bf16_limit = BF16_FLOOR_FACTOR * max(floors)
    require(max(k_f32) <= bf16_limit,
            f"{tag}: {what}: bf16 kernel path is {max(k_f32):.4f} x std from "
            f"float32, beyond {BF16_FLOOR_FACTOR} x the plain path's "
            f"{max(floors):.4f}")
    return {"f32_max_err_over_std": max(f32),
            "bf16_kernel_vs_f32_over_std": max(k_f32),
            "bf16_floor_over_std": max(floors),
            "bf16_kernel_vs_plain_over_std": max(ratios),
            "per_step_kernel_vs_plain": ratios,
            "per_step_f32": f32,
            "argmax_agreement": float(np.mean(agree)),
            "paged_calls_vs_plain": inner}


def phase_model(state):
    """One cached prefill (8 rows, prompts of 64-1536 tokens in the 2048
    window) and 8 teacher-forced decode steps, through the kernels and
    through their plain versions; logits compared. Then the same over int8
    pools, with a chunked suffix and a verify window among the steps."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    model = _model(state)
    cfg = model.config
    ids, lens, tables, extra = _model_inputs(cfg, state["seed"])
    # the same weights in float32, through the plain versions: the
    # reference that measures the bf16 rounding floor itself
    m32 = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    m32.eval()
    runs, feed, inner = _model_runs(model, m32, ids, lens, tables, "",
                                    ["decode"] * 8, extra)
    check = _model_check(runs, inner, cfg.vocab_size, "bf16/f32 pools",
                         F32_MODEL_LIMIT)
    # the mesh phase holds its sharded decoders against these runs
    state.setdefault("mesh_refs", {})[""] = _mesh_ref(runs, feed)
    del runs
    plan8 = MESH_PLAN8
    runs8, feed8, inner8 = _model_runs(model, m32, ids, lens, tables, "int8",
                                       plan8, extra)
    check["int8"] = dict(_model_check(runs8, inner8, cfg.vocab_size,
                                      "int8 pools", F32_INT8_MODEL_LIMIT),
                         plan=plan8)
    state["mesh_refs"]["int8"] = _mesh_ref(runs8, feed8)
    del runs8
    before = dict(cpa.launches_by_kernel)
    lock = _lockstep_f32(m32, ids, lens, tables, plan8, extra, feed8)
    check["int8"]["f32_lockstep_launches_by_kernel"] = _launch_delta(
        cpa.launches_by_kernel, before)
    log("model: int8 pools: float32 in lockstep (the plain path reads the "
        "pools the kernel path wrote), max |kernel - plain| / std per step "
        + " ".join(f"{x:.2e}" for x in lock) + f" (limit {F32_MODEL_LIMIT})")
    require(max(lock) <= F32_MODEL_LIMIT,
            f"model: int8 pools: float32 kernel path in lockstep differs from "
            f"the plain path by {max(lock):.2e} x std")
    check["int8"]["f32_lockstep_max_err_over_std"] = max(lock)
    check["int8"]["per_step_f32_lockstep"] = lock
    del m32
    torch.cuda.empty_cache()
    state["decode_profile"] = _profile_decode(model, ids, lens, tables, feed)
    state["model_check"] = check


# kernel-name groups of a step's device time, first match wins
PROFILE_GROUPS = (
    ("port kernels", ("flash_fwd", "dq_wgmma", "dkv_wgmma", "dq_tf32",
                      "dkv_tf32", "paged_attention")),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("matmuls", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy",)),
    ("norms", ("layer_norm", "LayerNorm")),
    ("softmax and loss", ("softmax", "nll_loss", "log_softmax")),
)


def _cuda_profile():
    """A torch.profiler session over the CPU and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _profile_rows(fn, steps: int):
    """torch.profiler over ``steps`` calls of ``fn``: ``[(kernel name,
    device ms per call, launches per call)]``, costliest first, and the
    wall ms per call."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with _cuda_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        # device-side events only: an aten op's own entry repeats the
        # device time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / steps / 1e3, ev.count // steps))
    rows.sort(key=lambda r: -r[1])
    return rows, wall_ms


def device_profile(fn, steps: int) -> dict:
    """torch.profiler over ``steps`` calls of ``fn`` (each ending in a
    device sync): wall ms per call, device busy ms per call (the sum of the
    kernels' device time: one stream, so they do not overlap), its share of
    the wall time, device ms by kernel group, kernels per call and the
    costliest kernels."""
    rows, wall_ms = _profile_rows(fn, steps)
    busy = sum(r[1] for r in rows)
    groups = {}
    for name, ms, _ in rows:
        group = next((g for g, keys in PROFILE_GROUPS if any(
            k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    paged = sum(ms for name, ms, _ in rows if "paged_attention" in name)
    return {"wall_ms_per_step": wall_ms,
            "device_ms_by_group": groups,
            "paged_attention_ms": paged,
            "device_busy_ms_per_step": busy if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "kernels_per_step": sum(r[2] for r in rows),
            "top": [{"name": n[:80], "ms": ms, "calls": c}
                    for n, ms, c in rows[:10]]}


def _profile_decode(model, ids, lens, tables, feed):
    """Device time of one kernel-path decode step by kernel name
    (torch.profiler over 4 steps after a prefill), beside its wall time."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.generation import CachedDecoder
    b = ids.shape[0]
    pps = tables.shape[1]
    dec = CachedDecoder(model, max_batch=b, page_size=PAGE_SIZE,
                        pages_per_seq=pps, device="cuda")
    k, v = model.init_kv_pools(1 + b * pps, PAGE_SIZE)
    _, k, v = dec.prefill(ids, lens, tables, k, v)
    run = {"ctx": lens.copy(), "step": 0, "k": k, "v": v}

    def one():
        i = run["step"]
        _, run["k"], run["v"] = dec.decode(feed[i], run["ctx"],
                                           np.ones(b, bool), run["ctx"] + 1,
                                           tables, run["k"], run["v"])
        run["ctx"] = run["ctx"] + 1
        run["step"] = i + 1

    out = device_profile(one, 4)
    del k, v, run
    torch.cuda.empty_cache()
    log("model: decode step profile " + json.dumps(out))
    return out


def _profile_spec(model, prompts):
    """Device time of one speculative iteration over int8 pools by kernel
    name (torch.profiler over 2 iterations after a prefill): SPEC_K draft
    decode steps and the [8, SPEC_K + 1] verify window, as the serving
    engine runs them with the model as its own draft."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.generation import CachedDecoder
    b = len(prompts)
    pps = model.config.max_seq_len // PAGE_SIZE
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    lens = np.array([len(p) for p in prompts], np.int32)
    ids = np.zeros((b, int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    kw = dict(max_batch=b, page_size=PAGE_SIZE, pages_per_seq=pps,
              kv_dtype="int8", device="cuda")
    target, draft = CachedDecoder(model, **kw), CachedDecoder(model, **kw)
    tk, tv = model.init_kv_pools(1 + b * pps, PAGE_SIZE, "int8")
    dk, dv = model.init_kv_pools(1 + b * pps, PAGE_SIZE, "int8")
    last, tk, tv = target.prefill(ids, lens, tables, tk, tv)
    draft.prefill(ids, lens, tables, dk, dv)
    live = np.ones(b, bool)
    run = {"ctx": lens.copy(), "tok": last.argmax(-1).cpu().numpy()}

    def one():
        # pools are updated in place, so the calls' returned pools are the
        # same tensors
        ctx, feed, window = run["ctx"], run["tok"], [run["tok"]]
        for j in range(SPEC_K):
            logits, _, _ = draft.decode(feed, ctx + j, live, ctx + j + 1,
                                        tables, dk, dv)
            feed = logits.argmax(-1).cpu().numpy()
            window.append(feed)
        vl, _, _ = target.verify(np.stack(window, 1), ctx,
                                 np.full(b, SPEC_K + 1, np.int32), tables,
                                 tk, tv)
        run["tok"] = vl[:, -1].argmax(-1).cpu().numpy()
        # the draft catches up on the last proposal's position
        draft.decode(window[-1], ctx + SPEC_K, live, ctx + SPEC_K + 1,
                     tables, dk, dv)
        run["ctx"] = ctx + SPEC_K + 1

    out = device_profile(one, 2)
    del tk, tv, dk, dv, run
    torch.cuda.empty_cache()
    log("serving: speculative iteration profile " + json.dumps(out))
    return out


ENGINE_PREAMBLE = 256   # the engine phase's shared opening, tokens


def phase_engine(state):
    """GenerationServer at full width, as built by default (bf16 pools, the
    prefix cache on): 16 requests (prompts of 320-1536 tokens that open
    with one 256-token preamble, 64 new tokens, half greedy, half at
    temperature 0.8); admissions after the first prefill hit the
    preamble's published pages and take the chunked suffix prefill. The
    kernels' launch counts are read around this run."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    model = _model(state)
    cfg = model.config
    rng = np.random.RandomState(state["seed"] + 1)
    n_req, new = 16, 64
    preamble = rng.randint(0, cfg.vocab_size, ENGINE_PREAMBLE)
    prompts = [np.concatenate([preamble, rng.randint(0, cfg.vocab_size, n)])
               for n in rng.randint(64, 1537 - ENGINE_PREAMBLE, n_req)]
    srv = GenerationServer(model, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                           device="cuda", name="smoke", start=False)
    log(f"engine: {srv.kv.num_pages} pages of {PAGE_SIZE} slots, "
        f"{srv.kv.pool_bytes() / 1e9:.2f} GB of K/V pools")
    for mod in (ca, cpa):
        mod.launches = 0
        mod.plain_calls = 0
    cpa.launches_by, cpa.launches_by_kernel = {}, {}
    t0 = time.perf_counter()
    with srv:
        srv.start()
        futs = [srv.submit_generate(p, max_new_tokens=new,
                                    temperature=0.0 if i % 2 == 0 else 0.8,
                                    seed=state["seed"] + i)
                for i, p in enumerate(prompts)]
        outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches_by = dict(cpa.launches_by)
    by_kernel = dict(cpa.launches_by_kernel)
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              "paged_attention": (cpa.launches, cpa.plain_calls)}
    snap = srv.metrics_snapshot()
    calls = dict(srv.decoder.calls)
    for i, (f, toks) in enumerate(zip(futs, outs)):
        require(f.finish_reason == "length" and len(toks) == new,
                f"engine: request {i} ended {f.finish_reason} after "
                f"{len(toks)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in toks),
                f"engine: request {i} emitted an out-of-vocab token")
    require(snap["kv_leak_check"]["ok"],
            f"engine: leak check {snap['kv_leak_check']}")
    for name, (launched, plain) in counts.items():
        require(launched > 0, f"engine: {name} was never launched")
        require(plain == 0, f"engine: {name}'s plain version ran {plain} "
                            f"times on the main path")
    # both routes of the paged kernel ran over bf16 pools, the chunked one
    # for every prefix hit's suffix prefill, each call through all layers
    require(snap["prefix"]["hits"] > 0 and calls["chunked"] > 0,
            f"engine: no prefix hit ({snap['prefix']}, calls {calls})")
    want = {("decode", "bfloat16"): cfg.num_layers * calls["decode"],
            ("chunked", "bfloat16"): cfg.num_layers * calls["chunked"]}
    require(launches_by == want
            and counts["flash_fwd"][0] == cfg.num_layers * calls["prefill"],
            f"engine: launches {launches_by}, flash {counts['flash_fwd']} "
            f"against the decoder's calls {calls}")
    # bf16 queries: the window kernel for every chunked call, the
    # split-context kernel for every decode step
    require(by_kernel == {"paged_window_bf16": want[("chunked", "bfloat16")],
                          "paged_decode_split_bf16":
                              want[("decode", "bfloat16")]},
            f"engine: paged launches by kernel {by_kernel}, want {want}")
    dec = snap["step_ms"]["decode"]
    decode_tokens = snap["tokens_total"] - n_req   # the rest come from prefill
    eng = {"requests": n_req, "tokens": snap["tokens_total"], "wall_s": wall,
           "decode_tok_s": decode_tokens / (dec["mean"] * dec["count"] / 1e3),
           "tok_s_wall": snap["tokens_total"] / wall,
           "ttft_ms_p50": snap["ttft_ms"]["p50"],
           "decode_step_ms": dec, "prefill_step_ms": snap["step_ms"]["prefill"],
           "occupancy_mean": snap["batch_occupancy"]["mean"],
           "kv_pages": srv.kv.num_pages, "pool_bytes": srv.kv.pool_bytes(),
           "prefix": snap["prefix"], "decoder_calls": calls,
           "launches": {k: v[0] for k, v in counts.items()},
           "paged_launches_by": {"/".join(k): n
                                 for k, n in launches_by.items()},
           "paged_launches_by_kernel": by_kernel,
           "plain_calls": {k: v[1] for k, v in counts.items()}}
    state["engine"] = eng
    log("engine: " + json.dumps(eng))


SYSTEM_PROMPT = 1024    # the serving phase's shared prompt, tokens
# Greedy self-speculation acceptance of the float32 model, over its own and
# over int8 pools: the model is its own draft, so a verify window that
# disagrees with the decode steps beyond rounding shows here. Read at the
# budget's ceiling (0.9808: 408 of 416). The bf16 model's acceptance is
# printed, not held: bf16 argmax flips between the decode and verify
# forwards put it at 0.84-0.93 over seeds 0-7 whichever flash forward
# wrote the prompts' K/V (NVIDIA H100 80GB HBM3, 700 W).
GREEDY_ACCEPT_MIN = 0.9


def _set_kv_dtype(value):
    from paddle_tpu_torch.framework.flags import flag_value, set_flags
    old = flag_value("FLAGS_decode_kv_dtype")
    set_flags({"FLAGS_decode_kv_dtype": value})
    return old


def _launch_delta(now: dict, before: dict) -> dict:
    """Launches by kernel since ``before`` (a copy of the same counter)."""
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def _greedy_acceptance(model, prompts, kv_dtype, name):
    """Greedy self-speculation over ``prompts`` (one wave, 64 new tokens
    each) with pools of ``kv_dtype`` ('' = the model's dtype): the
    acceptance rate and its counts. Read after the serving run's launch
    counts, to tell the rejections' causes apart: bf16 rounding between
    the decode and verify forwards against int8 quantization of the
    draft's and the target's separately written K/V. The run's paged
    launches by kernel are held against the decoders' calls (the layers
    times the decode steps for the decode kernel of the model's type, and
    times the chunked and verify calls for its window kernel), with no
    plain call; its wall time and iteration ms are kept beside them."""
    import torch
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    old = _set_kv_dtype(kv_dtype)
    try:
        srv = GenerationServer(model, max_batch=MAX_BATCH,
                               page_size=PAGE_SIZE, draft_model=model,
                               spec_k=SPEC_K, device="cuda", name=name,
                               start=False)
    finally:
        _set_kv_dtype(old)
    before, plain = dict(cpa.launches_by_kernel), cpa.plain_calls
    t0 = time.perf_counter()
    with srv:
        srv.start()
        futs = [srv.submit_generate(p, max_new_tokens=64, temperature=0.0)
                for p in prompts]
        outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    snap = srv.metrics_snapshot()
    require(all(len(t) == 64 for t in outs) and snap["kv_leak_check"]["ok"],
            f"serving: acceptance probe {name} did not finish cleanly")
    by_kernel = _launch_delta(cpa.launches_by_kernel, before)
    calls = {"target": dict(srv.decoder.calls),
             "draft": dict(srv.draft.calls)}
    layers = model.config.num_layers
    dtype = next(model.parameters()).dtype
    want = {}
    for kind, n in (("decode", calls["target"]["decode"]
                     + calls["draft"]["decode"]),
                    ("chunked", calls["target"]["chunked"]
                     + calls["target"]["verify"]
                     + calls["draft"]["chunked"])):
        key = cpa.kernel_for(kind, dtype, 1 if kind == "decode" else
                             SPEC_K + 1)
        want[key] = want.get(key, 0) + layers * n
    require(calls["target"]["verify"] > 0 and calls["draft"]["decode"] > 0
            and by_kernel == want and cpa.plain_calls == plain,
            f"serving: {name}: paged launches by kernel {by_kernel}, want "
            f"{want} from the decoders' calls {calls}; plain calls "
            f"{cpa.plain_calls - plain}")
    spec = snap["spec"]
    out = {k: spec[k] for k in ("greedy_acceptance_rate", "proposed",
                                "accepted") if k in spec}
    out.update({"wall_s": wall, "iteration_ms": snap["step_ms"]["decode"],
                "paged_launches_by_kernel": by_kernel,
                "decoder_calls": calls})
    del srv
    torch.cuda.empty_cache()
    return out


def _profile_steps(model, prompts, kv_dtype):
    """One decode step and one verify window ([8, SPEC_K + 1]) of ``model``
    over pools of ``kv_dtype`` ('' = the model's dtype), each profiled
    (torch.profiler over 4 and 2 of them after a prefill of ``prompts``):
    wall and device ms a step, the paged kernels' device ms and the
    device's busy share."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.generation import CachedDecoder
    b = len(prompts)
    pps = model.config.max_seq_len // PAGE_SIZE
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    lens = np.array([len(p) for p in prompts], np.int32)
    ids = np.zeros((b, int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    dec = CachedDecoder(model, max_batch=b, page_size=PAGE_SIZE,
                        pages_per_seq=pps, kv_dtype=kv_dtype, device="cuda")
    k, v = model.init_kv_pools(1 + b * pps, PAGE_SIZE, kv_dtype or None)
    last, k, v = dec.prefill(ids, lens, tables, k, v)
    live = np.ones(b, bool)
    run = {"ctx": lens.copy(), "tok": last.argmax(-1).cpu().numpy()}

    def decode_one():
        ctx = run["ctx"]
        logits, _, _ = dec.decode(run["tok"], ctx, live, ctx + 1, tables, k,
                                  v)
        run["tok"] = logits.argmax(-1).cpu().numpy()
        run["ctx"] = ctx + 1

    def verify_one():
        ctx = run["ctx"]
        window = np.repeat(run["tok"][:, None], SPEC_K + 1, 1)
        logits, _, _ = dec.verify(window, ctx,
                                  np.full(b, SPEC_K + 1, np.int32), tables,
                                  k, v)
        run["tok"] = logits[:, -1].argmax(-1).cpu().numpy()
        run["ctx"] = ctx + SPEC_K + 1

    out = {"decode_step": device_profile(decode_one, 4),
           "verify_step": device_profile(verify_one, 2)}
    for step in out.values():
        busy = step["device_busy_ms_per_step"]
        step["paged_share_of_device"] = (step["paged_attention_ms"] / busy
                                         if busy else None)
    del k, v, run, dec
    torch.cuda.empty_cache()
    return out


def phase_serving(state):
    """The reference's default engine with speculation over int8 pools:
    GenerationServer(model, max_batch=8, page_size=16, draft_model=model,
    spec_k=4) with FLAGS_decode_kv_dtype=int8 and the prefix cache on (its
    default). 16 requests: a shared 1024-token system prompt and a suffix
    of 32-512 tokens each, 64 new tokens, half greedy, half at temperature
    0.8, in two waves of 8, so the second wave's admissions hit the pages
    the first published. Launch counts by kind and pool type are read
    around the run. Greedy acceptance is then read for the bf16 and a
    float32 copy of the model over their own and int8 pools, and held at
    GREEDY_ACCEPT_MIN for the float32 copy."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    model = _model(state)
    cfg = model.config
    rng = np.random.RandomState(state["seed"] + 2)
    n_req, new = 16, 64
    system = rng.randint(0, cfg.vocab_size, SYSTEM_PROMPT)
    prompts = [np.concatenate([system, rng.randint(0, cfg.vocab_size, n)])
               for n in rng.randint(32, 513, n_req)]
    old = _set_kv_dtype("int8")
    try:
        srv = GenerationServer(model, max_batch=MAX_BATCH,
                               page_size=PAGE_SIZE, draft_model=model,
                               spec_k=SPEC_K, device="cuda",
                               name="smoke-serving", start=False)
    finally:
        _set_kv_dtype(old)
    require(srv.prefix is not None and srv.kv.kv_dtype == "int8"
            and srv.spec_k == SPEC_K, "serving: engine not configured")
    log(f"serving: {srv.kv.num_pages} pages of {PAGE_SIZE} slots, "
        f"{srv.kv.pool_bytes() / 1e9:.3f} GB of int8 K/V pools (the draft's "
        f"as many again)")
    for mod in (ca, cpa):
        mod.launches = 0
        mod.plain_calls = 0
    cpa.launches_by, cpa.launches_by_kernel = {}, {}
    futs = []
    t0 = time.perf_counter()
    with srv:
        srv.start()
        for wave in (range(0, 8), range(8, 16)):
            futs += [srv.submit_generate(prompts[i], max_new_tokens=new,
                                         temperature=0.0 if i % 2 == 0
                                         else 0.8, seed=state["seed"] + i)
                     for i in wave]
            outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches_by = dict(cpa.launches_by)
    by_kernel = dict(cpa.launches_by_kernel)
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              "paged_attention": (cpa.launches, cpa.plain_calls)}
    snap = srv.metrics_snapshot()
    calls = {"target": dict(srv.decoder.calls),
             "draft": dict(srv.draft.calls)}
    for i, (f, toks) in enumerate(zip(futs, outs)):
        require(f.finish_reason == "length" and len(toks) == new,
                f"serving: request {i} ended {f.finish_reason} after "
                f"{len(toks)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in toks),
                f"serving: request {i} emitted an out-of-vocab token")
    require(snap["kv_leak_check"]["ok"],
            f"serving: leak check {snap['kv_leak_check']}")
    require(snap["prefix"]["hits"] >= 8,
            f"serving: {snap['prefix']['hits']} prefix hits, not >= 8")
    for name, (launched, plain) in counts.items():
        require(launched > 0, f"serving: {name} was never launched")
        require(plain == 0, f"serving: {name}'s plain version ran {plain} "
                            f"times on the main path")
    # every route of the paged kernel ran over int8 pools, and the counts
    # are the layers times the decoders' calls of each kind
    layers = cfg.num_layers
    require(set(launches_by) == {("decode", "int8"), ("chunked", "int8")},
            f"serving: paged launches by kind and pool {launches_by}")
    require(calls["target"]["chunked"] > 0 and calls["target"]["verify"] > 0
            and calls["draft"]["decode"] > 0,
            f"serving: a route was not taken: {calls}")
    want_chunked = layers * (calls["target"]["chunked"]
                             + calls["target"]["verify"]
                             + calls["draft"]["chunked"])
    want_decode = layers * (calls["target"]["decode"]
                            + calls["draft"]["decode"])
    want_flash = layers * (calls["target"]["prefill"]
                           + calls["draft"]["prefill"])
    require(launches_by[("chunked", "int8")] == want_chunked
            and launches_by[("decode", "int8")] == want_decode
            and counts["flash_fwd"][0] == want_flash,
            f"serving: launches {launches_by}, flash {counts['flash_fwd']} "
            f"against the decoders' calls {calls}")
    require(by_kernel == {"paged_window_bf16": want_chunked,
                          "paged_decode_split_bf16": want_decode},
            f"serving: paged launches by kernel {by_kernel}")
    dec = snap["step_ms"]["decode"]
    decode_tokens = snap["tokens_total"] - n_req   # the rest from prefill
    out = {"requests": n_req, "tokens": snap["tokens_total"], "wall_s": wall,
           "decode_tok_s": decode_tokens / (dec["mean"] * dec["count"] / 1e3),
           "tok_s_wall": snap["tokens_total"] / wall,
           "ttft_ms_p50": snap["ttft_ms"]["p50"],
           "spec_iteration_ms": dec,
           "prefill_step_ms": snap["step_ms"]["prefill"],
           "occupancy_mean": snap["batch_occupancy"]["mean"],
           "spec": snap["spec"], "prefix": snap["prefix"],
           "kv_pages": srv.kv.num_pages, "pool_bytes": srv.kv.pool_bytes(),
           "pool_bytes_bf16_engine": state.get("engine", {}).get(
               "pool_bytes"),
           "kv_pages_bf16_engine": state.get("engine", {}).get("kv_pages"),
           "decoder_calls": calls,
           "launches": {k: v[0] for k, v in counts.items()},
           "paged_launches_by": {"/".join(k): n
                                 for k, n in launches_by.items()},
           "paged_launches_by_kernel": by_kernel,
           "plain_calls": {k: v[1] for k, v in counts.items()}}
    del srv
    # the greedy prompts again, greedy only, in a 2 x 2 of model and pool
    # types; the float32 model has the same weights
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM
    m32 = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    m32.eval()
    accept = out["greedy_acceptance_by_model_and_pools"] = {
        f"{mname}/{kv or mname}": _greedy_acceptance(
            mdl, prompts[0::2], kv, f"accept-{mname}-{kv or mname}")
        for mname, mdl in (("bfloat16", model), ("float32", m32))
        for kv in ("", "int8")}
    for key in ("float32/float32", "float32/int8"):
        require(accept[key]["greedy_acceptance_rate"] >= GREEDY_ACCEPT_MIN,
                f"serving: greedy spec acceptance {key} below "
                f"{GREEDY_ACCEPT_MIN}: {accept}")
    # the float32 copy's paged work, step by step: one decode step and one
    # verify window over its own and int8 pools, profiled
    out["float32_step_profile"] = {
        kv or "float32": _profile_steps(m32, prompts[:MAX_BATCH], kv)
        for kv in ("", "int8")}
    log("serving: float32 step profiles " + json.dumps(
        out["float32_step_profile"]))
    del m32
    torch.cuda.empty_cache()
    state["serving"] = out
    log("serving: " + json.dumps(out))
    state["spec_profile"] = _profile_spec(model, prompts[:MAX_BATCH])


TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 10          # the timed run_steps window, after 2 warm-up steps
PARITY_LAYERS = 4
# The 4-layer float32 parity, kernels against plain versions, from float32
# summation noise: losses within 1e-5 relative and each step's gradients
# within 1e-4 of each parameter's largest (set before the first run; read
# 0 and 2.05e-5, NVIDIA H100 80GB HBM3, 700 W). Parameters after two AdamW
# steps within 1e-6 (a few ulps of the layer norms' 1.0; read 5.3e-7) at
# every element whose gradient is farther from zero than that gradient
# tolerance. The others (2.6% of the elements here; among them the qkv
# bias's key slots, whose exact gradient is zero) can carry gradients of
# ~1e-9, rounding noise below Adam's eps of 1e-8, which Adam turns into
# updates of up to lr in no agreed direction: there the two paths may
# differ by 2 lr a step, Adam's own bound (read up to 4.1e-5).
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_RTOL = 1e-4
TRAIN_F32_PARAM_ATOL = 1e-6
TRAIN_LR = 1e-4
# MFU's formula (bench.py:428-433): 6 N flops a token for the matmuls
# forward and backward, plus 12 L H S for attention
PEAK_BF16 = 989e12


def _parity_run(cfg, base, ids, use_kernels, amp_level, steps=2,
                amp_dtype="bfloat16", scaler=False):
    """``steps`` TrainStep steps of a fresh model from ``base``'s weights,
    through the kernels or their plain versions (``scaler``: with a
    GradScaler() at its defaults). Returns the losses, the parameters after
    the steps and each step's gradients (recorded by post-accumulate hooks
    as TrainStep's backward finishes each one; scaled when a scaler
    runs)."""
    import torch
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.models.gpt import (GPTAttention,
                                             GPTStackedTransformer)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(base)
    for mod in model.modules():
        if isinstance(mod, (GPTAttention, GPTStackedTransformer)):
            mod.use_kernels = use_kernels
    grads = [{} for _ in range(steps)]
    done = []
    for n, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, n=n: grads[len(done)].__setitem__(
                n, t.grad.detach().clone()))
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level=amp_level, amp_dtype=amp_dtype,
                     scaler=GradScaler() if scaler else None)
    losses = []
    for _ in range(steps):
        losses.append(float(step(ids, ids)))
        done.append(1)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    torch.cuda.empty_cache()
    return losses, params, grads


def _train_parity(state, ids):
    """gpt3_1p3b at full width and PARITY_LAYERS layers: float32, kernels
    against plain versions (losses, gradients, parameters); bf16 O2, the
    kernel path's distance from the float32 plain run against the plain O2
    path's own."""
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    cfg = gpt3_1p3b(num_layers=PARITY_LAYERS)
    base = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                          seed=state["seed"]).state_dict()
    kernels_f32, f32_launches = _counted(
        lambda: _parity_run(cfg, base, ids, True, None))
    runs = {"kernels_f32": kernels_f32,
            "plain_f32": _parity_run(cfg, base, ids, False, None)}
    (kl, kp, kg), (pl, pp, pg) = runs["kernels_f32"], runs["plain_f32"]
    names = list(pp)
    grad_rel, noise = 0.0, {}
    for i, (gk, gp) in enumerate(zip(kg, pg)):
        for n in names:
            require(n in gk and n in gp,
                    f"train parity: {n} got no gradient at step {i + 1}")
            big = float(gp[n].abs().max())
            grad_rel = max(grad_rel, max_abs_err(gk[n], gp[n]) / max(
                big, 1e-30))
            small = gp[n].abs() <= TRAIN_F32_GRAD_RTOL * big
            noise[n] = small if i == 0 else noise[n] | small
    for i in range(PARITY_LAYERS):
        for n in (f"gpt.layers.{i}.attn.qkv_proj.weight",
                  f"gpt.layers.{i}.ln_1.weight"):
            require(float(kg[0][n].abs().max()) > 0,
                    f"train parity: {n}'s gradient is zero")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    param_err, noise_err, n_noise = 0.0, 0.0, 0
    for n in names:
        d = (kp[n] - pp[n]).abs()
        param_err = max(param_err, float(d[~noise[n]].max()))
        if bool(noise[n].any()):
            noise_err = max(noise_err, float(d[noise[n]].max()))
            n_noise += int(noise[n].sum())
    del runs

    def l2(a, b):
        return float(torch.sqrt(sum(((a[n] - b[n]).double() ** 2).sum()
                                    for n in names)))
    ko = _parity_run(cfg, base, ids, True, "O2")
    po = _parity_run(cfg, base, ids, False, "O2")
    o2 = {"losses_kernel": ko[0], "losses_plain": po[0],
          "loss_kernel": max(abs(a - b) for a, b in zip(ko[0], pl)),
          "loss_plain": max(abs(a - b) for a, b in zip(po[0], pl)),
          "params_l2_kernel": l2(ko[1], pp), "params_l2_plain": l2(po[1], pp)}
    out = {"layers": PARITY_LAYERS, "f32_losses": {"kernels": kl,
                                                   "plain": pl},
           "f32_loss_rel": loss_rel, "f32_grad_rel_max": grad_rel,
           "f32_param_max_abs_err": param_err,
           "f32_noise_elements": n_noise,
           "f32_noise_max_abs_err": noise_err, "o2": o2,
           "f32_launches": f32_launches}
    log("train: parity " + json.dumps(out))
    require(loss_rel <= TRAIN_F32_LOSS_RTOL,
            f"train parity: float32 losses differ by {loss_rel:.2e}")
    require(grad_rel <= TRAIN_F32_GRAD_RTOL,
            f"train parity: float32 gradients differ by {grad_rel:.2e} of "
            f"their largest")
    require(param_err <= TRAIN_F32_PARAM_ATOL,
            f"train parity: float32 parameters differ by {param_err:.2e}")
    require(noise_err <= 2 * 2 * TRAIN_LR * (1 + 1e-3),
            f"train parity: noise-level elements differ by {noise_err:.2e}")
    for what in ("loss", "params_l2"):
        k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
        require(k <= BF16_FLOOR_FACTOR * p,
                f"train parity: O2 {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    return out


def _fwd_bwd_peak_gb(model, crit, ids) -> float:
    """The device memory one O2 forward and backward takes above what is
    allocated before it (parameters and optimizer state): the gradients,
    the bf16 weight copies, the activations kept for the backward and the
    logits. The whole step's peak is higher, set by AdamW's foreach
    passes, which allocate their intermediates over every parameter."""
    import torch
    from paddle_tpu_torch.amp import auto_cast
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with auto_cast(level="O2"):
        loss = crit(model(ids), ids)
    loss.float().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for p in model.parameters():
        p.grad = None
    return peak / 1e9


def phase_train(state):
    """gpt3_1p3b, full width and depth, seed 0: TrainStep with AdamW (bf16
    moments) at AMP O2, b=2, s=2048, 2 warm-up steps and a timed
    run_steps(10) on the same batch; the kernels' launch counts are read
    around that window. After it, the 4-layer parity."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b)
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    from paddle_tpu_torch.optimizer import AdamW
    state.pop("model", None)           # the serving model, if any
    torch.cuda.empty_cache()
    cfg = gpt3_1p3b()
    rng = np.random.RandomState(state["seed"])
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           seed=state["seed"])
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level="O2")
    t0 = time.perf_counter()
    losses = [float(step(ids, ids)) for _ in range(2)]
    warm_s = time.perf_counter() - t0
    ca.launches = ca.plain_calls = 0
    for name in cab.KERNELS:
        cab.launches[name] = cab.plain_calls[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = step.run_steps(TRAIN_STEPS, ids, ids)
    wall = time.perf_counter() - t0
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              **{n: (cab.launches[n], cab.plain_calls[n])
                 for n in cab.KERNELS}}
    losses.append(float(last))
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses),
            f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train: the loss did not fall: {losses}")
    for name, (launched, plain) in counts.items():
        require(launched == cfg.num_layers * TRAIN_STEPS,
                f"train: {name} launched {launched} times in "
                f"{TRAIN_STEPS} steps, not {cfg.num_layers} a step")
        require(plain == 0, f"train: {name}'s plain version ran {plain} "
                            f"times on the main path")
    tokens = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS
    n_params = model.num_params()
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * \
        cfg.hidden_size * TRAIN_SEQ
    tok_s = tokens / wall
    prof = device_profile(lambda: (step(ids, ids), torch.cuda.synchronize()),
                          1)
    fwd_bwd = _fwd_bwd_peak_gb(model, crit, ids)
    out = {"config": "gpt3_1p3b", "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "amp": "O2", "moment_dtype": "bfloat16",
           "losses": {"step1": losses[0], "step2": losses[1],
                      f"step{2 + TRAIN_STEPS}": losses[2]},
           "warmup_s": warm_s, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tok_s,
           "mfu": tok_s * flops_per_token / PEAK_BF16,
           "peak_memory_gb": peak / 1e9,
           "fwd_bwd_peak_above_state_gb": fwd_bwd,
           "launches": {k: v[0] for k, v in counts.items()},
           "plain_calls": {k: v[1] for k, v in counts.items()},
           # the profiler slows the host: its wall time per step exceeds
           # the timed window's, so busy time is also read against that
           "device_busy_share_of_step": prof["device_busy_ms_per_step"] /
           (wall / TRAIN_STEPS * 1e3),
           "step_profile": prof}
    log("train: " + json.dumps({k: v for k, v in out.items()
                                if k != "step_profile"}))
    log("train: step profile " + json.dumps(prof))
    del model, opt, step
    torch.cuda.empty_cache()
    out["parity"] = _train_parity(state, ids)
    state["train"] = out


# ------------------------------------------------ the stacked decoder
STACKED_POLICIES = ("full", "attn", "dots", "none")
# flash forward launches a training step per layer, by recompute policy:
# "full" and "dots" run the forward again when they recompute the layer,
# "attn" keeps its (out, lse); the backward kernels run once a layer
STACKED_FWD_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "attn": 1}
LONG_SEQ = 8192           # bench.py --config 1.3b --seq 8192
STACKED_SERVE_REQUESTS, STACKED_SERVE_NEW = 9, 32


def _stacked_serving(state):
    """The stacked bf16 gpt3_1p3b with the engine model's weights: cached
    prefill, 4 decode steps, a chunked window and a verify window over
    stacked bf16 and int8 pools, held against the per-layer model (float32
    within F32_MODEL_LIMIT x std, in lockstep over int8; bf16 within
    BF16_FLOOR_FACTOR x the stacked plain path's distance from the
    per-layer float32 model); then GenerationServer runs on stacked bf16
    and int8 pools with the prefix cache on, the kernels' launch counts
    read around each."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import stack_layer_state
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    model = _model(state)
    cfg = gpt3_1p3b(stacked=True)
    stacked_state = stack_layer_state(model.state_dict())
    sm = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    sm.load_state_dict(stacked_state)
    sm.eval()
    s32 = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    s32.load_state_dict({k: v.float() for k, v in stacked_state.items()})
    s32.eval()
    del stacked_state
    m32 = GPTForCausalLM(model.config, device="cuda", dtype=torch.float32)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    m32.eval()
    state.pop("model")        # the per-layer bf16 model is not needed again
    del model
    rng = np.random.RandomState(state["seed"] + 5)
    b, pps = MAX_BATCH, cfg.max_seq_len // PAGE_SIZE
    lens = rng.permutation(np.linspace(64, 1536, b).astype(np.int32))
    ids = np.zeros((b, cfg.max_seq_len), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg.vocab_size, n)
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    extra = {"chunk": rng.randint(0, cfg.vocab_size, (b, CHUNK_LEN)),
             "verify": rng.randint(0, cfg.vocab_size, (b, SPEC_K))}
    plan = ["decode"] * 4 + ["chunked", "verify"]
    out = {"plan": plan}
    for kv in ("", "int8"):
        what = f"stacked, {kv or 'bf16/f32'} pools vs the per-layer model"
        runs, feed, inner = _model_runs(sm, s32, ids, lens, tables, kv, plan,
                                        extra, ref32=m32, tag="stacked")
        check = _model_check(runs, inner, cfg.vocab_size, what,
                             F32_INT8_MODEL_LIMIT if kv else F32_MODEL_LIMIT,
                             tag="stacked")
        del runs
        if kv:
            lock = _lockstep_f32(s32, ids, lens, tables, plan, extra, feed,
                                 ref32=m32)
            log(f"stacked: {what}: float32 in lockstep (the per-layer plain "
                f"path reads the stacked kernel path's pools), max |kernel "
                f"- plain| / std per step "
                + " ".join(f"{x:.2e}" for x in lock)
                + f" (limit {F32_MODEL_LIMIT})")
            require(max(lock) <= F32_MODEL_LIMIT,
                    f"stacked: int8 pools: float32 in lockstep differs from "
                    f"the per-layer model by {max(lock):.2e} x std")
            check["f32_lockstep_max_err_over_std"] = max(lock)
        out[kv or "bf16"] = check
    del s32, m32
    torch.cuda.empty_cache()

    # GenerationServer on stacked pools: requests sharing a preamble; the
    # first is served alone, so every later admission hits the pages it
    # published (chunked suffix prefills)
    preamble = rng.randint(0, cfg.vocab_size, ENGINE_PREAMBLE)
    prompts = [np.concatenate([preamble, rng.randint(0, cfg.vocab_size, n)])
               for n in rng.randint(32, 513, STACKED_SERVE_REQUESTS)]
    serve = {}
    for kv in ("", "int8"):
        old = _set_kv_dtype(kv)
        try:
            srv = GenerationServer(sm, max_batch=MAX_BATCH,
                                   page_size=PAGE_SIZE, device="cuda",
                                   name=f"stacked{kv}", start=False)
        finally:
            _set_kv_dtype(old)
        require(srv.prefix is not None and isinstance(srv.kv.k, (
            tuple, torch.Tensor)), "stacked: the engine's pools are not "
            "stacked, or the prefix cache is off")
        for mod in (ca, cpa):
            mod.launches = 0
            mod.plain_calls = 0
        cpa.launches_by, cpa.launches_by_kernel = {}, {}
        t0 = time.perf_counter()
        with srv:
            srv.start()
            futs = []
            for i, p in enumerate(prompts):
                futs.append(srv.submit_generate(
                    p, max_new_tokens=STACKED_SERVE_NEW,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    seed=state["seed"] + i))
                if i == 0:
                    futs[0].result(timeout=600)
            toks = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        counts = {"flash_fwd": (ca.launches, ca.plain_calls),
                  "paged_attention": (cpa.launches, cpa.plain_calls)}
        launches_by = dict(cpa.launches_by)
        snap = srv.metrics_snapshot()
        calls = dict(srv.decoder.calls)
        pool = "int8" if kv else "bfloat16"
        want = {("decode", pool): cfg.num_layers * calls["decode"],
                ("chunked", pool): cfg.num_layers * calls["chunked"]}
        row = {"kv_dtype": kv or "bfloat16", "wall_s": wall,
               "tokens": snap["tokens_total"], "prefix": snap["prefix"],
               "decoder_calls": calls, "pool_bytes": srv.kv.pool_bytes(),
               "launches": {k: c[0] for k, c in counts.items()},
               "plain_calls": {k: c[1] for k, c in counts.items()},
               "paged_launches_by": {"/".join(k): n
                                     for k, n in launches_by.items()},
               "paged_launches_by_kernel": dict(cpa.launches_by_kernel),
               "kv_leak_check": snap["kv_leak_check"]["ok"]}
        log("stacked: GenerationServer " + json.dumps(row))
        for i, (f, t) in enumerate(zip(futs, toks)):
            require(f.finish_reason == "length"
                    and len(t) == STACKED_SERVE_NEW
                    and all(0 <= x < cfg.vocab_size for x in t),
                    f"stacked: request {i} ended {f.finish_reason} with "
                    f"{len(t)} tokens")
        require(snap["kv_leak_check"]["ok"],
                f"stacked: leak check {snap['kv_leak_check']}")
        require(snap["prefix"]["hits"] > 0 and calls["chunked"] > 0,
                f"stacked: no prefix hit ({snap['prefix']}, calls {calls})")
        require(launches_by == want and counts["flash_fwd"][0] ==
                cfg.num_layers * calls["prefill"],
                f"stacked: launches {launches_by}, flash "
                f"{counts['flash_fwd']} against the decoder's calls {calls}")
        for name, (_, plain) in counts.items():
            require(plain == 0, f"stacked: {name}'s plain version ran "
                                f"{plain} times on the main path")
        serve[pool] = row
        srv.clear_prefix_cache()
        del srv
        torch.cuda.empty_cache()
    out["serve"] = serve
    del sm
    torch.cuda.empty_cache()
    return out


def _stacked_parity(state, ids):
    """gpt3_1p3b at full width and PARITY_LAYERS layers in float32, the
    per-layer model's weights copied into the stacked decoder: two AdamW
    steps under every recompute policy, through the kernels and through
    their plain versions, each held against the per-layer model's plain
    run (losses within TRAIN_F32_LOSS_RTOL, each step's gradients within
    TRAIN_F32_GRAD_RTOL of each parameter's largest); "none" and "full"
    through the kernels bit for bit; then O2 under "full", the kernel
    path's distance from the float32 run within BF16_FLOOR_FACTOR x the
    plain O2 path's."""
    import torch
    from paddle_tpu_torch.convert import stack_layer_state
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    flat_cfg = gpt3_1p3b(num_layers=PARITY_LAYERS)
    flat = GPTForCausalLM(flat_cfg, device="cuda", dtype=torch.float32,
                          seed=state["seed"]).state_dict()
    base = stack_layer_state(flat)
    rl, rp, rg = _parity_run(flat_cfg, flat, ids, False, None)
    del flat
    rp = stack_layer_state(rp)
    rg = [stack_layer_state(g) for g in rg]
    out, kept, f32_launches = {}, {}, {}
    for policy in ("none", "full", "dots", "attn"):
        cfg = gpt3_1p3b(num_layers=PARITY_LAYERS, stacked=True,
                        recompute=policy)
        for use_kernels in (True, False):
            (losses, _, grads), launches = _counted(
                lambda: _parity_run(cfg, base, ids, use_kernels, None))
            f32_launches = _add_launches(f32_launches, launches)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rl))
            grad_rel = 0.0
            for gs, gr in zip(grads, rg):
                for n, g in gr.items():
                    require(n in gs, f"stacked parity: {policy} {n} got no "
                                     f"gradient")
                    grad_rel = max(grad_rel, max_abs_err(gs[n], g) / max(
                        float(g.abs().max()), 1e-30))
            label = f"{policy}_{'kernels' if use_kernels else 'plain'}"
            out[label] = {"losses": losses, "loss_rel": loss_rel,
                          "grad_rel_max": grad_rel}
            require(loss_rel <= TRAIN_F32_LOSS_RTOL,
                    f"stacked parity: {label} losses differ from the "
                    f"per-layer model's by {loss_rel:.2e}")
            require(grad_rel <= TRAIN_F32_GRAD_RTOL,
                    f"stacked parity: {label} gradients differ from the "
                    f"per-layer model's by {grad_rel:.2e} of their largest")
            if use_kernels and policy in ("none", "full"):
                kept[policy] = (losses, grads)
            del grads
        if policy == "full":
            (ln, gn), (lf, gf) = kept["none"], kept["full"]
            same = ln == lf and all(torch.equal(a[n], b[n])
                                    for a, b in zip(gn, gf) for n in a)
            out["none_equals_full"] = same
            require(same, "stacked parity: recompute 'full' changed the "
                          "float32 losses or gradients of 'none'")
            kept.clear()
    names = list(rp)

    def l2(a, b):
        return float(torch.sqrt(sum(((a[n] - b[n]).double() ** 2).sum()
                                    for n in names)))
    cfg = gpt3_1p3b(num_layers=PARITY_LAYERS, stacked=True, recompute="full")
    ko = _parity_run(cfg, base, ids, True, "O2")
    po = _parity_run(cfg, base, ids, False, "O2")
    o2 = {"losses_kernel": ko[0], "losses_plain": po[0],
          "loss_kernel": max(abs(a - b) for a, b in zip(ko[0], rl)),
          "loss_plain": max(abs(a - b) for a, b in zip(po[0], rl)),
          "params_l2_kernel": l2(ko[1], rp), "params_l2_plain": l2(po[1], rp)}
    out["o2_full"] = o2
    out["f32_launches"] = f32_launches
    log("stacked: parity " + json.dumps(out))
    for what in ("loss", "params_l2"):
        k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
        require(k <= BF16_FLOOR_FACTOR * p,
                f"stacked parity: O2 {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    return out


def _stacked_train(state, recompute, seq, profile=True):
    """gpt3_1p3b(stacked=True, recompute=...) at full width and depth,
    float32 master weights, AdamW with bf16 moments, O2, b=TRAIN_BATCH:
    2 warm-up steps, then a timed run_steps(TRAIN_STEPS) around which the
    kernels' launch counts are read; step ms, tokens/s, MFU (model flops
    only, bench.py's formula), peak memory and, with ``profile``, a
    profile of one step and the forward and backward's own memory."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b)
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt3_1p3b(stacked=True, recompute=recompute,
                    max_seq_len=max(seq, 2048))
    rng = np.random.RandomState(state["seed"])
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, seq))).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           seed=state["seed"])
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level="O2")
    t0 = time.perf_counter()
    losses = [float(step(ids, ids)) for _ in range(2)]
    warm_s = time.perf_counter() - t0
    ca.launches = ca.plain_calls = 0
    for name in cab.KERNELS:
        cab.launches[name] = cab.plain_calls[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = step.run_steps(TRAIN_STEPS, ids, ids)
    wall = time.perf_counter() - t0
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              **{n: (cab.launches[n], cab.plain_calls[n])
                 for n in cab.KERNELS}}
    losses.append(float(last))
    peak = torch.cuda.max_memory_allocated()
    tag = f"stacked train {recompute} s={seq}"
    require(all(math.isfinite(x) for x in losses),
            f"{tag}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{tag}: the loss did not fall: "
                                    f"{losses}")
    per_step = {"flash_fwd": cfg.num_layers
                * STACKED_FWD_PER_LAYER[recompute],
                **{n: cfg.num_layers for n in cab.KERNELS}}
    for name, (launched, plain) in counts.items():
        require(launched == per_step[name] * TRAIN_STEPS,
                f"{tag}: {name} launched {launched} times in {TRAIN_STEPS} "
                f"steps, not {per_step[name]} a step")
        require(plain == 0, f"{tag}: {name}'s plain version ran {plain} "
                            f"times on the main path")
    tokens = TRAIN_BATCH * seq * TRAIN_STEPS
    n_params = model.num_params()
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * \
        cfg.hidden_size * seq
    tok_s = tokens / wall
    out = {"config": f"gpt3_1p3b(stacked=True, recompute={recompute!r}, "
                     f"max_seq_len={cfg.max_seq_len})",
           "params": n_params, "batch": TRAIN_BATCH, "seq": seq, "amp": "O2",
           "moment_dtype": "bfloat16",
           "losses": {"step1": losses[0], "step2": losses[1],
                      f"step{2 + TRAIN_STEPS}": losses[2]},
           "warmup_s": warm_s, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tok_s,
           "mfu": tok_s * flops_per_token / PEAK_BF16,
           "peak_memory_gb": peak / 1e9,
           "launches": {k: v[0] for k, v in counts.items()},
           "launches_per_step": {k: v[0] / TRAIN_STEPS
                                 for k, v in counts.items()},
           "expected_per_step": per_step,
           "plain_calls": {k: v[1] for k, v in counts.items()}}
    if profile:
        prof = device_profile(
            lambda: (step(ids, ids), torch.cuda.synchronize()), 1)
        out["fwd_bwd_peak_above_state_gb"] = _fwd_bwd_peak_gb(model, crit,
                                                               ids)
        out["device_busy_share_of_step"] = prof["device_busy_ms_per_step"] \
            / out["step_ms"]
        out["step_profile"] = prof
    log("stacked: train " + json.dumps({k: v for k, v in out.items()
                                        if k != "step_profile"}))
    if profile:
        log(f"stacked: train {recompute} s={seq} step profile "
            + json.dumps(prof))
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def phase_stacked(state):
    """The layer-stacked decoder with activation recompute: serving on
    stacked pools against the per-layer model, the 4-layer training parity
    under every policy, then the north-star run under each policy at
    s=2048 and the long-context row (recompute "full", s=8192)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    out = {"serving": _stacked_serving(state)}
    rng = np.random.RandomState(state["seed"])
    ids = torch.from_numpy(rng.randint(0, gpt3_1p3b().vocab_size,
                                       (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    out["parity"] = _stacked_parity(state, ids)
    # the policies in turns, forward and back (the host's clock spreads
    # between runs); the first turn of each is also profiled
    turns = {p: [] for p in STACKED_POLICIES}
    for i, p in enumerate(STACKED_POLICIES + STACKED_POLICIES[::-1]):
        turns[p].append(_stacked_train(state, p, TRAIN_SEQ,
                                       profile=i < len(STACKED_POLICIES)))
    out["train"] = {p: dict(runs[0], turns=[
        {k: r[k] for k in ("step_ms", "tokens_per_s", "mfu",
                           "peak_memory_gb", "launches")} for r in runs])
        for p, runs in turns.items()}
    out["train_long"] = _stacked_train(state, "full", LONG_SEQ)
    log("stacked: step ms by policy, in turns "
        + json.dumps({p: [r["step_ms"] for r in runs]
                      for p, runs in turns.items()}))
    state["stacked"] = out


# ------------------------------------------------ the training recipe
RECIPE_DROPOUT = 0.1
# the forced overflow: a scale that overflows float16's range in the
# backward (logits' gradient x 2^40 / 4096 tokens), halved after the second
# bad step
OVERFLOW_SCALE, OVERFLOW_DECR_EVERY = 2.0 ** 40, 2
RESUME_STEPS = 6          # uninterrupted; the resumed run stops after 3
PIPELINE_WORKERS = 2


def _reset_counts():
    """Every flash kernel's launch count and plain-version count, and the
    dense attention's calls, set to 0."""
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    ca.launches = ca.plain_calls = 0
    for name in cab.KERNELS:
        cab.launches[name] = cab.plain_calls[name] = 0
    attn.dense_calls = 0


def _read_counts() -> dict:
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    return {"launches": {"flash_fwd": ca.launches, **dict(cab.launches)},
            "plain_calls": {"flash_fwd": ca.plain_calls,
                            **dict(cab.plain_calls)},
            "dense_calls": attn.dense_calls}


def _counted(fn):
    """``fn()`` with every count set to 0 just before it: its result and
    the launches it made, by kernel."""
    _reset_counts()
    result = fn()
    return result, _read_counts()["launches"]


def _add_launches(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + n for k, n in launches.items()}


def _require_launches(tag, counts, per_step: dict, steps: int) -> None:
    for name, n in per_step.items():
        got = counts["launches"][name]
        require(got == n * steps, f"{tag}: {name} launched {got} times in "
                                  f"{steps} steps, not {n} a step")
        require(counts["plain_calls"][name] == 0,
                f"{tag}: {name}'s plain version ran "
                f"{counts['plain_calls'][name]} times on the main path")


def _train_parts(cfg, seed, amp_dtype="bfloat16", scaler=None, lr=None):
    """A fresh model from ``seed`` (float32 master weights), AdamW with
    bf16 moments, the criterion and an O2 TrainStep."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           seed=seed)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=TRAIN_LR if lr is None else lr,
                parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level="O2", amp_dtype=amp_dtype, scaler=scaler)
    return model, opt, step


def _timed_window(fn, n_steps):
    """Host seconds of ``fn()`` (which ends in a device sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _mfu(n_params, cfg, seq, tok_s) -> float:
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * \
        cfg.hidden_size * seq
    return tok_s * flops_per_token / PEAK_BF16


def _recipe_fp16(state, ids) -> dict:
    """gpt3_1p3b, per-layer, AMP O2 float16 with GradScaler() at its
    defaults, AdamW (bf16 moments): 2 warm-up steps, then a timed
    run_steps(TRAIN_STEPS) around which the launches are read; every step's
    found_inf is kept on the device and summed at the end."""
    import torch
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models import gpt3_1p3b
    cfg = gpt3_1p3b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scaler = GradScaler()
    model, opt, step = _train_parts(cfg, state["seed"], "float16", scaler)
    found = []
    schedule = step._schedule

    def keep_found(st, found_inf):
        found.append(found_inf)
        schedule(st, found_inf)
    step._schedule = keep_found
    t0 = time.perf_counter()
    losses = [float(step(ids, ids)) for _ in range(2)]
    warm_s = time.perf_counter() - t0
    _reset_counts()
    wall, last = _timed_window(
        lambda: step.run_steps(TRAIN_STEPS, ids, ids), TRAIN_STEPS)
    counts = _read_counts()
    losses.append(float(last))
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: (step(ids, ids), torch.cuda.synchronize()),
                          1)
    tok_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall
    out = {"config": "gpt3_1p3b", "amp": "O2 float16",
           "scaler": "GradScaler() defaults", "moment_dtype": "bfloat16",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "losses": {"step1": losses[0], "step2": losses[1],
                      f"step{2 + TRAIN_STEPS}": losses[2]},
           "warmup_s": warm_s, "step_ms": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": tok_s,
           "mfu": _mfu(model.num_params(), cfg, TRAIN_SEQ, tok_s),
           "peak_memory_gb": peak / 1e9,
           "final_scale": scaler.state_dict()["scale"],
           "steps_run": len(found),
           "skipped_steps": int(torch.stack(found).sum()),
           **counts,
           "device_busy_share_of_step": prof["device_busy_ms_per_step"]
           / (wall / TRAIN_STEPS * 1e3)}
    log("recipe: fp16 " + json.dumps(out))
    log("recipe: fp16 step profile " + json.dumps(prof))
    out["step_profile"] = prof
    require(all(math.isfinite(x) for x in losses),
            f"recipe fp16: non-finite loss {losses}")
    require(counts["dense_calls"] == 0,
            "recipe fp16: attention left the flash path")
    _require_launches("recipe fp16", counts,
                      {n: cfg.num_layers for n in counts["launches"]},
                      TRAIN_STEPS)
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _moments(opt) -> dict:
    return {(an, pid): t.clone() for an, store in opt._accumulators.items()
            for pid, t in store.items()}


def _overflow_run(cfg, base, ids, use_kernels) -> dict:
    """One good float16 step, then the scaler reloaded with
    OVERFLOW_SCALE (``load_state_dict`` takes effect at the next call):
    two steps whose gradients overflow must leave every parameter and
    moment bit for bit as they were, and the second bad step halves the
    scale (decr_every_n_nan_or_inf=2)."""
    import torch
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.gpt import GPTAttention
    scaler = GradScaler(init_loss_scaling=OVERFLOW_SCALE,
                        decr_every_n_nan_or_inf=OVERFLOW_DECR_EVERY)
    scaler.load_state_dict({"scale": 2.0 ** 15})
    model, opt, step = _train_parts(cfg, 0, "float16", scaler)
    model.load_state_dict(base)
    for mod in model.modules():
        if isinstance(mod, GPTAttention):
            mod.use_kernels = use_kernels
    good = float(step(ids, ids))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = _moments(opt)
    scaler.load_state_dict({"scale": OVERFLOW_SCALE, "incr_count": 0,
                            "decr_count": 0})
    bad = [float(step(ids, ids))]
    after_one = scaler.state_dict()
    found_one = bool(scaler._found_inf)
    bad.append(float(step(ids, ids)))
    after_two = scaler.state_dict()
    same_p = all(torch.equal(p, params[n])
                 for n, p in model.named_parameters())
    same_m = all(torch.equal(t, moments[key])
                 for key, t in _moments(opt).items())
    out = {"good_loss": good, "bad_losses": bad, "found_inf": [
        found_one, bool(scaler._found_inf)],
        "scale_after": [after_one["scale"], after_two["scale"]],
        "decr_count_after": [after_one["decr_count"],
                             after_two["decr_count"]],
        "params_unchanged": same_p, "moments_unchanged": same_m,
        "moments": len(moments), "step_count": opt._step_count}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _recipe_fp16_parity(state, ids) -> dict:
    """gpt3_1p3b at full width and PARITY_LAYERS layers: two float16 O2
    steps with GradScaler() through the kernels and through the plain
    versions, each one's distance from the float32 plain run (loss; L2
    over all parameters), the kernel path's within BF16_FLOOR_FACTOR x the
    plain path's; then the forced overflow on both paths."""
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    cfg = gpt3_1p3b(num_layers=PARITY_LAYERS)
    base = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                          seed=state["seed"]).state_dict()
    fl, fp, _ = _parity_run(cfg, base, ids, False, None)
    ko = _parity_run(cfg, base, ids, True, "O2", amp_dtype="float16",
                     scaler=True)
    po = _parity_run(cfg, base, ids, False, "O2", amp_dtype="float16",
                     scaler=True)

    def l2(a, b):
        return float(torch.sqrt(sum(((a[n] - b[n]).double() ** 2).sum()
                                    for n in b)))
    out = {"layers": PARITY_LAYERS, "losses_f32": fl,
           "losses_kernel": ko[0], "losses_plain": po[0],
           "loss_kernel": max(abs(a - b) for a, b in zip(ko[0], fl)),
           "loss_plain": max(abs(a - b) for a, b in zip(po[0], fl)),
           "params_l2_kernel": l2(ko[1], fp), "params_l2_plain": l2(po[1], fp)}
    del fp, ko, po
    out["overflow"] = {"kernels": _overflow_run(cfg, base, ids, True),
                       "plain": _overflow_run(cfg, base, ids, False)}
    log("recipe: fp16 parity " + json.dumps(out))
    for what in ("loss", "params_l2"):
        k, p = out[f"{what}_kernel"], out[f"{what}_plain"]
        require(0 < p and k <= BF16_FLOOR_FACTOR * p,
                f"recipe fp16 parity: {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    for path, r in out["overflow"].items():
        tag = f"recipe overflow ({path})"
        require(all(math.isfinite(x) for x in [r["good_loss"]]
                    + r["bad_losses"]), f"{tag}: non-finite loss")
        require(r["found_inf"] == [True, True],
                f"{tag}: found_inf {r['found_inf']}")
        require(r["scale_after"] == [OVERFLOW_SCALE, OVERFLOW_SCALE / 2],
                f"{tag}: scale {r['scale_after']}, not halved after the "
                f"second bad step")
        require(r["params_unchanged"] and r["moments_unchanged"]
                and r["moments"] > 0,
                f"{tag}: a skipped step changed the parameters or moments")
    return out


class _KeptFraction:
    """Counts every dropout mask's kept elements by site, on the device:
    wraps ``keep_mask`` where the dropout layers and the dense attention
    call it. Calls come in the forward's order: the embeddings, then per
    layer the attention probabilities, the attention output and the MLP
    output."""

    SITES = ("embeddings", "attention_probs", "attention_out", "mlp_out")

    def __init__(self, n_layers):
        from paddle_tpu_torch.nn.functional import attention, common
        self.mods = (common, attention)
        self.orig = common.keep_mask
        self.per_forward = 1 + 3 * n_layers
        self.calls = 0
        self.kept = {s: [] for s in self.SITES}
        self.total = dict.fromkeys(self.SITES, 0)

    def _site(self):
        i = self.calls % self.per_forward
        return "embeddings" if i == 0 else self.SITES[1 + (i - 1) % 3]

    def __call__(self, shape, p, device, generator=None):
        keep = self.orig(shape, p, device, generator)
        site = self._site()
        self.kept[site].append(keep.sum())
        self.total[site] += keep.numel()
        self.calls += 1
        return keep

    def __enter__(self):
        for m in self.mods:
            m.keep_mask = self
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.keep_mask = self.orig
        return False

    def fractions(self) -> dict:
        import torch
        return {s: float(torch.stack(self.kept[s]).sum()) / self.total[s]
                for s in self.SITES if self.total[s]}


def _dropout_run(cfg, seed, gen_seed, ids, steps, kept=None) -> dict:
    """``steps`` O2 bf16 steps (one call, then run_steps(steps - 1)) of a
    fresh per-layer model with dropout, its masks drawn from the port's
    default generator seeded with ``gen_seed``."""
    import torch
    from paddle_tpu_torch.framework import random as random_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = _train_parts(cfg, seed)
    random_mod.seed(gen_seed)
    _reset_counts()
    with (kept if kept is not None else contextlib.nullcontext()):
        losses = [float(step(ids, ids))]
        wall = 0.0
        if steps > 1:
            wall, last = _timed_window(
                lambda: step.run_steps(steps - 1, ids, ids), steps - 1)
            losses.append(float(last))
    out = {"losses": losses, "counts": _read_counts(),
           "step_ms": wall / max(steps - 1, 1) * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           # on the host: two full-width copies would crowd the card
           "params": {n: p.detach().cpu()
                      for n, p in model.named_parameters()}}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _recipe_dropout(state, ids) -> dict:
    """gpt3_1p3b(dropout=0.1) at full width and depth, per-layer, O2 bf16:
    one step and run_steps(4). Attention takes the reference's dense path
    (no flash launch, the dense calls counted), two runs from one generator
    seed are bit for bit equal and another seed differs, and each site's
    kept fraction lies within 5 sigma of 0.9."""
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    cfg = gpt3_1p3b(dropout=RECIPE_DROPOUT)
    steps = 5
    kept = _KeptFraction(cfg.num_layers)
    a = _dropout_run(cfg, state["seed"], 1234, ids, steps, kept)
    b = _dropout_run(cfg, state["seed"], 1234, ids, steps)
    same = a["losses"] == b["losses"] and all(
        torch.equal(a["params"][n], p) for n, p in b["params"].items())
    del b
    c = _dropout_run(cfg, state["seed"], 4321, ids, 1)
    differs = c["losses"][0] != a["losses"][0]
    del c
    fractions = kept.fractions()
    sigma = {s: math.sqrt(RECIPE_DROPOUT * (1 - RECIPE_DROPOUT)
                          / kept.total[s]) for s in fractions}
    out = {"config": f"gpt3_1p3b(dropout={RECIPE_DROPOUT})",
           "amp": "O2 bfloat16", "steps": steps, "losses": a["losses"],
           "step_ms": a["step_ms"], "peak_memory_gb": a["peak_memory_gb"],
           **a["counts"], "same_seed_bit_for_bit": same,
           "other_seed_differs": differs, "kept_fraction": fractions,
           "kept_sigma": sigma, "mask_calls": kept.calls}
    del a
    log("recipe: dropout " + json.dumps(out))
    require(all(math.isfinite(x) for x in out["losses"]),
            f"recipe dropout: non-finite loss {out['losses']}")
    for name, n in out["launches"].items():
        require(n == 0, f"recipe dropout: {name} launched {n} times; "
                        f"attention with dropout takes the dense path")
    require(out["dense_calls"] == cfg.num_layers * steps,
            f"recipe dropout: {out['dense_calls']} dense attention calls, "
            f"not {cfg.num_layers} a step")
    require(kept.calls == (1 + 3 * cfg.num_layers) * steps,
            f"recipe dropout: {kept.calls} masks drawn")
    require(same, "recipe dropout: two runs from one seed differ")
    require(differs, "recipe dropout: another seed gave the same loss")
    for s, f in fractions.items():
        require(abs(f - (1 - RECIPE_DROPOUT)) <= 5 * sigma[s],
                f"recipe dropout: {s} kept {f:.6f}, beyond 5 sigma "
                f"({sigma[s]:.2e}) of {1 - RECIPE_DROPOUT}")
    return out


def _loader(n_batches, vocab, seq):
    """bench.py's token dataset (``paddle_tpu_torch.bench.TokenDataset``)
    through io.DataLoader."""
    from paddle_tpu_torch.bench import TokenDataset
    from paddle_tpu_torch.io import DataLoader
    return DataLoader(TokenDataset(n_batches * TRAIN_BATCH, vocab, seq),
                      batch_size=TRAIN_BATCH, shuffle=False,
                      num_workers=PIPELINE_WORKERS, drop_last=True)


def _recipe_pipeline(state) -> dict:
    """The north star, gpt3_1p3b(stacked=True, recompute="full"), O2 bf16,
    fed by io.DataLoader (2 workers, the shared-memory ring): 2 warm-up
    steps, then TRAIN_STEPS steps each on the loader's next batch, against
    run_steps(TRAIN_STEPS) on one resident batch (bench.py's "with input
    pipeline" row). The ring must carry every batch."""
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    cfg = gpt3_1p3b(stacked=True, recompute="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = _train_parts(cfg, state["seed"])
    loader = _loader(2 + TRAIN_STEPS, cfg.vocab_size, TRAIN_SEQ)
    batches = iter(loader)
    first = next(batches)
    losses = [float(step(first, first))]
    b = next(batches)
    losses.append(float(step(b, b)))
    _reset_counts()

    def fed():
        loss = None
        for b in batches:
            loss = step(b, b)
        return loss
    wall, last = _timed_window(fed, TRAIN_STEPS)
    counts = _read_counts()
    losses.append(float(last))
    ids = first.cuda()
    same_wall, _ = _timed_window(
        lambda: step.run_steps(TRAIN_STEPS, ids, ids), TRAIN_STEPS)
    out = {"config": "gpt3_1p3b(stacked=True, recompute='full')",
           "amp": "O2 bfloat16", "workers": PIPELINE_WORKERS,
           "losses": losses, "step_ms": wall / TRAIN_STEPS * 1e3,
           "same_batch_step_ms": same_wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ring_pushes": loader.ring_pushes,
           "queue_payloads": loader.queue_payloads, **counts}
    out["mfu"] = _mfu(model.num_params(), cfg, TRAIN_SEQ,
                      out["tokens_per_s"])
    log("recipe: input pipeline " + json.dumps(out))
    require(all(math.isfinite(x) for x in losses),
            f"recipe pipeline: non-finite loss {losses}")
    require(loader.ring_pushes == 2 + TRAIN_STEPS
            and loader.queue_payloads == 0,
            f"recipe pipeline: ring pushes {loader.ring_pushes}, queue "
            f"payloads {loader.queue_payloads}")
    _require_launches("recipe pipeline", counts,
                      {"flash_fwd": 2 * cfg.num_layers,
                       "flash_bwd_dq": cfg.num_layers,
                       "flash_bwd_dkv": cfg.num_layers}, TRAIN_STEPS)
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _resume_parts(cfg, seed):
    """Model, optimizer (an LR schedule), scaler and step of the resume
    check: float16 O2 with a GradScaler whose scale doubles every 2 good
    steps, so that every piece of state moves."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import lr as plr
    sched = plr.CosineAnnealingDecay(learning_rate=TRAIN_LR, T_max=20)
    scaler = GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    model, opt, step = _train_parts(cfg, seed, "float16", scaler, lr=sched)
    return model, opt, scaler, sched, step


def _recipe_resume(state) -> dict:
    """The north star cut to PARITY_LAYERS layers, with embedding dropout
    (the stacked decoder applies none), float16 O2 with a GradScaler and a
    cosine LR schedule, on batches from io.DataLoader: RESUME_STEPS steps
    straight through, against half of them, a save of the model, the
    optimizer (accumulators, LR_Scheduler, @step), the scaler and the
    generator, fresh objects built from another seed, a load, and the other
    half. Losses and parameters must match bit for bit."""
    import tempfile
    import torch
    from paddle_tpu_torch.framework import random as random_mod
    from paddle_tpu_torch.framework.io import load, save
    from paddle_tpu_torch.models import gpt3_1p3b
    cfg = gpt3_1p3b(stacked=True, recompute="full",
                    num_layers=PARITY_LAYERS, dropout=RECIPE_DROPOUT)
    batches = [b.cuda() for b in _loader(RESUME_STEPS, cfg.vocab_size,
                                         TRAIN_SEQ)]
    half = RESUME_STEPS // 2

    def run(step, sched, bs):
        out = []
        for b in bs:
            out.append(float(step(b, b)))
            sched.step()
        return out

    model, _, _, sched, step = _resume_parts(cfg, state["seed"])
    random_mod.seed(77)
    straight = run(step, sched, batches)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, step
    model, opt, scaler, sched, step = _resume_parts(cfg, state["seed"])
    random_mod.seed(77)
    first = run(step, sched, batches[:half])
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: f"{tmp}/ckpt.{k}" for k in ("pdparams", "pdopt",
                                                 "pdscaler", "pdrng")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(model.state_dict(), files["pdparams"])
        save(opt.state_dict(), files["pdopt"])
        save(scaler.state_dict(), files["pdscaler"])
        save(random_mod.get_rng_state(), files["pdrng"])
        save_s = time.perf_counter() - t0
        size = sum(Path(f).stat().st_size for f in files.values())
        del model, opt, scaler, sched, step
        torch.cuda.empty_cache()
        model, opt, scaler, sched, step = _resume_parts(cfg,
                                                        state["seed"] + 1)
        random_mod.seed(1)
        t0 = time.perf_counter()
        model.load_state_dict(load(files["pdparams"]))
        opt.set_state_dict(load(files["pdopt"]))
        scaler.load_state_dict(load(files["pdscaler"]))
        random_mod.set_rng_state(load(files["pdrng"]))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    resumed = first + run(step, sched, batches[half:])
    same_p = all(torch.equal(p, want[n]) for n, p in
                 model.named_parameters())
    out = {"config": f"gpt3_1p3b(stacked=True, recompute='full', "
                     f"num_layers={PARITY_LAYERS}, dropout="
                     f"{RECIPE_DROPOUT})",
           "amp": "O2 float16 + GradScaler(incr_every_n_steps=2)",
           "steps": RESUME_STEPS, "stopped_after": half,
           "losses_straight": straight, "losses_resumed": resumed,
           "params_bit_for_bit": same_p,
           "final_scale": scaler.state_dict()["scale"],
           "step_count": opt._step_count, "checkpoint_bytes": size,
           "save_s": save_s, "load_s": load_s}
    log("recipe: resume " + json.dumps(out))
    require(straight == resumed, f"recipe resume: losses differ: "
                                 f"{straight} against {resumed}")
    require(same_p, "recipe resume: parameters differ after the resume")
    require(opt._step_count == RESUME_STEPS,
            f"recipe resume: step count {opt._step_count}")
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def phase_recipe(state):
    """Training as the reference's users run it: float16 with dynamic loss
    scaling on the float16 flash kernels (full width and depth, then a
    4-layer parity and a forced overflow), dropout at full width through
    the reference's dense attention, and the north star fed by
    io.DataLoader, then stopped and resumed from a checkpoint."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    state.pop("model", None)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(state["seed"])
    ids = torch.from_numpy(rng.randint(0, gpt3_1p3b().vocab_size,
                                       (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    out = {"fp16": _recipe_fp16(state, ids),
           "fp16_parity": _recipe_fp16_parity(state, ids),
           "dropout": _recipe_dropout(state, ids),
           "pipeline": _recipe_pipeline(state),
           "resume": _recipe_resume(state)}
    state["recipe"] = out


# ------------------------------------------------ bench.py's other configs
# the families phase drives paddle_tpu_torch.bench's own functions, a short
# window each: K steps timed after a warm-up window of K and one counted step
FAMILY_STEPS = 4
FAMILY_GPT = ("small", "medium", "large")
BERT_PARITY_LAYERS = 4
# recompute against stored activations, float32, dropout 0.1: the same
# masks, so the gradients differ only by float32 sums in another order
RECOMPUTE_GRAD_RTOL = 1e-6
ERNIE_10B_BATCH = 4
ENCODER_SEQ = 512
RESNET_CHECK_BATCH, RESNET_CHECK_HW = 8, 112
# resnet18, one Momentum step on the card against the CPU on 8 images of
# 112² (_resnet_card_vs_cpu). Loss and statistics set from the CPU's own
# float32 step against its float64 step (1.4e-7; 8.2e-7 of their
# largest). The update's L2 (H100 80GB HBM3, 700 W): the card's float32
# against the CPU's read 5.6e-3 and the TF32-on control 9.0e-2, so the
# limit sits between them, 3.6x above the one and 4.5x under the other;
# float64 against float64 read 8.4e-15 and float32 against float64 (the
# CPU's) 2.2e-3, so the float64 limit sits far from both
RESNET_LOSS_RTOL = 1e-5
RESNET_STATS_RTOL = 1e-4
RESNET_UPDATE_RTOL = 2e-2
RESNET_UPDATE_F64_RTOL = 1e-9


def _bench(*argv):
    """``paddle_tpu_torch.bench.run`` on ``argv`` with the counts set to 0
    just before and read just after: the details and the counts."""
    from paddle_tpu_torch import bench
    args = bench.build_parser().parse_args(
        list(argv) + ["--steps", str(FAMILY_STEPS), "--windows", "1"])
    _reset_counts()
    out = bench.run(args)
    return out, _read_counts()


def _release():
    """Give the allocator's cache back once the caller dropped a model."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _family_gpt(config) -> dict:
    """bench.py's GPT-2 config at its batch and length, full depth."""
    out, counts = _bench("--config", config)
    cfg, rec = out["config"], out["record"]
    L = cfg.num_layers
    fwd = 2 * L if cfg.stacked and cfg.recompute in ("full", "dots") else L
    _require_launches(f"families {config}", counts,
                      {"flash_fwd": fwd, "flash_bwd_dq": L,
                       "flash_bwd_dkv": L}, out["steps_run"])
    row = {"config": config, "metric": rec["metric"],
           "batch": out["batch"], "seq": out["seq"],
           "params": out["params"], "stacked": cfg.stacked,
           "recompute": cfg.recompute if cfg.stacked else None,
           "tokens_per_s": out["tokens_per_s"], "step_ms": out["step_ms"],
           "mfu": out["mfu"], "vs_baseline": rec["vs_baseline"],
           "peak_memory_gb": out["peak_gb"], "final_loss": out["final_loss"],
           "cost_model": rec["cost_model"], "steps_run": out["steps_run"],
           **counts}
    log(f"families: {config} " + json.dumps(row))
    require(math.isfinite(out["final_loss"]),
            f"families {config}: non-finite loss")
    require(rec["cost_model"]["agrees"],
            f"families {config}: counted FLOPs disagree with the hand "
            f"formula: {rec['cost_model']['ratios']}")
    del out
    _release()
    return row


def _family_bert() -> dict:
    """bench.py --config bert: BERT-base MLM+NSP at b=32 s=512, O2, on the
    bidirectional flash kernels (12 launches of each a step, no plain or
    dense call); then one more step under the profiler."""
    import torch
    out, counts = _bench("--config", "bert")
    cfg, rec = out["config"], out["record"]
    L = cfg.num_layers
    _require_launches("families bert", counts,
                      {"flash_fwd": L, "flash_bwd_dq": L,
                       "flash_bwd_dkv": L}, out["steps_run"])
    require(counts["dense_calls"] == 0,
            f"families bert: {counts['dense_calls']} dense attention calls")
    prof = device_profile(lambda: (out["one_step"](),
                                   torch.cuda.synchronize()), 1)
    row = {"config": "bert", "metric": rec["metric"],
           "batch": out["batch"], "seq": out["seq"],
           "params": out["params"], "tokens_per_s": out["tokens_per_s"],
           "step_ms": out["step_ms"], "mfu": out["mfu"],
           "vs_baseline": rec["vs_baseline"],
           "peak_memory_gb": out["peak_gb"], "final_loss": out["final_loss"],
           "cost_model": rec["cost_model"], "steps_run": out["steps_run"],
           "device_busy_share_of_step": prof["device_busy_ms_per_step"]
           / out["step_ms"], "step_profile": prof, **counts}
    log("families: bert " + json.dumps({k: v for k, v in row.items()
                                        if k != "step_profile"}))
    log("families: bert step profile " + json.dumps(prof))
    require(math.isfinite(out["final_loss"]), "families bert: non-finite "
                                              "loss")
    require(rec["cost_model"]["agrees"],
            f"families bert: counted FLOPs disagree with the hand formula: "
            f"{rec['cost_model']['ratios']}")
    del out
    _release()
    return row


def _bert_batch(b, s, vocab, seed, lengths=None):
    """ids, MLM labels (dense ids), NSP labels and, with ``lengths``, token
    types and the additive padding mask ``[b, 1, 1, s]`` (-1e4 past each
    row's length)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, vocab, (b, s))).cuda()
    nsp = torch.from_numpy(rng.randint(0, 2, (b,))).cuda()
    if lengths is None:
        return ids, nsp
    mask = torch.zeros(b, 1, 1, s, device="cuda")
    for i, n in enumerate(lengths):
        mask[i, ..., n:] = -1e4
    return ids, nsp, torch.zeros_like(ids), mask


def _bert_parts(cfg, base, use_kernels, amp_level=None, lr=TRAIN_LR):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.models.bert import BertSelfAttention
    from paddle_tpu_torch.optimizer import AdamW
    model = BertForPretraining(cfg, device="cuda", dtype=torch.float32)
    if base is not None:
        model.load_state_dict(base)
    for mod in model.modules():
        if isinstance(mod, BertSelfAttention):
            mod.use_kernels = use_kernels
    crit = BertPretrainingCriterion(ignore_index=-1000)
    opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
    step = TrainStep(model, lambda out, y, nsp: crit(out, y, nsp), opt,
                     amp_level=amp_level)
    return model, step


def _bert_run(cfg, base, batch, use_kernels, amp_level=None, steps=2,
              n_inputs=1):
    """``steps`` AdamW steps of BertForPretraining from ``base``'s weights:
    losses, parameters after, each step's gradients."""
    model, step = _bert_parts(cfg, base, use_kernels, amp_level)
    grads = [{} for _ in range(steps)]
    done = []
    for n, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, n=n: grads[len(done)].__setitem__(
                n, t.grad.detach().clone()))
    losses = []
    for _ in range(steps):
        losses.append(float(step(*batch, n_inputs=n_inputs)))
        done.append(1)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, step
    _release()
    return losses, params, grads


def _grad_rel(ga, gb) -> float:
    """max over steps and parameters of max|a - b| / max|b|."""
    worst = 0.0
    for a, b in zip(ga, gb):
        for n in b:
            require(n in a, f"{n} got no gradient")
            worst = max(worst, max_abs_err(a[n], b[n]) / max(
                float(b[n].abs().max()), 1e-30))
    return worst


def _l2(a, b) -> float:
    import torch
    return float(torch.sqrt(sum(((a[n] - b[n]).double() ** 2).sum()
                                for n in b)))


def _bert_parity(seed) -> dict:
    """BERT-base cut to 4 layers at b=32 s=512: float32 through the flash
    kernels against their plain versions (the train phase's limits), and
    O2 by the rounding-floor rule."""
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    import torch
    cfg = bert_base(num_layers=BERT_PARITY_LAYERS, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    base = BertForPretraining(cfg, device="cuda", seed=seed).state_dict()
    ids, nsp = _bert_batch(32, ENCODER_SEQ, cfg.vocab_size, seed)
    batch = (ids, ids, nsp)
    (kl, kp, kg), f32_launches = _counted(
        lambda: _bert_run(cfg, base, batch, True))
    pl, pp, pg = _bert_run(cfg, base, batch, False)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    grad_rel = _grad_rel(kg, pg)
    ko = _bert_run(cfg, base, batch, True, "O2")
    po = _bert_run(cfg, base, batch, False, "O2")
    o2 = {"loss_kernel": max(abs(a - b) for a, b in zip(ko[0], pl)),
          "loss_plain": max(abs(a - b) for a, b in zip(po[0], pl)),
          "params_l2_kernel": _l2(ko[1], pp),
          "params_l2_plain": _l2(po[1], pp)}
    out = {"layers": BERT_PARITY_LAYERS, "batch": 32, "seq": ENCODER_SEQ,
           "f32_losses": {"kernels": kl, "plain": pl},
           "f32_loss_rel": loss_rel, "f32_grad_rel_max": grad_rel, "o2": o2,
           "f32_launches": f32_launches}
    log("families: bert parity " + json.dumps(out))
    require(loss_rel <= TRAIN_F32_LOSS_RTOL,
            f"bert parity: float32 losses differ by {loss_rel:.2e}")
    require(grad_rel <= TRAIN_F32_GRAD_RTOL,
            f"bert parity: float32 gradients differ by {grad_rel:.2e} of "
            f"their largest")
    for what in ("loss", "params_l2"):
        k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
        require(k <= BF16_FLOOR_FACTOR * p,
                f"bert parity: O2 {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    del base
    torch.cuda.empty_cache()
    return out


def _bert_masked(seed) -> dict:
    """BERT-base at b=32 s=512 with a padding mask (ragged lengths in one
    batch), O2: the reference's dense path, 12 calls a step, no flash
    launch."""
    import numpy as np
    from paddle_tpu_torch.models import bert_base
    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    lengths = np.random.RandomState(seed).randint(64, ENCODER_SEQ + 1, 32)
    lengths[0] = ENCODER_SEQ
    ids, nsp, tt, mask = _bert_batch(32, ENCODER_SEQ, cfg.vocab_size, seed,
                                     lengths)
    model, step = _bert_parts(cfg, None, True, "O2")
    batch = (ids, tt, mask, ids, nsp)
    step(*batch, n_inputs=3)
    _reset_counts()
    wall, loss = _timed_window(lambda: step.run_steps(
        FAMILY_STEPS, *batch, n_inputs=3), FAMILY_STEPS)
    counts = _read_counts()
    out = {"lengths": [int(x) for x in lengths[:8]] + ["..."],
           "step_ms": wall / FAMILY_STEPS * 1e3, "loss": float(loss),
           **counts}
    log("families: bert padded " + json.dumps(out))
    require(math.isfinite(out["loss"]), "bert padded: non-finite loss")
    require(counts["dense_calls"] == cfg.num_layers * FAMILY_STEPS,
            f"bert padded: {counts['dense_calls']} dense calls in "
            f"{FAMILY_STEPS} steps, not {cfg.num_layers} a step")
    require(all(v == 0 for v in counts["launches"].values()),
            f"bert padded: flash launches {counts['launches']}")
    del model, step
    _release()
    return out


def _bert_dropout_recompute(seed) -> dict:
    """BERT-base cut to 4 layers, float32, dropout 0.1 (the dense path):
    two runs from one generator seed bit for bit; recompute=True against
    False from one seed, the gradients within RECOMPUTE_GRAD_RTOL of each
    parameter's largest (the masks replay in the recompute)."""
    from paddle_tpu_torch.framework import random as random_mod
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    runs = {}
    for tag, rc in (("stored", False), ("stored_again", False),
                    ("recompute", True)):
        cfg = bert_base(num_layers=BERT_PARITY_LAYERS, recompute=rc,
                        hidden_dropout_prob=RECIPE_DROPOUT,
                        attention_probs_dropout_prob=RECIPE_DROPOUT)
        base = BertForPretraining(cfg, device="cuda",
                                  seed=seed).state_dict()
        ids, nsp = _bert_batch(8, ENCODER_SEQ, cfg.vocab_size, seed)
        random_mod.seed(seed + 7)
        runs[tag] = _bert_run(cfg, base, (ids, ids, nsp), True)
    (sl, sp, sg), (al, ap, ag) = runs["stored"], runs["stored_again"]
    repeat = sl == al and all(
        bool((sg[i][n] == ag[i][n]).all()) for i in range(2) for n in sg[i])
    rl, rp, rg = runs["recompute"]
    grad_rel = _grad_rel(rg, sg)
    out = {"losses": {k: v[0] for k, v in runs.items()},
           "bit_for_bit_repeat": repeat,
           "recompute_grad_rel_max": grad_rel}
    log("families: bert dropout+recompute " + json.dumps(out))
    require(repeat, "bert dropout: one seed did not repeat bit for bit")
    require(grad_rel <= RECOMPUTE_GRAD_RTOL,
            f"bert dropout: recompute's gradients differ by {grad_rel:.2e} "
            f"of their largest")
    return out


def _ernie(seed) -> dict:
    """ernie_base sequence classification at b=32 s=512 with task types and
    a padding mask (O2, a few steps); then ernie_3_0_10b's forward under
    no_grad in bf16 at full width and depth, b=4 s=512, built on the card
    in bf16."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ErnieModel, ernie_3_0_10b,
                                         ernie_base)
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    cfg = ernie_base(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = ErnieForSequenceClassification(cfg, device="cuda", seed=seed)
    step = TrainStep(model, lambda o, y: cross_entropy(o, y),
                     AdamW(learning_rate=TRAIN_LR,
                           parameters=model.named_parameters()),
                     amp_level="O2")
    rng = np.random.RandomState(seed)
    lengths = rng.randint(64, ENCODER_SEQ + 1, 32)
    ids, _, tt, mask = _bert_batch(32, ENCODER_SEQ, cfg.vocab_size, seed,
                                   lengths)
    task = torch.from_numpy(rng.randint(0, 16, (32, ENCODER_SEQ))).cuda()
    y = torch.from_numpy(rng.randint(0, 2, (32,))).cuda()
    batch = (ids, tt, task, mask, y)
    step(*batch, n_inputs=4)
    wall, loss = _timed_window(lambda: step.run_steps(
        FAMILY_STEPS, *batch, n_inputs=4), FAMILY_STEPS)
    base = {"step_ms": wall / FAMILY_STEPS * 1e3, "loss": float(loss)}
    require(math.isfinite(base["loss"]), "ernie_base: non-finite loss")
    del model, step
    _release()

    big = ernie_3_0_10b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ErnieModel(big, device="cuda", dtype=torch.bfloat16, seed=seed)
    model.eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.from_numpy(rng.randint(0, big.vocab_size,
                                       (ERNIE_10B_BATCH, ENCODER_SEQ))).cuda()
    with torch.no_grad():
        model(ids)                                # warm-up
        _reset_counts()
        h, pooled = model(ids)
        torch.cuda.synchronize()
        counts = _read_counts()
        fwd_ms = device_ms(lambda: model(ids), iters=3, warmup=0)
    out = {"ernie_base": base,
           "ernie_3_0_10b": {"params": model.num_params(),
                             "batch": ERNIE_10B_BATCH, "seq": ENCODER_SEQ,
                             "build_s": build_s, "forward_ms": fwd_ms,
                             "peak_memory_gb":
                                 torch.cuda.max_memory_allocated() / 1e9,
                             **counts}}
    log("families: ernie " + json.dumps(out))
    require(bool(torch.isfinite(h.float()).all())
            and bool(torch.isfinite(pooled.float()).all()),
            "ernie_3_0_10b: non-finite output")
    _require_launches("ernie_3_0_10b forward", counts,
                      {"flash_fwd": big.num_layers}, 1)
    del model, h, pooled
    _release()
    return out


def _resnet_step(seed, init, x, y, device, dtype):
    """One Momentum(0.1, 0.9) step of resnet18 (NHWC) from ``init`` on
    ``device`` in ``dtype``: the loss, each parameter's update and the
    BatchNorm statistics after it, in float64 on the CPU."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    # .to() takes the statistics along (the layer keeps them float32)
    model = resnet18(data_format="NHWC", device=device, seed=seed).to(dtype)
    model.load_state_dict(init)
    step = TrainStep(model, lambda o, t: cross_entropy(o, t),
                     Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=model.named_parameters()))
    loss = float(step(x.to(device, dtype), y.to(device)))
    update = {k: p.detach().cpu().double() - init[k].double()
              for k, p in model.named_parameters()}
    stats = {k: b.detach().cpu().double() for k, b in model.named_buffers()}
    return loss, update, stats


def _l2_rel(a, b) -> float:
    """||a − b|| / ||b|| over every tensor of the dicts together."""
    return math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
                     / sum(float((b[k] ** 2).sum()) for k in b))


def _resnet_card_vs_cpu(seed) -> dict:
    """resnet18 (NHWC): one Momentum(0.1, 0.9) step on the card against the
    same step on the CPU from the same weights and images. float32 with
    TF32 off (cuDNN's default would round convolutions to TF32): the loss
    within RESNET_LOSS_RTOL, each BatchNorm statistic within
    RESNET_STATS_RTOL of its largest, and the step's update (the
    parameters' change, ``lr`` times the gradient) within
    RESNET_UPDATE_RTOL in L2 over the model; the same step with TF32 on
    is the control, and must read above that limit. float64 on both: the
    update within RESNET_UPDATE_F64_RTOL, which the float32 step's own
    distance from float64 must exceed. Not each parameter alone: at random
    weights the training-mode backward amplifies rounding through the
    batch statistics and the ReLUs, so float32 fixes this update only to
    a few 1e-3 (RESNET_UPDATE_RTOL's comment)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.vision.models import resnet18
    require(not torch.backends.cudnn.allow_tf32,
            "resnet18 check: TF32 must be off for cuDNN")
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(RESNET_CHECK_BATCH, RESNET_CHECK_HW,
                                   RESNET_CHECK_HW, 3).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 1000, (RESNET_CHECK_BATCH,)))
    init = {k: v.clone() for k, v in resnet18(
        data_format="NHWC", device="cpu", seed=seed).state_dict().items()}
    f32, f64 = torch.float32, torch.float64
    runs = {"cpu": _resnet_step(seed, init, x, y, "cpu", f32),
            "card": _resnet_step(seed, init, x, y, "cuda", f32),
            "cpu_f64": _resnet_step(seed, init, x, y, "cpu", f64),
            "card_f64": _resnet_step(seed, init, x, y, "cuda", f64)}
    with bench.tf32(True):
        runs["card_tf32"] = _resnet_step(seed, init, x, y, "cuda", f32)
    (lc, uc, sc), (lg, ug, sg) = runs["cpu"], runs["card"]
    stats = [k for k in sc if k.endswith(("._mean", "._variance"))]
    out = {"batch": RESNET_CHECK_BATCH, "hw": RESNET_CHECK_HW,
           "loss_cpu": lc, "loss_card": lg, "loss_rel": abs(lg - lc) / lc,
           "stats_rel_max": max(max_abs_err(sg[k], sc[k])
                                / float(sc[k].abs().max()) for k in stats),
           "update_l2_rel": _l2_rel(ug, uc),
           "control_tf32_update_l2_rel": _l2_rel(runs["card_tf32"][1], uc),
           "update_l2_rel_f64": _l2_rel(runs["card_f64"][1],
                                        runs["cpu_f64"][1]),
           "control_f32_vs_f64_update_l2_rel": _l2_rel(
               uc, runs["cpu_f64"][1])}
    log("families: resnet18 card vs cpu " + json.dumps(out))
    require(out["loss_rel"] <= RESNET_LOSS_RTOL,
            f"resnet18: losses differ by {out['loss_rel']:.2e}")
    require(out["stats_rel_max"] <= RESNET_STATS_RTOL,
            f"resnet18: BatchNorm statistics differ by "
            f"{out['stats_rel_max']:.2e} of their largest")
    require(out["update_l2_rel"] <= RESNET_UPDATE_RTOL
            < out["control_tf32_update_l2_rel"],
            f"resnet18: float32 updates differ by {out['update_l2_rel']:.2e} "
            f"in L2 (TF32 control {out['control_tf32_update_l2_rel']:.2e}, "
            f"limit {RESNET_UPDATE_RTOL:.0e} between them)")
    require(out["update_l2_rel_f64"] <= RESNET_UPDATE_F64_RTOL
            < out["control_f32_vs_f64_update_l2_rel"],
            f"resnet18: float64 updates differ by "
            f"{out['update_l2_rel_f64']:.2e} in L2 (float32's own distance "
            f"{out['control_f32_vs_f64_update_l2_rel']:.2e}, limit "
            f"{RESNET_UPDATE_F64_RTOL:.0e} between them)")
    return out


def _family_resnet() -> dict:
    """bench.py --config resnet50: b=128, 224², NHWC (channels-last), O2,
    Momentum(0.1, 0.9); the BatchNorm statistics must move."""
    import torch
    out, _ = _bench("--config", "resnet50")
    rec, model = out["record"], out["model"]
    moved = float(model.bn1._mean.abs().max())
    prof = device_profile(lambda: (out["one_step"](),
                                   torch.cuda.synchronize()), 1)
    row = {"config": "resnet50", "metric": rec["metric"],
           "batch": out["batch"], "params": out["params"],
           "images_per_s": out["images_per_s"], "step_ms": out["step_ms"],
           "mfu": out["mfu"], "vs_baseline": rec["vs_baseline"],
           "cost_model": rec["cost_model"],
           "peak_memory_gb": out["peak_gb"], "final_loss": out["final_loss"],
           "bn1_mean_max_abs": moved,
           "device_busy_share_of_step": prof["device_busy_ms_per_step"]
           / out["step_ms"], "step_profile": prof}
    log("families: resnet50 " + json.dumps({k: v for k, v in row.items()
                                            if k != "step_profile"}))
    log("families: resnet50 step profile " + json.dumps(prof))
    require(math.isfinite(out["final_loss"]), "resnet50: non-finite loss")
    require(moved > 0, "resnet50: BatchNorm's running mean did not move")
    require(next(model.parameters()).dtype == torch.float32
            and model.bn1._mean.dtype == torch.float32,
            "resnet50: master weights or statistics are not float32")
    del out, model
    _release()
    return row


def phase_families(state):
    """bench.py's other configurations through paddle_tpu_torch.bench's own
    functions: GPT-2 small, medium and large at their batch and length,
    BERT-base pretraining on the bidirectional flash kernels (and its
    parity, padding-mask and dropout+recompute runs), ERNIE (base training,
    the 10B forward) and ResNet-50 (and resnet18 against the CPU)."""
    import torch
    state.pop("model", None)
    torch.cuda.empty_cache()
    seed = state["seed"]
    out = {"gpt": [_family_gpt(c) for c in FAMILY_GPT],
           "bert": _family_bert(), "bert_parity": _bert_parity(seed),
           "bert_padded": _bert_masked(seed),
           "bert_dropout_recompute": _bert_dropout_recompute(seed),
           "ernie": _ernie(seed), "resnet50": _family_resnet(),
           "resnet18_card_vs_cpu": _resnet_card_vs_cpu(seed)}
    state["families"] = out


INFER_BATCH, INFER_SEQ = 8, 128     # bench_inference's ERNIE-base shape
INFER_ITERS = 50                    # Predictor.run calls timed a precision
RESNET_BATCH, RESNET_SIZE = 8, 224  # bench_inference's ResNet-50 shape
SERVER_REQUESTS, SERVER_CLIENTS = 512, 4
SERVER_MAX_BATCH, SERVER_BUCKETS = 16, (128, 256, 512)
SERVER_MIN_LEN = 16
PROFILE_REQUESTS = 128              # the profiled window of server batches

# The child process that loads the saved artifacts (nothing of the process
# that exported them), with the numerics this script runs under: TF32 off
# for matmuls and cuDNN, no reduced-precision bf16 reductions.
_PREDICTOR_CHILD = r"""
import json, sys
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
from paddle_tpu_torch import inference
from paddle_tpu_torch.bench_inference import bench_predictor
from paddle_tpu_torch.ops import cuda_attention as ca
out = {}
for job in json.loads(sys.argv[1]):
    feeds = [np.load(job["feed"])]
    pred = inference.create_predictor(inference.Config(job["prefix"]))
    launches, plain = ca.launches, ca.plain_calls
    np.save(job["out"], np.asarray(pred.run(feeds)[0], np.float32))
    row = {"device": str(pred.device),
           "launches_per_run": ca.launches - launches,
           "plain_calls_per_run": ca.plain_calls - plain}
    if job["iters"]:
        row.update(bench_predictor(pred, feeds, job["iters"]))
    out[job["tag"]] = row
    del pred
    torch.cuda.empty_cache()
print("PREDICTOR_CHILD " + json.dumps(out), flush=True)
"""


def _dist(a, ref) -> float:
    """max |a - ref| / std(ref), the model checks' measure. A numpy operand
    may be bfloat16 (``ml_dtypes``, as a bf16 Predictor hands it out)."""
    import numpy as np
    import torch
    a, ref = (x.float() if torch.is_tensor(x) else
              torch.from_numpy(np.asarray(x, np.float32)) for x in (a, ref))
    return max_abs_err(a, ref) / float(ref.std())


def _use_kernels(model, on: bool) -> None:
    """The flash kernels (on) or their plain versions in every attention of
    an encoder (``BertSelfAttention.use_kernels``)."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = on


def _predictor_child(jobs) -> dict:
    """Load and run the artifacts of ``jobs`` in a fresh process."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PREDICTOR_CHILD,
                           json.dumps(jobs)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"inference: the predictor process failed:\n{proc.stdout[-3000:]}"
            f"\n{proc.stderr[-6000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("PREDICTOR_CHILD "))
    return json.loads(line[len("PREDICTOR_CHILD "):])


def _serve_clients(srv, reqs, clients):
    """Submit ``reqs`` from ``clients`` threads (request i from client
    i % clients, each client in its own order, without waiting) and wait
    for every response. Returns the outputs in request order, the order in
    which the futures resolved and the wall seconds."""
    import itertools
    import threading
    done_order = {}
    tick = itertools.count()
    futs = [None] * len(reqs)
    errors = []

    def client(c):
        try:
            for i in range(c, len(reqs), clients):
                f = srv.submit([reqs[i]])
                f.add_done_callback(
                    lambda _, i=i: done_order.__setitem__(i, next(tick)))
                futs[i] = f
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(not errors, f"inference: a client failed: {errors[:1]}")
    outs = [f.result(timeout=300)[0] for f in futs]
    return outs, done_order, time.perf_counter() - t0


def _server_run(pred, reqs, name, layers) -> tuple:
    """InferenceServer over ``pred`` (max batch 16, buckets 128/256/512,
    pipeline depth 2): warmup, then ``reqs`` from SERVER_CLIENTS clients
    with the counts set to 0 just before and read just after; then a
    profiled window of PROFILE_REQUESTS more. Returns the outputs, the
    record and the server's policy."""
    import numpy as np
    import torch
    from paddle_tpu_torch import serving
    srv = serving.InferenceServer(
        pred, max_batch_size=SERVER_MAX_BATCH, seq_buckets=SERVER_BUCKETS,
        pipeline_depth=2, queue_capacity=len(reqs), name=name,
        ready_requires_warmup=True)
    require(not srv.ready, f"{name}: ready before warmup")
    t0 = time.perf_counter()
    fresh = srv.warmup()
    warm_s = time.perf_counter() - t0
    require(srv.ready and fresh == len(srv.bucket_specs()),
            f"{name}: warmup ran {fresh} of {len(srv.bucket_specs())} "
            f"signatures")
    _reset_counts()
    outs, done_order, wall = _serve_clients(srv, reqs, SERVER_CLIENTS)
    counts = _read_counts()
    snap = srv.metrics.snapshot()
    c = snap["counters"]
    require(c["completed"] == len(reqs) and c["failed"] == 0
            and c["timed_out"] == 0 and c["rejected"] == 0,
            f"{name}: counters {c}")
    require(0 < c["batches"] < len(reqs), f"{name}: {c['batches']} batches "
            f"for {len(reqs)} requests")
    _require_launches(name, counts, {"flash_fwd": layers}, c["batches"])
    # order: a client's requests of one bucket resolve in the order it
    # submitted them (the batcher is FIFO within a signature and the
    # completion stage FIFO over batches)
    for cl in range(SERVER_CLIENTS):
        for b in SERVER_BUCKETS:
            mine = [i for i in range(cl, len(reqs), SERVER_CLIENTS)
                    if srv.policy.bucket_seq(reqs[i].shape[1]) == b]
            ticks = [done_order[i] for i in mine]
            require(ticks == sorted(ticks), f"{name}: client {cl} bucket "
                    f"{b}: responses out of submission order")
    rng = np.random.RandomState(1)
    extra = [reqs[i] for i in rng.randint(0, len(reqs), PROFILE_REQUESTS)]
    prof = device_profile(lambda: _serve_clients(srv, extra, 1), 1)
    torch.cuda.synchronize()
    record = {"warmup_signatures": [[s.batch, s.seq]
                                    for s in srv.bucket_specs()],
              "warmup_s": warm_s, "requests": len(reqs),
              "clients": SERVER_CLIENTS, "wall_s": wall,
              "qps": len(reqs) / wall, "batches": c["batches"],
              "mean_rows_per_batch": len(reqs) / c["batches"],
              "batch_size_hist": snap["batch_size_hist"],
              "latency_ms": snap["latency_ms"],
              "stage_ms": snap["stage_ms"],
              "padding_waste_ratio": snap["padding"]["waste_ratio"],
              "launches": counts["launches"]["flash_fwd"],
              "plain_calls": counts["plain_calls"]["flash_fwd"],
              "profile": {k: prof[k] for k in (
                  "wall_ms_per_step", "device_busy_ms_per_step",
                  "device_busy_share", "device_ms_by_group",
                  "kernels_per_step", "top")}}
    srv.shutdown()
    return outs, record, srv.policy


def phase_inference(state):
    """Single-model inference as the reference's users run it: ERNIE-base
    saved with jit.save (float32, and bf16 after amp.decorate), loaded by
    inference.Predictor in a fresh process and served by InferenceServer;
    ResNet-50 through the Predictor."""
    import copy
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, inference, jit
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base)
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50
    seed = state["seed"]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_inference_"))
    try:
        cfg = ernie_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        layers = cfg.num_layers
        model = ErnieForSequenceClassification(cfg, num_classes=2,
                                               device="cuda",
                                               seed=seed).eval()
        rng = np.random.RandomState(seed)
        ids = rng.randint(1, cfg.vocab_size,
                          (INFER_BATCH, INFER_SEQ)).astype(np.int64)
        np.save(work / "ids.npy", ids)
        spec = [InputSpec([None, None], "int64", "input_ids")]
        x = torch.from_numpy(ids).cuda()
        with torch.no_grad():
            _use_kernels(model, False)
            ref32 = model(x).float().cpu()
            _use_kernels(model, True)
        t0 = time.perf_counter()
        jit.save(model, str(work / "ernie_f32"), input_spec=spec)
        save_s = time.perf_counter() - t0
        cpu_model = copy.deepcopy(model).cpu()
        jit.save(cpu_model, str(work / "ernie_cpu"), input_spec=spec)
        del cpu_model
        bf = amp.decorate(copy.deepcopy(model), dtype="bfloat16")
        with torch.no_grad():
            _use_kernels(bf, False)
            plain_bf16 = bf(x).float().cpu()
            _use_kernels(bf, True)
        jit.save(bf, str(work / "ernie_bf16"), input_spec=spec)
        rn = resnet50(device="cuda", seed=seed).eval()
        img = rng.randn(RESNET_BATCH, 3, RESNET_SIZE,
                        RESNET_SIZE).astype(np.float32)
        np.save(work / "img.npy", img)
        with torch.no_grad():
            ref_rn = rn(torch.from_numpy(img).cuda()).float().cpu()
        jit.save(rn, str(work / "resnet50"),
                 input_spec=[InputSpec([None, 3, RESNET_SIZE, RESNET_SIZE],
                                       "float32", "image")])
        del rn
        _release()

        jobs = [{"tag": tag, "prefix": str(work / tag),
                 "feed": str(work / feed), "out": str(work / f"{tag}.npy"),
                 "iters": iters}
                for tag, feed, iters in (
                    ("ernie_f32", "ids.npy", INFER_ITERS),
                    ("ernie_bf16", "ids.npy", INFER_ITERS),
                    ("ernie_cpu", "ids.npy", 0),
                    ("resnet50", "img.npy", INFER_ITERS))]
        t0 = time.perf_counter()
        child = _predictor_child(jobs)
        child_s = time.perf_counter() - t0
        got = {j["tag"]: np.load(j["out"]) for j in jobs}
        d32 = _dist(got["ernie_f32"], ref32)
        dcpu = _dist(got["ernie_cpu"], ref32)
        floor = _dist(plain_bf16, ref32)
        dbf = _dist(got["ernie_bf16"], ref32)
        drn = _dist(got["resnet50"], ref_rn)
        checks = {"f32_kernel_vs_plain": d32, "cpu_saved_vs_plain": dcpu,
                  "bf16_kernel_vs_f32_plain": dbf,
                  "bf16_plain_vs_f32_plain": floor,
                  "resnet50_vs_eager": drn}
        log("inference: predictor checks (max |a - b| / std) "
            + json.dumps(checks))
        for tag in ("ernie_f32", "ernie_bf16", "ernie_cpu"):
            row = child[tag]
            require(row["device"].startswith("cuda"),
                    f"inference: {tag} ran on {row['device']}")
            require(row["launches_per_run"] == layers
                    and row["plain_calls_per_run"] == 0,
                    f"inference: {tag}: {row['launches_per_run']} flash "
                    f"launches and {row['plain_calls_per_run']} plain calls "
                    f"a forward, not {layers} and 0")
        require(d32 <= F32_MODEL_LIMIT, f"inference: float32 predictor "
                f"{d32:.2e} from the plain path (limit {F32_MODEL_LIMIT})")
        require(dcpu <= F32_MODEL_LIMIT, f"inference: the CPU-saved artifact "
                f"on the card {dcpu:.2e} from the plain path")
        require(0 < floor and dbf <= BF16_FLOOR_FACTOR * floor,
                f"inference: bf16 predictor {dbf:.2e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the bf16 plain path's {floor:.2e}")
        require(drn <= F32_MODEL_LIMIT, f"inference: ResNet-50 predictor "
                f"{drn:.2e} from the eager model")

        # the server: 512 single-row requests of 16-512 tokens
        lens = rng.randint(SERVER_MIN_LEN, SERVER_BUCKETS[-1] + 1,
                           SERVER_REQUESTS)
        reqs = [rng.randint(1, cfg.vocab_size, (1, n)).astype(np.int64)
                for n in lens]
        server, alone32 = {}, None
        for prec in ("float32", "bfloat16"):
            tag = "ernie_f32" if prec == "float32" else "ernie_bf16"
            pred = inference.create_predictor(
                inference.Config(str(work / tag)))
            # host time a forward at b=8 s=128 (the enqueue rate of 50
            # back-to-back calls: the host's when it is slower than the
            # card, the card's otherwise): the exported program against
            # the eager model it came from
            eager = model if prec == "float32" else bf
            with torch.no_grad():
                dispatch = {"exported": host_us(lambda: pred._artifact(x)),
                            "eager": host_us(lambda: eager(x))}
            outs, record, policy = _server_run(pred, reqs,
                                               f"smoke_{prec}", layers)
            record["host_us_per_forward_b8_s128"] = dispatch
            padded = [policy.pad_request_seq([r])[0] for r in reqs]
            alone = np.concatenate([pred.run([p])[0] for p in padded])
            outs = np.concatenate(outs)
            # each request alone, padded to its bucket, on the eager
            # model's plain path (no kernel)
            with torch.no_grad():
                _use_kernels(eager, False)
                plain = np.concatenate([
                    eager(torch.from_numpy(p).cuda()).float().cpu().numpy()
                    for p in padded])
                _use_kernels(eager, True)
            if prec == "float32":
                alone32 = alone
                record["vs_predictor_alone"] = _dist(outs, alone)
                record["vs_plain_alone"] = _dist(outs, plain)
                for key in ("vs_predictor_alone", "vs_plain_alone"):
                    require(record[key] <= F32_MODEL_LIMIT,
                            f"inference: float32 server {key} "
                            f"{record[key]:.2e}, beyond {F32_MODEL_LIMIT}")
            else:
                record["vs_f32_alone"] = _dist(outs, alone32)
                record["floor_plain_vs_f32_alone"] = _dist(plain, alone32)
                require(record["vs_f32_alone"] <= BF16_FLOOR_FACTOR
                        * record["floor_plain_vs_f32_alone"],
                        f"inference: bf16 server {record['vs_f32_alone']:.2e}"
                        f" from float32, beyond {BF16_FLOOR_FACTOR} x the "
                        f"plain path's "
                        f"{record['floor_plain_vs_f32_alone']:.2e}")
            log(f"inference: server {prec} " + json.dumps(record))
            server[prec] = record
            del pred
            _release()
        del model, bf
        _release()
        out = {"ernie_base": {"batch": INFER_BATCH, "seq": INFER_SEQ,
                              "jit_save_s": save_s, "child_s": child_s,
                              "checks": checks,
                              "predictor": {k: child[k] for k in
                                            ("ernie_f32", "ernie_bf16",
                                             "ernie_cpu")}},
               "resnet50": {"batch": RESNET_BATCH, "size": RESNET_SIZE,
                            "predictor": child["resnet50"]},
               "server": server}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    state["inference"] = out
    log("inference: " + json.dumps(out))


# ------------------------------------------- the Paddle-shaped API
# GPT-2 small at full width and depth (paddle_tpu/models/gpt.py's gpt2_small,
# bench.py's): hidden 768, 12 heads of 64, vocab 50304, 12 layers
API_CFG = {"vocab": 50304, "hidden": 768, "heads": 12, "layers": 12,
           "max_pos": 1024, "seq": 1024, "batch": 8, "lr": TRAIN_LR}
API_STEPS = 3
API_HOST_CALLS = 10_000
SCRIPT = REPO / "tests" / "test_torch_paddle_script.py"


def _load_script(path, name):
    """A Paddle-style script, loaded by path (it imports neither JAX nor
    the JAX package at module level)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_module():
    """The Paddle-style GPT training script."""
    return _load_script(SCRIPT, "paddle_script")


@contextlib.contextmanager
def _plain_attention():
    """Route the Paddle API's attention to the flash kernels' plain
    versions, as the tiny phase routes a model with use_kernels=False: the
    scaled_dot_product_attention functional calls attention_bshd with
    use_kernels=False while the block runs."""
    from paddle_tpu_torch.nn.functional import attention as attn
    orig = attn.attention_bshd
    attn.attention_bshd = lambda *a, **kw: orig(*a, **{**kw,
                                                       "use_kernels": False})
    try:
        yield
    finally:
        attn.attention_bshd = orig


def _api_run(script, paddle, init, batches, amp, plain, save_dir=None):
    """The script's steps from ``init`` through the kernels (or their plain
    versions): losses, each step's gradients and the parameters after, by
    structured name, on the card; the launches by kernel (counts set to 0
    just before); and the model and optimizer."""
    import torch
    grads = []

    def on_grads(model):
        grads.append({n: p.grad._data.detach().float().clone()
                      for n, p in model.named_parameters()})
    _reset_counts()
    with _plain_attention() if plain else contextlib.nullcontext():
        losses, model, opt = script.train_script(
            paddle, API_CFG, API_STEPS, 0, batches, amp=amp, init=init,
            on_grads=on_grads, save_dir=save_dir)
    torch.cuda.synchronize()
    counts = _read_counts()
    params = {n: p._data.detach().float().clone()
              for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params,
            "counts": counts, "model": model, "opt": opt}


def _api_host_us(paddle) -> dict:
    """Host µs a call, over API_HOST_CALLS back-to-back calls: paddle.add
    against torch.add on a [1024] float32 tensor on the card, paddle.matmul
    against torch.matmul on [64, 64], and a Linear(1024, 1024) forward on
    [8, 1024] against torch's F.linear on the same weights; then the three
    pairs again on CPU tensors (``cpu_*``; matmul [16, 16], Linear(64, 64)
    on [8, 64], so that the CPU's arithmetic stays small), where no device
    queue can hide what the wrapper costs the host."""
    out = _api_host_pairs(paddle, "gpu", "", 64, 1024)
    out.update(_api_host_pairs(paddle, "cpu", "cpu_", 16, 64))
    paddle.set_device("gpu")
    out["calls"] = API_HOST_CALLS
    return out


def _api_host_pairs(paddle, device, prefix, mm, width) -> dict:
    import torch
    import torch.nn.functional as F
    paddle.set_device(device)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(API_HOST_CALLS):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / API_HOST_CALLS * 1e6
    x = paddle.randn([1024])
    xt = x._data
    a = paddle.randn([mm, mm])
    at = a._data
    lin = paddle.nn.Linear(width, width)
    h = paddle.randn([8, width])
    w, b = lin.weight._data.t(), lin.bias._data
    with torch.no_grad():
        pairs = {"add_us": per_call(lambda: paddle.add(x, x)),
                 "torch_add_us": per_call(lambda: torch.add(xt, xt)),
                 "matmul_us": per_call(lambda: paddle.matmul(a, a)),
                 "torch_matmul_us": per_call(lambda: torch.matmul(at, at)),
                 "linear_us": per_call(lambda: lin(h)),
                 "torch_linear_us": per_call(lambda: F.linear(h._data, w,
                                                             b))}
    return {prefix + k: v for k, v in pairs.items()}


def phase_api(state):
    """The Paddle-shaped API on the card: the Paddle-style GPT script
    (tests/test_torch_paddle_script.py) at GPT-2 small's full width and
    depth, B=8, S=1024, three AdamW steps from one set of weights made from
    the seed: float32 through the kernels against the plain versions
    (losses, every step's gradients, parameters), bf16 O2 against the plain
    O2 path's rounding floor, 12 launches a step of each flash kernel and
    no plain call, a resume from paddle.save files bit for bit, ms a step,
    the card's busy share over one step, the host µs an op, and the flash
    kernels at this shape beside SDPA."""
    import tempfile

    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    script = _script_module()
    paddle.set_device("gpu")
    rng = np.random.RandomState(state["seed"])
    batches = [rng.randint(0, API_CFG["vocab"],
                           (API_CFG["batch"], API_CFG["seq"] + 1))
               for _ in range(API_STEPS + 1)]
    paddle.seed(state["seed"])
    base = script.build_model(paddle, API_CFG)
    init = {n: t._data.detach().clone() for n, t in base.state_dict().items()}
    n_params = sum(p.size for p in base.parameters())
    del base
    per_step = {"flash_fwd": API_CFG["layers"],
                "flash_bwd_dq": API_CFG["layers"],
                "flash_bwd_dkv": API_CFG["layers"]}
    out = {"config": "gpt2_small (Paddle-style script)", "params": n_params,
           "batch": API_CFG["batch"], "seq": API_CFG["seq"],
           "steps": API_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        k32 = _api_run(script, paddle, init, batches, None, False, tmp)
        _require_launches("api float32", k32["counts"], per_step, API_STEPS)
        require(k32["counts"]["dense_calls"] == 0,
                "api: the dense attention ran on the main path")
        p32 = _api_run(script, paddle, init, batches, None, True)
        require(sum(p32["counts"]["launches"].values()) == 0,
                f"api: the plain path launched a kernel: {p32['counts']}")
        # float32: kernels against plain versions (the train phase's limits)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(k32["losses"], p32["losses"]))
        grad_rel, noise = 0.0, {}
        for i, (gk, gp) in enumerate(zip(k32["grads"], p32["grads"])):
            for n, g in gp.items():
                big = float(g.abs().max())
                grad_rel = max(grad_rel, max_abs_err(gk[n], g) / max(
                    big, 1e-30))
                small = g.abs() <= TRAIN_F32_GRAD_RTOL * big
                noise[n] = small if i == 0 else noise[n] | small
        param_err = noise_err = 0.0
        for n, p in p32["params"].items():
            d = (k32["params"][n] - p).abs()
            if bool((~noise[n]).any()):
                param_err = max(param_err, float(d[~noise[n]].max()))
            if bool(noise[n].any()):
                noise_err = max(noise_err, float(d[noise[n]].max()))
        out.update({"f32_losses": {"kernels": k32["losses"],
                                   "plain": p32["losses"]},
                    "f32_loss_rel": loss_rel, "f32_grad_rel_max": grad_rel,
                    "f32_param_max_abs_err": param_err,
                    "f32_noise_max_abs_err": noise_err,
                    "f32_launches": k32["counts"]["launches"],
                    "f32_plain_calls": k32["counts"]["plain_calls"]})
        require(all(math.isfinite(x) for x in k32["losses"]),
                f"api: non-finite float32 loss {k32['losses']}")
        require(loss_rel <= TRAIN_F32_LOSS_RTOL,
                f"api: float32 losses differ by {loss_rel:.2e}")
        require(grad_rel <= TRAIN_F32_GRAD_RTOL,
                f"api: float32 gradients differ by {grad_rel:.2e} of their "
                f"largest")
        require(param_err <= TRAIN_F32_PARAM_ATOL,
                f"api: float32 parameters differ by {param_err:.2e}")
        require(noise_err <= 2 * API_STEPS * TRAIN_LR * (1 + 1e-3),
                f"api: noise-level elements differ by {noise_err:.2e}")
        # resume: the saved state into a fresh model and optimizer, step 4
        fresh = script.build_model(paddle, API_CFG)
        fresh.set_state_dict(paddle.load(f"{tmp}/model.pdparams"))
        fopt = script.make_optimizer(paddle, API_CFG, fresh)
        fopt.set_state_dict(script.rename_optimizer_state(
            paddle.load(f"{tmp}/opt.pdopt"), k32["model"], fresh))
    loss_a = script.take_step(paddle, k32["model"], k32["opt"], batches[-1])
    loss_b = script.take_step(paddle, fresh, fopt, batches[-1])
    same = loss_a == loss_b and all(
        torch.equal(p._data, q._data) for p, q in zip(
            k32["model"].parameters(), fresh.parameters()))
    out["resume"] = {"step4_loss": loss_a, "step4_loss_resumed": loss_b,
                     "bit_for_bit": same}
    require(same, f"api: step 4 after the resume differs ({loss_a} vs "
                  f"{loss_b})")
    del fresh, fopt, p32

    def timed_steps(run, amp):
        def window():
            for b in batches[:API_STEPS]:
                script.take_step(paddle, run["model"], run["opt"], b, amp)
        wall, _ = _timed_window(window, API_STEPS)
        return wall / API_STEPS * 1e3
    out["f32_step_ms"] = timed_steps(k32, None)
    out["f32_step_profile"] = device_profile(
        lambda: (script.take_step(paddle, k32["model"], k32["opt"],
                                   batches[0]), torch.cuda.synchronize()), 1)
    out["f32_device_busy_share_of_step"] = \
        out["f32_step_profile"]["device_busy_ms_per_step"] / \
        out["f32_step_ms"]
    del k32
    torch.cuda.empty_cache()
    # bf16 O2: the kernel path's distance from the float32 plain run against
    # the plain O2 path's own
    kb = _api_run(script, paddle, init, batches, "bfloat16", False)
    _require_launches("api bf16 O2", kb["counts"], per_step, API_STEPS)
    pb = _api_run(script, paddle, init, batches, "bfloat16", True)
    ref32 = _api_run(script, paddle, init, batches, None, True)

    def l2(a):
        return float(torch.sqrt(sum(((a[n] - p).double() ** 2).sum()
                                    for n, p in ref32["params"].items())))
    o2 = {"losses_kernel": kb["losses"], "losses_plain": pb["losses"],
          "loss_kernel": max(abs(a - b) for a, b in zip(kb["losses"],
                                                        ref32["losses"])),
          "loss_plain": max(abs(a - b) for a, b in zip(pb["losses"],
                                                       ref32["losses"])),
          "params_l2_kernel": l2(kb["params"]),
          "params_l2_plain": l2(pb["params"]),
          "launches": kb["counts"]["launches"],
          "plain_calls": kb["counts"]["plain_calls"]}
    out["o2"] = o2
    for what in ("loss", "params_l2"):
        k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
        require(k <= BF16_FLOOR_FACTOR * p,
                f"api: O2 {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    del pb, ref32
    torch.cuda.empty_cache()
    out["bf16_step_ms"] = timed_steps(kb, "bfloat16")
    out["bf16_step_profile"] = device_profile(
        lambda: (script.take_step(paddle, kb["model"], kb["opt"],
                                   batches[0], "bfloat16"),
                 torch.cuda.synchronize()), 1)
    out["bf16_device_busy_share_of_step"] = \
        out["bf16_step_profile"]["device_busy_ms_per_step"] / \
        out["bf16_step_ms"]
    del kb
    torch.cuda.empty_cache()
    out["host"] = _api_host_us(paddle)
    log("api: " + json.dumps({k: v for k, v in out.items()
                              if not k.endswith("_step_profile")}))
    for prec in ("f32", "bf16"):
        log(f"api: {prec} step profile "
            + json.dumps(out[f"{prec}_step_profile"]))
    # the flash kernels at the script's shape, beside SDPA and the bound
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        fwd = _flash_case(API_CFG["batch"], API_CFG["seq"], API_CFG["heads"],
                          API_CFG["hidden"] // API_CFG["heads"], dtype, True,
                          state["seed"] + 90, report=True)
        bwd = _bwd_case(API_CFG["batch"], API_CFG["seq"], API_CFG["heads"],
                        API_CFG["hidden"] // API_CFG["heads"], dtype, True,
                        state["seed"] + 91)
        check_bwd(bwd)
        rows[str(dtype)[6:]] = {"fwd": fwd, "bwd": bwd}
    out["kernel_rows"] = rows
    state["api"] = out


# ------------------------------------------------- the rest of paddle.nn
# BERT-base's widths (paddle_tpu/models/bert.py:42-52): hidden 768, 12
# heads of 64, FFN 3072, vocab 30528, 512 positions, 12 layers; the
# families phase's batch and length
NN_CFG = {"vocab": 30528, "hidden": 768, "heads": 12, "layers": 12,
          "max_pos": 512, "seq": 512, "batch": 32, "classes": 2,
          "dropout": 0.1, "lr": TRAIN_LR}
NN_STEPS = 3
ENCODER_SCRIPT = REPO / "tests" / "test_torch_paddle_encoder_script.py"
# the key projections' biases have an exact gradient of zero (softmax
# ignores a shift of a row's scores): both routes hand Adam rounding noise
# there, so they are held to Adam's bound (lr a step), as in the CPU test
K_BIAS = ".self_attn.k_proj.bias"
# The query projections' gradients are differences of large sums: with
# near-uniform attention over 512 keys, dq = Σ p (dp - δ) k cancels to a
# small residue of the keys' shared part. Before the float32 backward took
# K and V less their means (cuda_attention_bwd._centered) the 3xTF32
# kernels left them 5.0e-5 of their largest from float64 at step 1 (the
# plain route 1.26e-5) and the routes read 1.02e-4 apart (NVIDIA H100 80GB
# HBM3, 700 W, seed 0). They are held to the train phase's limit like
# every other gradient, and the kernels' step-1 distance from a float64
# run (``ref64``) to at most Q_PROJ_REF64_FACTOR x the plain route's.
Q_PROJ = ".self_attn.q_proj."
Q_PROJ_REF64_FACTOR = 1.5
# Adam divides each element's update by its gradient's size, so an element
# whose gradient is small against its tensor's largest turns a small
# disagreement into a large relative one: the two routes' parameters read
# 1.96e-6 apart at an element 2.2e-4 of its tensor's largest (a key
# projection), 7.4e-7 at most outside 1e-3 of it, 2.9e-7 outside 3e-3
# (the same run). The parameters are held to the train phase's 1e-6
# outside that band of 1e-3, and to Adam's bound (2 lr a step) inside it.
NN_NOISE_BAND = 1e-3
# the sweep, card against CPU in float32 with TF32 off: max |card - cpu|
# over a tensor / max |cpu|, for every output, input gradient and parameter
# gradient. 1e-5 where the op sums as the CPU does; 1e-4 where it sums in
# another order over longer chains: cuDNN's convolutions (their algorithm
# is cuDNN's choice), the recurrent loops (a step's matmul feeds the
# next), the transformer layers (3xTF32 flash kernels and chains of
# matmuls) and the reductions of CTC and RNN-T
SWEEP_LIMIT = 1e-5
SWEEP_LOOSE = 1e-4


def _nn_run(script, paddle, init, batches, amp, plain):
    """The encoder script's steps from ``init`` through the kernels (or
    their plain versions): losses, each step's gradients and the parameters
    after, by structured name, on the card; the launches by kernel (counts
    set to 0 just before); the model and optimizer."""
    import torch
    grads = []

    def on_grads(model):
        grads.append({n: p.grad._data.detach().float().clone()
                      for n, p in model.named_parameters()})
    _reset_counts()
    with _plain_attention() if plain else contextlib.nullcontext():
        losses, model, opt = script.train_script(
            paddle, NN_CFG, NN_STEPS, 0, batches, amp=amp, init=init,
            on_grads=on_grads)
    torch.cuda.synchronize()
    counts = _read_counts()
    params = {n: p._data.detach().float().clone()
              for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params,
            "counts": counts, "model": model, "opt": opt}


def _nn_f32_check(k32, p32, init) -> dict:
    """float32 kernels against plain versions: the train phase's limits on
    the losses, every step's gradients (of each parameter's largest) and
    the parameters; elements whose gradient is rounding noise (and the key
    projections' biases) by Adam's bound."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(k32["losses"], p32["losses"]))
    grad_rel, noise, by_param = 0.0, {}, {}
    for i, (gk, gp) in enumerate(zip(k32["grads"], p32["grads"])):
        for n, g in gp.items():
            if n.endswith(K_BIAS):
                continue
            big = float(g.abs().max())
            rel = max_abs_err(gk[n], g) / max(big, 1e-30)
            by_param[n] = max(by_param.get(n, 0.0), rel)
            grad_rel = max(grad_rel, rel)
            small = g.abs() <= NN_NOISE_BAND * big
            noise[n] = small if i == 0 else noise[n] | small
    worst = sorted(by_param.items(), key=lambda kv: -kv[1])[:6]
    log("nn: float32 gradients, worst parameters: " + json.dumps(worst))
    q_rel = max(v for n, v in by_param.items() if Q_PROJ in n)
    param_err = noise_err = kbias_moved = 0.0
    p_by = {}
    for n, p in p32["params"].items():
        if n.endswith(K_BIAS):
            for run in (k32, p32):
                kbias_moved = max(kbias_moved, float(
                    (run["params"][n] - init[n].float()).abs().max()))
            continue
        d = (k32["params"][n] - p).abs()
        if bool((~noise[n]).any()):
            dn = d.masked_fill(noise[n], 0)
            i = int(dn.argmax())
            g0 = p32["grads"][0][n].reshape(-1).abs()
            p_by[n] = (float(dn.reshape(-1)[i]),
                       float(g0[i] / g0.max()))
            param_err = max(param_err, p_by[n][0])
        if bool(noise[n].any()):
            noise_err = max(noise_err, float(d[noise[n]].max()))
    bands = {}
    for band in (1e-4, 3e-4, 1e-3, 3e-3, 1e-2):
        worst_band = 0.0
        for n, p in p32["params"].items():
            if n.endswith(K_BIAS):
                continue
            small = None
            for gp in p32["grads"]:
                g = gp[n].abs()
                s = g <= band * float(g.max())
                small = s if small is None else small | s
            d = (k32["params"][n] - p).abs()
            if bool((~small).any()):
                worst_band = max(worst_band, float(d[~small].max()))
        bands[str(band)] = worst_band
    log("nn: float32 parameters' largest difference outside each band of "
        "small gradients: " + json.dumps(bands))
    p_worst = sorted(p_by.items(), key=lambda kv: -kv[1][0])[:6]
    out = {"f32_losses": {"kernels": k32["losses"], "plain": p32["losses"]},
           "f32_loss_rel": loss_rel, "f32_grad_rel_max": grad_rel,
           "f32_q_proj_grad_rel_max": q_rel,
           "f32_param_max_abs_err": param_err,
           "f32_noise_max_abs_err": noise_err,
           "f32_k_bias_moved": kbias_moved,
           "f32_grad_rel_worst": worst,
           "f32_param_worst_outside_band": p_worst,
           "f32_param_max_outside_band": bands}
    require(all(math.isfinite(x) for x in k32["losses"]),
            f"nn: non-finite float32 loss {k32['losses']}")
    require(loss_rel <= TRAIN_F32_LOSS_RTOL,
            f"nn: float32 losses differ by {loss_rel:.2e}")
    require(grad_rel <= TRAIN_F32_GRAD_RTOL,
            f"nn: float32 gradients differ by {grad_rel:.2e} of their "
            f"largest")
    require(param_err <= TRAIN_F32_PARAM_ATOL,
            f"nn: float32 parameters differ by {param_err:.2e}")
    bound = NN_STEPS * TRAIN_LR * (1 + 1e-3)
    require(noise_err <= 2 * bound,
            f"nn: noise-level elements differ by {noise_err:.2e}")
    require(kbias_moved <= bound,
            f"nn: a key bias moved {kbias_moved:.2e}, beyond Adam's bound")
    return out


def _nn_ref64(script, paddle, init, batch, runs) -> dict:
    """Step 1's gradients on the plain route in float64 (the same dropout
    masks), and each float32 route's distance from them: max |g - g64| /
    max |g64| per parameter, the worst and the median (no limit reads
    them)."""
    import torch
    paddle.seed(0)
    model = script.build_model(paddle, NN_CFG)
    model.set_state_dict(init)
    model.to(dtype=torch.float64)
    paddle.seed(0)
    with _plain_attention():
        script.loss_of(paddle, model, batch).backward()
    g64 = {n: p.grad._data for n, p in model.named_parameters()}
    out = {}
    for tag, run in runs.items():
        rel = {n: float((run["grads"][0][n].double() - g).abs().max()
                        / g.abs().max()) for n, g in g64.items()
               if not n.endswith(K_BIAS)}
        vals = sorted(rel.values())
        worst = max(rel, key=rel.get)
        out[tag] = {"median": vals[len(vals) // 2], "worst": [worst,
                                                             rel[worst]],
                    "q_proj_max": max(v for n, v in rel.items()
                                      if Q_PROJ in n)}
    del model, g64
    torch.cuda.empty_cache()
    return out


def _nn_masked_eval(script, paddle, model, batch, seed) -> dict:
    """One evaluation forward under a bool padding mask [B, 1, 1, S]: the
    dense route in every layer (12 calls, no flash launch), the same logits
    as the plain route, the rows without padding as the unmasked forward
    through the flash kernel, and padded ids that change nothing."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    seq, b = NN_CFG["seq"], NN_CFG["batch"]
    lengths = rng.randint(seq // 8, seq, b)
    lengths[:4] = seq
    _reset_counts()
    masked = script.eval_logits(paddle, model, batch, lengths)._data.clone()
    torch.cuda.synchronize()
    counts = _read_counts()
    require(counts["dense_calls"] == NN_CFG["layers"],
            f"nn: the masked forward made {counts['dense_calls']} dense "
            f"calls, not {NN_CFG['layers']}")
    require(sum(counts["launches"].values()) == 0,
            f"nn: the masked forward launched {counts['launches']}")
    with _plain_attention():
        plain = script.eval_logits(paddle, model, batch, lengths)._data
    same_plain = max_abs_err(masked, plain)
    require(same_plain == 0.0, f"nn: masked forward differs from the plain "
                               f"route by {same_plain:.2e}")
    model.eval()
    with paddle.no_grad():
        unmasked = model(paddle.to_tensor(batch[0]))._data
    model.train()
    full_err = max_abs_err(masked[:4], unmasked[:4]) / float(
        unmasked.float().std())
    require(full_err <= F32_MODEL_LIMIT,
            f"nn: unpadded rows differ from the flash forward by "
            f"{full_err:.2e} x std")
    noisy = batch[0].copy()
    for i, n in enumerate(lengths):
        noisy[i, n:] = (noisy[i, n:] + 11) % NN_CFG["vocab"]
    moved = max_abs_err(script.eval_logits(paddle, model, (noisy, batch[1]),
                                           lengths)._data, masked)
    require(moved <= 1e-6, f"nn: padded ids moved the logits by {moved:.2e}")
    return {"dense_calls": counts["dense_calls"],
            "launches": counts["launches"], "vs_plain_route": same_plain,
            "unpadded_rows_vs_flash_rel_std": full_err,
            "padded_ids_moved": moved, "lengths_min": int(lengths.min())}


def phase_nn(state):
    """The rest of paddle.nn on the card: the Paddle-style encoder
    classifier (tests/test_torch_paddle_encoder_script.py) at BERT-base's
    widths, B=32, S=512, three AdamW steps from one set of weights made
    from the seed: float32 through the kernels against the plain route
    (dropout 0.1, the same masks from the same seed; the train phase's
    limits), bf16 O2 against the plain O2 path's rounding floor, 12
    launches a step of each flash kernel with no plain and no dense call;
    a masked evaluation forward on the dense route; ms a step and a
    profiled step of each precision; the flash kernels at this shape beside
    SDPA and their bound; then the sweep of every layer class the slice
    ported, card against CPU."""
    import torch
    import paddle_tpu_torch as paddle
    script = _load_script(ENCODER_SCRIPT, "encoder_script")
    paddle.set_device("gpu")
    batches = script.batches_for(NN_CFG, state["seed"], NN_STEPS + 1)
    paddle.seed(state["seed"])
    base = script.build_model(paddle, NN_CFG)
    init = {n: t._data.detach().clone() for n, t in base.state_dict().items()}
    n_params = sum(p.size for p in base.parameters())
    del base
    per_step = {k: NN_CFG["layers"] for k in ("flash_fwd", "flash_bwd_dq",
                                              "flash_bwd_dkv")}
    out = {"config": "bert_base encoder classifier (Paddle-style script)",
           "params": n_params, "batch": NN_CFG["batch"],
           "seq": NN_CFG["seq"], "steps": NN_STEPS,
           "dropout": NN_CFG["dropout"]}
    k32 = _nn_run(script, paddle, init, batches, None, False)
    _require_launches("nn float32", k32["counts"], per_step, NN_STEPS)
    require(k32["counts"]["dense_calls"] == 0,
            "nn: the dense attention ran on the main path")
    p32 = _nn_run(script, paddle, init, batches, None, True)
    require(sum(p32["counts"]["launches"].values()) == 0,
            f"nn: the plain path launched a kernel: {p32['counts']}")
    out.update(_nn_f32_check(k32, p32, init))
    out["ref64"] = _nn_ref64(script, paddle, init, batches[0],
                             {"kernels": k32, "plain": p32})
    qk, qp = (out["ref64"][r]["q_proj_max"] for r in ("kernels", "plain"))
    require(qk <= Q_PROJ_REF64_FACTOR * qp,
            f"nn: the kernels' query-projection gradients read {qk:.2e} of "
            f"their largest from float64, beyond {Q_PROJ_REF64_FACTOR} x the "
            f"plain route's {qp:.2e}")
    out["f32_launches"] = k32["counts"]["launches"]
    out["f32_plain_calls"] = k32["counts"]["plain_calls"]
    out["masked_eval"] = _nn_masked_eval(script, paddle, k32["model"],
                                         batches[-1], state["seed"] + 1)
    ref32 = {"losses": p32["losses"], "params": p32["params"]}
    del p32

    def timed_steps(run, amp):
        # one step first: the float64 reference and the evaluation
        # forwards left the allocator's cache in another shape
        script.take_step(paddle, run["model"], run["opt"], batches[-1], amp)

        def window():
            for b in batches[:NN_STEPS]:
                script.take_step(paddle, run["model"], run["opt"], b, amp)
        wall, _ = _timed_window(window, NN_STEPS)
        return wall / NN_STEPS * 1e3
    out["f32_step_ms"] = timed_steps(k32, None)
    out["f32_step_profile"] = device_profile(
        lambda: (script.take_step(paddle, k32["model"], k32["opt"],
                                  batches[0]), torch.cuda.synchronize()), 1)
    del k32
    torch.cuda.empty_cache()
    kb = _nn_run(script, paddle, init, batches, "bfloat16", False)
    _require_launches("nn bf16 O2", kb["counts"], per_step, NN_STEPS)
    require(kb["counts"]["dense_calls"] == 0,
            "nn: the dense attention ran on the O2 path")
    pb = _nn_run(script, paddle, init, batches, "bfloat16", True)

    def l2(a):
        return float(torch.sqrt(sum(((a[n] - p).double() ** 2).sum()
                                    for n, p in ref32["params"].items())))
    o2 = {"losses_kernel": kb["losses"], "losses_plain": pb["losses"],
          "loss_kernel": max(abs(a - b) for a, b in zip(kb["losses"],
                                                        ref32["losses"])),
          "loss_plain": max(abs(a - b) for a, b in zip(pb["losses"],
                                                       ref32["losses"])),
          "params_l2_kernel": l2(kb["params"]),
          "params_l2_plain": l2(pb["params"]),
          "launches": kb["counts"]["launches"],
          "plain_calls": kb["counts"]["plain_calls"]}
    out["o2"] = o2
    for what in ("loss", "params_l2"):
        k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
        require(k <= BF16_FLOOR_FACTOR * p,
                f"nn: O2 {what} {k:.3e} from float32, beyond "
                f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
    del pb, ref32
    torch.cuda.empty_cache()
    out["bf16_step_ms"] = timed_steps(kb, "bfloat16")
    out["bf16_step_profile"] = device_profile(
        lambda: (script.take_step(paddle, kb["model"], kb["opt"], batches[0],
                                  "bfloat16"), torch.cuda.synchronize()), 1)
    del kb
    torch.cuda.empty_cache()
    for prec in ("f32", "bf16"):
        out[f"{prec}_device_busy_share_of_step"] = \
            out[f"{prec}_step_profile"]["device_busy_ms_per_step"] / \
            out[f"{prec}_step_ms"]
    log("nn: " + json.dumps({k: v for k, v in out.items()
                             if not k.endswith("_step_profile")}))
    for prec in ("f32", "bf16"):
        log(f"nn: {prec} step profile "
            + json.dumps(out[f"{prec}_step_profile"]))
    # the flash kernels at the script's shape (bidirectional, D=64)
    rows = {}
    d = NN_CFG["hidden"] // NN_CFG["heads"]
    for dtype in (torch.float32, torch.bfloat16):
        fwd = _flash_case(NN_CFG["batch"], NN_CFG["seq"], NN_CFG["heads"], d,
                          dtype, False, state["seed"] + 92, report=True)
        bwd = _bwd_case(NN_CFG["batch"], NN_CFG["seq"], NN_CFG["heads"], d,
                        dtype, False, state["seed"] + 93)
        check_bwd(bwd)
        rows[str(dtype)[6:]] = {"fwd": fwd, "bwd": bwd}
    out["kernel_rows"] = rows
    out["sweep"] = _nn_sweep(paddle, state["seed"])
    paddle.set_device("gpu")
    state["nn"] = out


# ---------------------------------------------------- the card/CPU sweep
def _sweep_rand(*shape, seed=0, lo=-1.0, hi=1.0):
    import numpy as np
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _sweep_flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _sweep_flat(o)]
    return [] if out is None else [out]


def _sweep_side(paddle, device, make, arrays, call, state, train):
    """One side of a sweep case on ``device``: outputs, input gradients and
    parameter gradients as float64 numpy arrays, and the layer's state."""
    import numpy as np
    paddle.set_device(device)
    paddle.seed(0)
    layer = make(paddle) if make is not None else None
    if layer is not None:
        if state is not None:
            layer.set_state_dict(state)
        layer.train() if train else layer.eval()
    xs = [paddle.to_tensor(a, stop_gradient=not np.issubdtype(
        a.dtype, np.floating)) for a in arrays]
    outs = _sweep_flat(call(paddle, layer, *xs))
    loss = None
    for i, o in enumerate(outs):
        if o.stop_gradient or not str(o.dtype).startswith("float"):
            continue
        w = paddle.to_tensor(_sweep_rand(*o.shape, seed=50 + i))
        loss = (o * w).sum() if loss is None else loss + (o * w).sum()
    if loss is not None:
        loss.backward()
    got = [(f"output {i}", o.numpy()) for i, o in enumerate(outs)]
    got += [(f"grad of input {i}", x.grad.numpy())
            for i, x in enumerate(xs) if x.grad is not None]
    if layer is not None:
        got += [(f"grad of {n}", p.grad.numpy())
                for n, p in layer.named_parameters() if p.grad is not None]
        state = {k: v.numpy() for k, v in layer.state_dict().items()}
    return [(n, a.astype(np.float64) if np.issubdtype(a.dtype, np.floating)
             else a) for n, a in got], state


def _sweep_case(paddle, make, arrays, call, train=True):
    """The case on the CPU (weights from the seed), then on the card from
    the same weights: the worst of max |card - cpu| / max |cpu| over every
    output and gradient."""
    import numpy as np
    want, state = _sweep_side(paddle, "cpu", make, arrays, call, None, train)
    got, _ = _sweep_side(paddle, "gpu", make, arrays, call, state, train)
    require([n for n, _ in got] == [n for n, _ in want],
            "sweep: the card and the CPU gave different tensors")
    worst = 0.0
    for (name, a), (_, b) in zip(got, want):
        require(a.shape == b.shape, f"sweep: {name}: shapes {a.shape} != "
                                    f"{b.shape}")
        if not np.issubdtype(b.dtype, np.floating):
            require(bool((a == b).all()), "sweep: integer outputs differ")
            continue
        if b.size == 0:
            continue
        require(bool(np.isfinite(a).all() == np.isfinite(b).all()),
                f"sweep: {name}: non-finite values on one side only")
        if name.endswith("k_proj.bias"):
            # its exact gradient is zero: both sides hold rounding noise
            require(float(np.abs(a).max()) <= 1e-5 * max(
                1.0, float(np.abs(b).max())), f"sweep: {name} is not noise")
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    return worst


def _sweep_cases():
    """``(name, make(P) -> layer or None, arrays, call(P, layer, *xs),
    limit, train)``: every layer class the slice ported (and the
    functionals without one), at small sizes."""
    import numpy as np
    r = _sweep_rand
    x1, x2, x3 = r(2, 4, 9, seed=1), r(2, 4, 7, 8, seed=2), \
        r(1, 2, 5, 6, 4, seed=3)
    lab = np.array([0, 4, 1, 2, 3, 1], np.int64)
    logits, a, b_, d = r(6, 5, seed=4, lo=-3, hi=3), r(6, 8, seed=5), \
        r(6, 8, seed=6), r(6, 8, seed=7)
    pm1 = np.where(r(6, seed=8) > 0, 1.0, -1.0).astype(np.float32)
    probs = r(6, 5, seed=9, lo=0.05, hi=0.95)
    binary = (r(6, 5, seed=10) > 0).astype(np.float32)

    def fwd(P, layer, *xs):
        return layer(*xs)

    def fn(f):
        return lambda P, layer, *xs: f(P.nn.functional, *xs)
    L, S = SWEEP_LOOSE, SWEEP_LIMIT
    cases = [
        # convolutions
        ("Conv1D", lambda P: P.nn.Conv1D(4, 6, 3, padding="SAME"), [x1],
         fwd, L),
        ("Conv2D", lambda P: P.nn.Conv2D(4, 6, 3, 2, 1, groups=2,
                                         padding_mode="reflect"), [x2], fwd,
         L),
        ("Conv3D", lambda P: P.nn.Conv3D(2, 3, 2, padding=[1, 0, 1]), [x3],
         fwd, L),
        ("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(
            4, 3, 3, 2, 1, output_padding=1), [x1], fwd, L),
        ("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(
            4, 6, 3, 2, "SAME", groups=2), [x2], fwd, L),
        ("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(2, 3, 2, 2),
         [x3], fwd, L),
        # pools
        ("MaxPool1D", lambda P: P.nn.MaxPool1D(3, 2, 1), [x1], fwd, S),
        ("MaxPool2D", lambda P: P.nn.MaxPool2D(3, 2, [[0, 1], [1, 2]]), [x2],
         fwd, S),
        ("MaxPool3D", lambda P: P.nn.MaxPool3D(2, ceil_mode=True), [x3],
         fwd, S),
        ("AvgPool1D", lambda P: P.nn.AvgPool1D(3, 2, 1, exclusive=False),
         [x1], fwd, S),
        ("AvgPool2D", lambda P: P.nn.AvgPool2D(3, 2, "SAME"), [x2], fwd, S),
        ("AvgPool3D", lambda P: P.nn.AvgPool3D(2, 1, 1), [x3], fwd, S),
        ("AdaptiveAvgPool1D", lambda P: P.nn.AdaptiveAvgPool1D(4), [x1], fwd,
         S),
        ("AdaptiveAvgPool2D", lambda P: P.nn.AdaptiveAvgPool2D([3, 5]), [x2],
         fwd, S),
        ("AdaptiveAvgPool3D", lambda P: P.nn.AdaptiveAvgPool3D(2), [x3], fwd,
         S),
        ("AdaptiveMaxPool1D", lambda P: P.nn.AdaptiveMaxPool1D(
            4, return_mask=True), [x1], fwd, S),
        ("AdaptiveMaxPool2D", lambda P: P.nn.AdaptiveMaxPool2D(3), [x2], fwd,
         S),
        ("AdaptiveMaxPool3D", lambda P: P.nn.AdaptiveMaxPool3D(2), [x3], fwd,
         S),
        ("MaxUnPool1D", lambda P: P.nn.MaxUnPool1D(2), [x1],
         lambda P, l, x: l(*P.nn.functional.max_pool1d(
             x, 2, return_mask=True)), S),
        ("MaxUnPool2D", lambda P: P.nn.MaxUnPool2D(2), [x2],
         lambda P, l, x: l(*P.nn.functional.max_pool2d(
             x, 2, return_mask=True)), S),
        ("MaxUnPool3D", lambda P: P.nn.MaxUnPool3D(2), [x3],
         lambda P, l, x: l(*P.nn.functional.max_pool3d(
             x, 2, return_mask=True)), S),
        # norms
        ("BatchNorm", lambda P: P.nn.BatchNorm(4), [x2], fwd, S),
        ("BatchNorm1D", lambda P: P.nn.BatchNorm1D(4), [x1], fwd, S),
        ("BatchNorm2D", lambda P: P.nn.BatchNorm2D(4, data_format="NHWC"),
         [x2.transpose(0, 2, 3, 1).copy()], fwd, S),
        ("BatchNorm3D", lambda P: P.nn.BatchNorm3D(2), [x3], fwd, S),
        ("SyncBatchNorm", lambda P: P.nn.SyncBatchNorm(4), [x2], fwd, S),
        ("GroupNorm", lambda P: P.nn.GroupNorm(2, 4), [x2], fwd, S),
        ("InstanceNorm1D", lambda P: P.nn.InstanceNorm1D(4), [x1], fwd, S),
        ("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(4), [x2], fwd, S),
        ("InstanceNorm3D", lambda P: P.nn.InstanceNorm3D(2), [x3], fwd, S),
        ("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3), [x2],
         fwd, S),
        ("SpectralNorm", lambda P: P.nn.SpectralNorm([4, 7], power_iters=2),
         [r(4, 7, 3, seed=11)], fwd, S),
        # paddings and the common layers
        ("Pad1D", lambda P: P.nn.Pad1D([1, 2], mode="reflect"), [x1], fwd,
         S),
        ("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], mode="circular"), [x2],
         fwd, S),
        ("Pad3D", lambda P: P.nn.Pad3D([1, 1, 0, 1, 2, 0],
                                       mode="replicate"), [x3], fwd, S),
        ("ZeroPad2D", lambda P: P.nn.ZeroPad2D([1, 1, 0, 2]), [x2], fwd, S),
        ("Upsample", lambda P: P.nn.Upsample(scale_factor=2,
                                             mode="bilinear"), [x2], fwd, S),
        ("UpsamplingBilinear2D", lambda P: P.nn.UpsamplingBilinear2D(
            size=[9, 11]), [x2], fwd, S),
        ("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(
            size=[9, 11]), [x2], fwd, S),
        ("Bilinear", lambda P: P.nn.Bilinear(8, 8, 3), [a, b_], fwd, S),
        ("PixelShuffle", lambda P: P.nn.PixelShuffle(2), [x2], fwd, S),
        ("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2),
         [r(2, 2, 4, 6, seed=12)], fwd, S),
        ("ChannelShuffle", lambda P: P.nn.ChannelShuffle(2), [x2], fwd, S),
        ("CosineSimilarity", lambda P: P.nn.CosineSimilarity(), [a, b_],
         fwd, S),
        ("PairwiseDistance", lambda P: P.nn.PairwiseDistance(), [a, b_], fwd,
         S),
        ("Unfold", lambda P: P.nn.Unfold(3, 1, 1), [x2], fwd, S),
        ("Fold", lambda P: P.nn.Fold([4, 5], 2), [r(2, 12, 12, seed=13)],
         fwd, S),
        ("Dropout2D", lambda P: P.nn.Dropout2D(0.5), [x2], fwd, S, False),
        ("Dropout3D", lambda P: P.nn.Dropout3D(0.5), [x3], fwd, S, False),
        ("AlphaDropout", lambda P: P.nn.AlphaDropout(0.5), [x2], fwd, S,
         False),
        # losses
        ("CrossEntropyLoss", lambda P: P.nn.CrossEntropyLoss(
            weight=P.to_tensor(r(5, seed=14, lo=0.5, hi=1.5)),
            label_smoothing=0.1), [logits, lab], fwd, S),
        ("MSELoss", lambda P: P.nn.MSELoss(), [a, b_], fwd, S),
        ("L1Loss", lambda P: P.nn.L1Loss(), [a, b_], fwd, S),
        ("NLLLoss", lambda P: P.nn.NLLLoss(), [logits, lab], fwd, S),
        ("BCELoss", lambda P: P.nn.BCELoss(), [probs, binary], fwd, S),
        ("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(),
         [logits, binary], fwd, S),
        ("KLDivLoss", lambda P: P.nn.KLDivLoss("batchmean"),
         [logits, probs], fwd, S),
        ("SmoothL1Loss", lambda P: P.nn.SmoothL1Loss(delta=0.5), [a, b_],
         fwd, S),
        ("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.1),
         [a[:, 0].copy(), b_[:, 0].copy(), pm1], fwd, S),
        ("HingeEmbeddingLoss", lambda P: P.nn.HingeEmbeddingLoss(),
         [a[:, 0].copy(), pm1], fwd, S),
        ("CosineEmbeddingLoss", lambda P: P.nn.CosineEmbeddingLoss(),
         [a, b_, pm1], fwd, S),
        ("TripletMarginLoss", lambda P: P.nn.TripletMarginLoss(),
         [a, b_, d], fwd, S),
        ("SoftMarginLoss", lambda P: P.nn.SoftMarginLoss(),
         [a[:, 0].copy(), pm1], fwd, S),
        ("MultiMarginLoss", lambda P: P.nn.MultiMarginLoss(), [logits, lab],
         fwd, S),
        ("MultiLabelSoftMarginLoss", lambda P:
         P.nn.MultiLabelSoftMarginLoss(), [logits, binary], fwd, S),
        ("TripletMarginWithDistanceLoss", lambda P:
         P.nn.TripletMarginWithDistanceLoss(), [a, b_, d], fwd, S),
        ("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(8, 7),
         [a[:4].copy(), np.array([0, 3, 6, 2], np.int64)], fwd, S),
        ("CTCLoss", lambda P: P.nn.CTCLoss(), [
            r(10, 3, 5, seed=15), np.array([[1, 2, 2], [3, 1, 0], [4, 4, 1]],
                                           np.int64),
            np.array([10, 8, 9], np.int64), np.array([3, 2, 3], np.int64)],
         fwd, L),
        ("RNNTLoss", lambda P: P.nn.RNNTLoss(), [
            r(2, 5, 4, 6, seed=16), np.array([[1, 2, 3], [4, 5, 0]],
                                             np.int64),
            np.array([5, 4], np.int64), np.array([3, 2], np.int64)], fwd, L),
        # functionals without a layer of their own
        ("F.interpolate_nearest_3d", None, [x3], fn(
            lambda F, x: F.interpolate(x, scale_factor=2,
                                       data_format="NCDHW")), S),
        ("F.interpolate_bicubic_area", None, [x2], fn(
            lambda F, x: (F.interpolate(x, size=[9, 11], mode="bicubic"),
                          F.interpolate(x, size=[3, 5], mode="area"))), S),
        ("F.grid_sample", None, [x2, r(2, 3, 4, 2, seed=17, lo=-1.2,
                                       hi=1.2)],
         fn(lambda F, x, g: F.grid_sample(x, g, padding_mode="border")), S),
        ("F.affine_grid", None, [r(2, 2, 3, seed=18)],
         fn(lambda F, t: F.affine_grid(t, [2, 3, 4, 5])), S),
        ("F.one_hot_label_smooth", None, [lab], fn(
            lambda F, y: F.label_smooth(F.one_hot(y, 5))), S),
        ("F.sequence_mask_gather_tree", None, [
            np.array([3, 0, 5], np.int64),
            np.random.RandomState(19).randint(0, 9, (5, 2, 3)),
            np.random.RandomState(20).randint(0, 3, (5, 2, 3))],
         fn(lambda F, n, i, p: (F.sequence_mask(n), F.gather_tree(i, p))),
         S),
        ("F.temporal_shift", None, [r(4, 8, 3, 3, seed=21)],
         fn(lambda F, x: F.temporal_shift(x, 2)), S),
        ("F.normalize", None, [x2], fn(lambda F, x: F.normalize(x, p=3)), S),
        ("F.sparse_attention", None, [r(1, 2, 4, 8, seed=22)] * 3, fn(
            lambda F, q, k, v: F.sparse_attention(
                q, k, v, _sweep_ids([0, 1, 3, 4, 6]),
                _sweep_ids([0, 0, 1, 1, 3, 2]))), S),
        ("F.losses", None, [logits, lab, probs, binary], fn(
            lambda F, x, y, p, t: (
                F.softmax_with_cross_entropy(x, y.unsqueeze(-1)),
                F.cross_entropy(p, y, use_softmax=False, reduction="none"),
                F.sigmoid_focal_loss(x, t), F.dice_loss(
                    F.softmax(x), y.unsqueeze(-1)),
                F.npair_loss(x, p, y), F.huber_loss(x, p),
                F.log_loss(p, t), F.square_error_cost(x, p),
                F.margin_cross_entropy(x.tanh(), y))), S),
        # recurrent layers
        ("SimpleRNN", lambda P: P.nn.SimpleRNN(4, 6), [r(3, 5, 4, seed=23)],
         fwd, L),
        ("LSTM", lambda P: P.nn.LSTM(4, 6, 2, "bidirect"),
         [r(3, 5, 4, seed=23)], fwd, L),
        ("GRU", lambda P: P.nn.GRU(4, 6, 2, "bidirect", time_major=True),
         [r(5, 3, 4, seed=23)], fwd, L),
        ("SimpleRNNCell", lambda P: P.nn.SimpleRNNCell(4, 6),
         [r(3, 4, seed=24)], fwd, L),
        ("LSTMCell", lambda P: P.nn.LSTMCell(4, 6), [r(3, 4, seed=24)], fwd,
         L),
        ("GRUCell", lambda P: P.nn.GRUCell(4, 6), [r(3, 4, seed=24)], fwd,
         L),
        ("RNN", lambda P: P.nn.RNN(P.nn.GRUCell(4, 6), is_reverse=True),
         [r(3, 5, 4, seed=23)], fwd, L),
        ("BiRNN", lambda P: P.nn.BiRNN(P.nn.LSTMCell(4, 6),
                                       P.nn.SimpleRNNCell(4, 6)),
         [r(3, 5, 4, seed=23)], fwd, L),
        # transformer layers: head_dim 64, so the attention without a mask
        # runs the flash kernels on the card (the cross-attention at
        # Sq != Sk, forward and backward)
        ("MultiHeadAttention", lambda P: P.nn.MultiHeadAttention(128, 2),
         [r(2, 6, 128, seed=25), r(2, 10, 128, seed=26)],
         lambda P, l, q, kv: l(q, kv, kv), L),
        ("TransformerEncoderLayer", lambda P: P.nn.TransformerEncoderLayer(
            128, 2, 256, dropout=0.0, activation="gelu"),
         [r(2, 6, 128, seed=25)], fwd, L),
        ("TransformerEncoder", lambda P: P.nn.TransformerEncoder(
            P.nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0,
                                         normalize_before=True), 2,
            P.nn.LayerNorm(128)), [r(2, 6, 128, seed=25)],
         lambda P, l, x: l(x, _sweep_mask(P, 6)), L),
        ("TransformerDecoderLayer", lambda P: P.nn.TransformerDecoderLayer(
            128, 2, 256, dropout=0.0), [r(2, 6, 128, seed=25),
                                        r(2, 10, 128, seed=26)], fwd, L),
        ("TransformerDecoder", lambda P: P.nn.TransformerDecoder(
            P.nn.TransformerDecoderLayer(128, 2, 256, dropout=0.0), 2),
         [r(2, 6, 128, seed=25), r(2, 10, 128, seed=26)],
         lambda P, l, t, m: l(
             t, m, P.nn.Transformer.generate_square_subsequent_mask(6)), L),
        ("Transformer", lambda P: P.nn.Transformer(128, 2, 1, 2, 256,
                                                   dropout=0.0),
         [r(2, 10, 128, seed=26), r(2, 6, 128, seed=25)], fwd, L),
    ]
    return [c if len(c) == 6 else c + (True,) for c in cases]


def _sweep_ids(values):
    """An int64 tensor on the current device."""
    import numpy as np
    from paddle_tpu_torch.core.tensor import to_tensor
    return to_tensor(np.asarray(values, np.int64))


def _sweep_mask(P, s):
    import numpy as np
    keep = np.ones((2, 1, 1, s), bool)
    keep[1, ..., s - 2:] = False
    return P.to_tensor(keep)


def _sweep_greedy(paddle, model, src, steps):
    """A cached greedy decode of ``steps`` positions through
    ``TransformerDecoder.gen_cache`` (one query row a step against every
    cached key, and against the memory): the outputs of every step and the
    tokens."""
    import numpy as np
    emb = paddle.to_tensor(_sweep_rand(7, 128, seed=30))
    proj = _sweep_rand(128, 7, seed=31)
    model.eval()
    with paddle.no_grad():
        memory = model.encoder(paddle.to_tensor(src))
        cache = model.decoder.gen_cache(memory)
        tok = np.zeros((src.shape[0], 1), np.int64)
        outs, toks = [], [tok]
        for _ in range(steps):
            x = paddle.nn.functional.embedding(paddle.to_tensor(toks[-1]),
                                               emb)
            y, cache = model.decoder(x, memory, cache=cache)
            outs.append(y.numpy()[:, 0].astype(np.float64))
            toks.append((outs[-1] @ proj).argmax(-1)[:, None])
    return np.stack(outs), np.concatenate(toks, 1)


def _sweep_decodes(paddle, seed) -> dict:
    """The transformer's cached greedy decode (kernels on the card against
    their plain versions there, and against the CPU; every flash launch at
    Sq != Sk also held against the plain version on its own inputs) and
    beam search over an LSTMCell (card against CPU)."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import flash_attention as fa
    src = _sweep_rand(2, 10, 128, seed=32)
    paddle.set_device("cpu")
    paddle.seed(seed)
    cpu_model = paddle.nn.Transformer(128, 2, 1, 2, 256, dropout=0.0)
    state = {k: v.numpy() for k, v in cpu_model.state_dict().items()}
    cpu_out, cpu_toks = _sweep_greedy(paddle, cpu_model, src, 5)
    paddle.set_device("gpu")
    model = paddle.nn.Transformer(128, 2, 1, 2, 256, dropout=0.0)
    model.set_state_dict(state)
    orig, inner = fa.flash_attention_fwd, {"calls": 0, "max_abs_err": 0.0,
                                           "shapes": set()}

    def held(q, k, v, causal=True, scale=None):
        out, lse = orig(q, k, v, causal=causal, scale=scale)
        if q.shape[1] != k.shape[1]:
            ref, _ = ca.mha_fwd_reference(q, k, v, causal=causal,
                                          scale=scale)
            inner["calls"] += 1
            inner["max_abs_err"] = max(inner["max_abs_err"],
                                       max_abs_err(out, ref))
            inner["shapes"].add((q.shape[1], k.shape[1]))
        return out, lse
    fa.flash_attention_fwd = held
    try:
        _reset_counts()
        card_out, card_toks = _sweep_greedy(paddle, model, src, 5)
        launches = _read_counts()["launches"]["flash_fwd"]
    finally:
        fa.flash_attention_fwd = orig
    with _plain_attention():
        plain_out, plain_toks = _sweep_greedy(paddle, model, src, 5)
    scale = float(np.abs(plain_out).max())
    res = {"flash_launches": launches, "sq_ne_sk_calls": inner["calls"],
           "sq_ne_sk_shapes": sorted(inner["shapes"]),
           "sq_ne_sk_max_abs_err": inner["max_abs_err"],
           "vs_plain": float(np.abs(card_out - plain_out).max()) / scale,
           "vs_cpu": float(np.abs(card_out - cpu_out).max()) / scale}
    require(launches > 0 and inner["calls"] > 0,
            f"sweep: the cached decode launched no flash kernel at Sq != Sk "
            f"({res})")
    require(inner["max_abs_err"] <= 2e-5,
            f"sweep: flash at Sq != Sk differs from the plain version by "
            f"{inner['max_abs_err']:.2e}")
    require(res["vs_plain"] <= SWEEP_LOOSE and res["vs_cpu"] <= SWEEP_LOOSE,
            f"sweep: cached decode differs: {res}")
    require(bool((card_toks == plain_toks).all() and
                 (card_toks == cpu_toks).all()),
            "sweep: cached greedy decode picked other tokens")
    res["beam_search"] = _sweep_beam(paddle, seed)
    return res


def _sweep_beam(paddle, seed) -> float:
    import numpy as np
    ids, scores = {}, {}
    state = None
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        paddle.seed(seed)
        cell = paddle.nn.LSTMCell(4, 6)
        emb = paddle.nn.Embedding(9, 4)
        out = paddle.nn.Linear(6, 9)
        if state is None:
            state = [m.state_dict() for m in (cell, emb, out)]
            state = [{k: v.numpy() for k, v in s.items()} for s in state]
        for m, s in zip((cell, emb, out), state):
            m.set_state_dict(s)
        dec = paddle.nn.BeamSearchDecoder(cell, 0, 1, 3, emb, out)
        ref = paddle.to_tensor(np.zeros((2, 4), np.float32))
        i, sc = paddle.nn.dynamic_decode(
            dec, inits=cell.get_initial_states(ref), max_step_num=6)
        ids[dev], scores[dev] = i.numpy(), sc.numpy()
    require(bool((ids["cpu"] == ids["gpu"]).all()),
            "sweep: beam search picked other ids on the card")
    err = float(np.abs(scores["cpu"] - scores["gpu"]).max())
    require(err <= SWEEP_LIMIT * max(1.0, float(np.abs(scores["cpu"]).max())),
            f"sweep: beam scores differ by {err:.2e}")
    return err


def _nn_sweep(paddle, seed) -> dict:
    """Every layer class the slice ported, built once at a small size with
    the same weights on the card and on the CPU, forward and backward in
    float32 with TF32 off; the worst error per layer printed on a line of
    its own."""
    worst = {}
    for name, make, arrays, call, limit, train in _sweep_cases():
        err = _sweep_case(paddle, make, arrays, call, train)
        worst[name] = err
        require(err <= limit, f"sweep: {name} differs by {err:.2e} of its "
                              f"largest, beyond {limit}")
    decodes = _sweep_decodes(paddle, seed)
    short = _sweep_short_windows(seed)
    log("nn sweep: " + json.dumps({"worst_rel_err": worst,
                                   "decodes": decodes,
                                   "short_windows": short}))
    return {"worst_rel_err": worst, "decodes": decodes,
            "short_windows": short, "layers": len(worst)}


def _sweep_short_windows(seed) -> list:
    """The 16-bit backward kernels at query windows whose length is not a
    multiple of 4 (a small MHA's, a short sequence's), which the wrapper
    pads: against the plain version by the kernels phase's limits."""
    import torch
    rows = []
    for b, s, h, d, dtype, causal, sk in (
            (2, 6, 2, 64, torch.bfloat16, False, 10),
            (2, 9, 2, 64, torch.bfloat16, True, None),
            (3, 15, 4, 128, torch.float16, False, 40),
            (2, 1, 3, 64, torch.bfloat16, False, 7)):
        row = _bwd_case(b, s, h, d, dtype, causal, seed + 94, sk=sk)
        check_bwd(row)
        rows.append({k: row[k] for k in ("case", "dq_grad_err",
                                         "dk_grad_err", "dv_grad_err")})
    return rows

# ------------------------------------------- hapi: paddle.Model on the card
HAPI_SCRIPT = REPO / "tests" / "test_torch_api_hapi.py"
HAPI_TRAIN_BATCHES, HAPI_EVAL_BATCHES = 6, 2
HAPI_WARMUP = 3        # steps of LAMB's linear learning-rate warm-up
HAPI_TIMED_STEPS = 3
# the optimizer sweep: three steps of each new optimizer on a small net,
# card against CPU in float32 with TF32 off, each parameter within 1e-5 of
# its tensor's largest wherever its gradient is farther from zero than
# NN_NOISE_BAND of the largest (elsewhere the adaptive rules turn rounding
# into updates of up to lr)
HAPI_SWEEP_STEPS = 3
HAPI_SWEEP_LIMIT = 1e-5
HAPI_SWEEP_OPTS = (
    ("LarsMomentum", lambda O, ps: O.LarsMomentum(
        0.1, 0.9, lars_coeff=0.01, lars_weight_decay=0.01, parameters=ps)),
    ("LarsMomentumOptimizer", lambda O, ps: O.LarsMomentumOptimizer(
        0.05, 0.8, parameters=ps, epsilon=1e-6, rescale_grad=0.5)),
    ("Adagrad", lambda O, ps: O.Adagrad(0.1, parameters=ps)),
    ("Adadelta", lambda O, ps: O.Adadelta(1.0, rho=0.9, parameters=ps)),
    ("Adamax", lambda O, ps: O.Adamax(0.02, parameters=ps)),
    ("RMSProp", lambda O, ps: O.RMSProp(0.01, rho=0.9, momentum=0.5,
                                        centered=True, parameters=ps)),
    ("Lamb", lambda O, ps: O.Lamb(
        0.01, lamb_weight_decay=0.05, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)))


@contextlib.contextmanager
def _lamb_trust_log(entries):
    """Record each LAMB update's learning rate and every tensor's trust
    ratio (0-d tensors on the device, keyed by the torch tensor's id): an
    element whose gradient is rounding noise moves by at most 2 lr trust a
    step on either route, LAMB's bound."""
    from paddle_tpu_torch.optimizer import optimizer as om
    orig_trust, orig_rule = om._trust, om.Lamb._update_rule
    made = []

    def trust(*args):
        made.append(orig_trust(*args))
        return made[-1]

    def rule(self, ps, gs, lr, t, wd, st):
        made.clear()
        orig_rule(self, ps, gs, lr, t, wd, st)
        entries.append((lr, {id(p): x for p, x in zip(ps, made[-1])}))
    om._trust, om.Lamb._update_rule = trust, rule
    try:
        yield
    finally:
        om._trust, om.Lamb._update_rule = orig_trust, orig_rule


def _hapi_counts_at_eval(paddle):
    """A callback keeping the counts as the first evaluation begins: the
    training steps' launches."""
    class CountsAtEval(paddle.callbacks.Callback):
        train = None

        def on_eval_begin(self, logs=None):
            if self.train is None:
                self.train = _read_counts()
    return CountsAtEval()


def _hapi_batches(data, n):
    import numpy as np
    b = NN_CFG["batch"]
    return [(np.stack([data[j][0] for j in range(i * b, (i + 1) * b)]),
             np.stack([data[j][1] for j in range(i * b, (i + 1) * b)]))
            for i in range(n)]


def _hapi_run(h, script, paddle, init, data, amp, plain, seed, tmp):
    """``Model(classifier).prepare(Lamb, CrossEntropyLoss, Accuracy,
    amp_configs=amp).fit`` from ``init`` for one epoch of the training
    batches with the evaluation batches (the callbacks of
    ``fit_run``), through the kernels or their plain versions (the same
    dropout masks from ``seed``); then ``evaluate`` and ``predict``. Returns
    the losses, the last step's gradients, each parameter's noise band
    (gradient within NN_NOISE_BAND of the largest at any step), LAMB's
    bound per parameter, the parameters, the counts of each part and the
    accuracy the callbacks logged against the one recomputed from the
    steps' logits."""
    import numpy as np
    import torch
    train, evald = data
    paddle.seed(seed)
    model = h.make_model(paddle, script, NN_CFG, init=init, amp=amp,
                         warmup=HAPI_WARMUP)
    net, opt = model.network, model._optimizer
    band, last = {}, {}

    def step_seeing_grads():
        for n, p in net.named_parameters():
            g = p.grad._data.detach().float()
            small = g.abs() <= NN_NOISE_BAND * g.abs().max()
            band[n] = small if n not in band else band[n] | small
            last[n] = g.clone()
        type(opt).step(opt)
    opt.step = step_seeing_grads
    logits = []
    hook = net.register_forward_post_hook(
        lambda layer, inputs, out: logits.append(out._data.detach().clone())
        if layer.training else None)
    at_eval, trust = _hapi_counts_at_eval(paddle), []
    _reset_counts()
    with _plain_attention() if plain else contextlib.nullcontext(), \
            _lamb_trust_log(trust):
        hist, events, _ = h.fit_run(paddle, model, train, evald,
                                    NN_CFG["batch"], str(tmp / "ckpt"),
                                    extra=(at_eval,))
    torch.cuda.synchronize()
    fit_counts = _read_counts()
    hook.remove()
    del opt.step
    files = sorted(p.name for p in (tmp / "ckpt").iterdir())
    for f in (tmp / "ckpt").iterdir():
        f.unlink()
    # the accuracy the callbacks logged, step by step, against the one
    # recomputed from the training steps' logits and the labels
    logged = [e[-1]["acc"] for e in events if e[0] == "train_batch_end"]
    total, count, recomputed = 0.0, 0, []
    for out, (_, labels) in zip(logits, _hapi_batches(train, len(logits))):
        top = out.topk(1, dim=-1).indices[:, 0].cpu().numpy()
        total += float((top == labels).astype(np.float32).sum())
        count += len(labels)
        recomputed.append(total / count)
    with _plain_attention() if plain else contextlib.nullcontext():
        _reset_counts()
        ev = model.evaluate(evald, batch_size=NN_CFG["batch"], verbose=0)
        torch.cuda.synchronize()
        eval_counts = _read_counts()
        _reset_counts()
        pred = model.predict(evald, batch_size=NN_CFG["batch"])
        torch.cuda.synchronize()
        pred_counts = _read_counts()
    names = {id(p._data): n for n, p in net.named_parameters()}
    bound = {}
    for lr, per in trust:
        for pid, x in per.items():
            bound[names[pid]] = bound.get(names[pid], 0.0) + 2 * lr * float(
                x)
    return {"losses": hist["loss"], "eval_loss": hist.get("eval_loss"),
            "events": [e[0] for e in events], "files": files,
            "grads": last, "band": band, "lamb_bound": bound,
            "params": {n: p._data.detach().float().clone()
                       for n, p in net.named_parameters()},
            "train_counts": at_eval.train, "fit_counts": fit_counts,
            "eval_counts": eval_counts, "pred_counts": pred_counts,
            "acc_logged": logged, "acc_recomputed": recomputed,
            "evaluate": ev, "pred": pred, "model": model}


def _hapi_require_counts(tag, run):
    """12 launches a training step of each flash kernel, 12 forward
    launches an evaluation step (fit's, evaluate's and predict's), no plain
    and no dense call; the accuracy the callbacks logged is the steps'
    logits'; ModelCheckpoint wrote its files."""
    layers = NN_CFG["layers"]
    n_train, n_eval = HAPI_TRAIN_BATCHES, HAPI_EVAL_BATCHES
    _require_launches(f"hapi {tag} fit's training steps",
                      run["train_counts"],
                      {k: layers for k in ("flash_fwd", "flash_bwd_dq",
                                           "flash_bwd_dkv")}, n_train)
    want = {"fit_counts": {"flash_fwd": layers * (n_train + n_eval),
                           "flash_bwd_dq": layers * n_train,
                           "flash_bwd_dkv": layers * n_train},
            "eval_counts": {"flash_fwd": layers * n_eval,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}}
    want["pred_counts"] = want["eval_counts"]
    for part, launches in want.items():
        c = run[part]
        require(c["launches"] == launches,
                f"hapi {tag} {part}: launched {c['launches']}, not "
                f"{launches}")
        require(not any(c["plain_calls"].values()) and
                c["dense_calls"] == 0,
                f"hapi {tag} {part}: plain calls {c['plain_calls']}, "
                f"dense calls {c['dense_calls']}")
    require(run["acc_logged"] == run["acc_recomputed"] and
            len(run["acc_logged"]) == n_train,
            f"hapi {tag}: the logged accuracy {run['acc_logged']} is not the "
            f"one of the steps' logits {run['acc_recomputed']}")
    require(run["files"] == ["0.pdopt", "0.pdparams", "final.pdopt",
                             "final.pdparams"],
            f"hapi {tag}: ModelCheckpoint wrote {run['files']}")


def _hapi_f32_check(k32, p32) -> dict:
    """float32 kernels against plain versions: losses ≤ 1e-5 relative,
    the last step's gradients ≤ 1e-4 of each parameter's largest (the key
    projections' biases, whose gradient is rounding noise, aside), the
    parameters ≤ 1e-6 outside the noise band and within LAMB's bound (2 lr
    trust a step, the larger of the two routes') inside it."""
    import torch
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(k32["losses"], p32["losses"]))
    by_param = {n: max_abs_err(k32["grads"][n], g) / max(
        float(g.abs().max()), 1e-30) for n, g in p32["grads"].items()
        if not n.endswith(K_BIAS)}
    grad_rel = max(by_param.values())
    q_rel = max(v for n, v in by_param.items() if Q_PROJ in n)
    param_err = band_ratio = 0.0
    for n, p in p32["params"].items():
        d = (k32["params"][n] - p).abs()
        noise = k32["band"][n] | p32["band"][n]
        if n.endswith(K_BIAS):           # all rounding noise
            noise = torch.ones_like(noise)
        bound = max(k32["lamb_bound"][n], p32["lamb_bound"][n]) * (1 + 1e-3)
        if bool((~noise).any()):
            param_err = max(param_err, float(d[~noise].max()))
        if bool(noise.any()):
            band_ratio = max(band_ratio, float(d[noise].max()) / bound)
    out = {"f32_losses": {"kernels": k32["losses"], "plain": p32["losses"]},
           "f32_loss_rel": loss_rel, "f32_last_grad_rel_max": grad_rel,
           "f32_q_proj_last_grad_rel_max": q_rel,
           "f32_grad_rel_worst": sorted(by_param.items(),
                                        key=lambda kv: -kv[1])[:6],
           "f32_param_max_abs_err_outside_band": param_err,
           "f32_band_err_over_lamb_bound": band_ratio}
    require(all(math.isfinite(x) for x in k32["losses"]),
            f"hapi: non-finite float32 loss {k32['losses']}")
    require(loss_rel <= TRAIN_F32_LOSS_RTOL,
            f"hapi: float32 losses differ by {loss_rel:.2e}")
    require(grad_rel <= TRAIN_F32_GRAD_RTOL,
            f"hapi: float32 gradients differ by {grad_rel:.2e} of their "
            f"largest")
    require(param_err <= TRAIN_F32_PARAM_ATOL,
            f"hapi: float32 parameters differ by {param_err:.2e} outside "
            f"the noise band")
    require(band_ratio <= 1.0,
            f"hapi: noise-band elements differ by {band_ratio:.2f} x LAMB's "
            f"bound")
    return out


def _hapi_timed(paddle, model, train, tag) -> dict:
    """ms a ``train_batch`` over HAPI_TIMED_STEPS steps after one, and a
    profiled step (the busy share)."""
    import torch
    batches = [(paddle.to_tensor(x), paddle.to_tensor(y))
               for x, y in _hapi_batches(train, HAPI_TIMED_STEPS)]
    model.train_batch(*batches[0])

    def window():
        for x, y in batches:
            model.train_batch(x, y)
    wall, _ = _timed_window(window, HAPI_TIMED_STEPS)
    prof = device_profile(lambda: (model.train_batch(*batches[0]),
                                   torch.cuda.synchronize()), 1)
    ms = wall / HAPI_TIMED_STEPS * 1e3
    return {f"{tag}_step_ms": ms, f"{tag}_step_profile": prof,
            f"{tag}_device_busy_share_of_step":
                prof["device_busy_ms_per_step"] / ms}


def _hapi_sweep_net(paddle, device):
    paddle.set_device(device)
    paddle.seed(0)
    nn = paddle.nn
    return nn.Sequential(nn.Linear(32, 64), nn.GELU(), nn.LayerNorm(64),
                         nn.Linear(64, 16))


def _hapi_sweep_side(paddle, device, make_opt, init, x):
    """HAPI_SWEEP_STEPS steps of ``make_opt``'s optimizer on ``device`` from
    ``init``: the parameters after and each step's gradients, float64."""
    import numpy as np
    net = _hapi_sweep_net(paddle, device)
    net.set_state_dict(init)
    opt = make_opt(paddle.optimizer, net.parameters())
    grads = []
    for _ in range(HAPI_SWEEP_STEPS):
        y = net(paddle.to_tensor(x))
        (y * y).mean().backward()
        grads.append({n: p.grad.numpy().astype(np.float64)
                      for n, p in net.named_parameters()})
        opt.step()
        opt.clear_grad()
    return ({n: p.numpy().astype(np.float64)
             for n, p in net.state_dict().items()}, grads)


def _hapi_optimizer_sweep(paddle, seed) -> dict:
    """Each new optimizer (and LarsMomentumOptimizer) three steps on a
    small net, card against CPU from the same weights: every parameter's
    largest difference outside the noise band over its tensor's largest,
    held to HAPI_SWEEP_LIMIT (the band's own reported)."""
    import numpy as np
    x = _sweep_rand(8, 32, seed=seed + 5)
    init = {n: t.numpy() for n, t in
            _hapi_sweep_net(paddle, "cpu").state_dict().items()}
    out = {}
    for name, make in HAPI_SWEEP_OPTS:
        cpu, grads = _hapi_sweep_side(paddle, "cpu", make, init, x)
        card, _ = _hapi_sweep_side(paddle, "gpu", make, init, x)
        worst = in_band = 0.0
        for n, p in cpu.items():
            noise = np.zeros(p.shape, bool)
            for g in grads:
                noise |= np.abs(g[n]) <= NN_NOISE_BAND * np.abs(g[n]).max()
            d = np.abs(card[n] - p) / np.abs(p).max()
            if (~noise).any():
                worst = max(worst, float(d[~noise].max()))
            if noise.any():
                in_band = max(in_band, float(d[noise].max()))
        out[name] = {"rel_err": worst, "noise_band_rel_err": in_band}
        require(worst <= HAPI_SWEEP_LIMIT,
                f"hapi sweep: {name}'s parameters differ by {worst:.2e} of "
                f"their largest, card against CPU")
    paddle.set_device("gpu")
    log("hapi sweep: " + json.dumps(out))
    return out


def phase_hapi(state):
    """paddle.Model (hapi) on the card: the nn phase's encoder classifier
    at BERT-base's widths, B=32, S=512, wrapped in ``paddle.Model`` and
    prepared with LAMB (a linear warm-up, no decay on biases and norms),
    CrossEntropyLoss and Accuracy; ``fit`` for one epoch of six batches
    with two evaluation batches and the LRScheduler, ModelCheckpoint and
    EarlyStopping callbacks, then ``evaluate`` and ``predict``, through the
    kernels and their plain versions in float32 (TF32 off) and under
    ``amp_configs="O2"``; ``Model.save`` then ``load`` into a fresh model;
    ms a step and a profiled step of each precision; then the optimizer
    sweep, card against CPU."""
    import tempfile

    import torch
    import paddle_tpu_torch as paddle
    script = _load_script(ENCODER_SCRIPT, "encoder_script")
    h = _load_script(HAPI_SCRIPT, "hapi_script")
    paddle.set_device("gpu")
    seed = state["seed"]
    data = (h.samples(paddle, NN_CFG, HAPI_TRAIN_BATCHES, seed + 1),
            h.samples(paddle, NN_CFG, HAPI_EVAL_BATCHES, seed + 2))
    paddle.seed(seed)
    base = script.build_model(paddle, NN_CFG)
    init = {n: t._data.detach().clone() for n, t in base.state_dict().items()}
    del base
    out = {"config": "bert_base encoder classifier through paddle.Model "
                     "(Lamb, CrossEntropyLoss, Accuracy)",
           "batch": NN_CFG["batch"], "seq": NN_CFG["seq"],
           "train_batches": HAPI_TRAIN_BATCHES,
           "eval_batches": HAPI_EVAL_BATCHES, "warmup": HAPI_WARMUP,
           "lr": NN_CFG["lr"], "dropout": NN_CFG["dropout"]}
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        k32 = _hapi_run(h, script, paddle, init, data, None, False, seed,
                        tmp)
        _hapi_require_counts("float32", k32)
        # save, then load into a model built from another seed
        path = str(tmp / "saved")
        k32["model"].save(path)
        paddle.seed(seed + 7)
        fresh = h.make_model(paddle, script, NN_CFG)
        fresh.load(path)
        again = fresh.predict(data[1], batch_size=NN_CFG["batch"])
        require(len(again) == HAPI_EVAL_BATCHES and all(
            torch.equal(a._data, b._data)
            for a, b in zip(k32["pred"], again)),
            "hapi: predict after Model.load differs from the saved model's")
        del fresh, again
        p32 = _hapi_run(h, script, paddle, init, data, None, True, seed,
                        tmp)
        require(not any(p32["fit_counts"]["launches"].values()),
                f"hapi: the plain route launched {p32['fit_counts']}")
        out.update(_hapi_f32_check(k32, p32))
        out["f32_evaluate"] = {"kernels": k32["evaluate"],
                               "plain": p32["evaluate"]}
        f32_launches = _add_launches(
            _add_launches(k32["fit_counts"]["launches"],
                          k32["eval_counts"]["launches"]),
            k32["pred_counts"]["launches"])
        ref32 = {"losses": p32["losses"], "params": p32["params"]}
        del p32
        out.update(_hapi_timed(paddle, k32["model"], data[0], "f32"))
        del k32
        torch.cuda.empty_cache()
        kb = _hapi_run(h, script, paddle, init, data, "O2", False, seed,
                       tmp)
        _hapi_require_counts("bf16 O2", kb)
        pb = _hapi_run(h, script, paddle, init, data, "O2", True, seed, tmp)

        def l2(params):
            return float(torch.sqrt(sum(
                ((params[n] - p).double() ** 2).sum()
                for n, p in ref32["params"].items())))
        o2 = {"losses_kernel": kb["losses"], "losses_plain": pb["losses"],
              "loss_kernel": max(abs(a - b) for a, b in zip(
                  kb["losses"], ref32["losses"])),
              "loss_plain": max(abs(a - b) for a, b in zip(
                  pb["losses"], ref32["losses"])),
              "params_l2_kernel": l2(kb["params"]),
              "params_l2_plain": l2(pb["params"])}
        out["o2"] = o2
        for what in ("loss", "params_l2"):
            k, p = o2[f"{what}_kernel"], o2[f"{what}_plain"]
            require(k <= BF16_FLOOR_FACTOR * p,
                    f"hapi: O2 {what} {k:.3e} from float32, beyond "
                    f"{BF16_FLOOR_FACTOR} x the plain path's {p:.3e}")
        # O2 trains in bf16 and evaluates in float32 (no AMP outside the
        # training forward, as the reference)
        bf16_launches = kb["train_counts"]["launches"]
        f32_launches = _add_launches(f32_launches, {
            k: kb["fit_counts"]["launches"][k] - n
            + kb["eval_counts"]["launches"][k]
            + kb["pred_counts"]["launches"][k]
            for k, n in bf16_launches.items()})
        del pb, ref32
        torch.cuda.empty_cache()
        out.update(_hapi_timed(paddle, kb["model"], data[0], "bf16"))
        del kb
        torch.cuda.empty_cache()
    out["launches"] = {"bf16": bf16_launches, "f32": f32_launches}
    if "nn" in state:
        out["nn_bare_loop_step_ms"] = {
            prec: state["nn"][f"{prec}_step_ms"] for prec in ("f32", "bf16")}
    out["sweep"] = _hapi_optimizer_sweep(paddle, seed)
    log("hapi: " + json.dumps({k: v for k, v in out.items()
                               if not k.endswith("_step_profile")}))
    for prec in ("f32", "bf16"):
        log(f"hapi: {prec} step profile "
            + json.dumps(out[f"{prec}_step_profile"]))
    state["hapi"] = out


# ------------------------------------------- the operations plane
# gpt3_1p3b (full width and depth, bf16, the prefix cache on) served by a
# GenerationServer under a two-tenant scheduler: a first wave of bulk
# streams (priority class "batch", a token quota that refuses one more
# request) fills all but OPS_SPARE_PAGES pages, fewer than one realtime
# reservation, so the realtime wave has to park bulk streams, which later
# resume from their full history (a chunked prefill over the prompt pages
# the prefix cache still holds).
OPS_BULK, OPS_BULK_PROMPT, OPS_BULK_NEW = 6, 1024, 256    # 80 pages each
OPS_RT, OPS_RT_PROMPT, OPS_RT_NEW = 3, 256, 64            # 20 pages each
OPS_SPARE_PAGES = 16
OPS_DRAIN_NEW = 128        # the stream that drains while /readyz is read
# the decode step with and without telemetry and sampling: 8 streams of
# 128-token prompts, 64 new tokens, in turns off, on, on, off
OPS_CMP_STREAMS, OPS_CMP_PROMPT, OPS_CMP_NEW = 8, 128, 64
OPS_PROFILE_STEPS = 24     # decode steps inside the profiled window
OPS_PROFILE_NEW = 512      # the profiled run's budget (cancelled after it)
# the InferenceServer leg: ERNIE-base in float32 under two tenants
OPS_INFER_REQUESTS = 64    # a tenant
OPS_INFER_BURST = 60       # the offline tenant's quota in rows: 4 refused
OPS_ENDPOINTS = ("/metrics", "/metrics?format=json", "/healthz", "/readyz",
                 "/statusz", "/schedz", "/tracez", "/sloz", "/goodputz")
# the runtime and numerics plane's endpoints (they answered 501 before the
# plane was ported) and each body's top-level keys
OPS_PLANE = {"/execz": {"peaks", "entries", "sites", "kinds", "n_entries"},
             "/profilez": {"dir", "artifacts", "armed_on_anomaly",
                           "min_interval_s", "max_ms", "anomaly_ms"},
             "/numericsz": {"serving", "train", "shadow", "int8", "canary",
                            "anomalies", "pending", "enabled", "rates"}}
# one sample line of Prometheus text 0.0.4: name, optional labels, value
PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r' (-?[0-9][0-9.eE+-]*|[+-]Inf|NaN)$')


def _http_get(port, path, timeout=10.0):
    """GET http://127.0.0.1:<port><path> with no proxy: (status, body)."""
    import urllib.error
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(f"http://127.0.0.1:{port}{path}",
                         timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _parse_prometheus(text: str) -> dict:
    """Prometheus text 0.0.4 -> {(sample name, label string): value};
    fails on a line that does not parse or a sample without its # TYPE."""
    types, samples = {}, {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        m = PROM_SAMPLE.match(line)
        require(m is not None, f"ops: /metrics line does not parse: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        require(name in types or base in types,
                f"ops: /metrics sample {name} has no # TYPE line")
        samples[(name, labels)] = float(value)
    return samples


def _scrape(port, tag) -> dict:
    """Every endpoint answers 200; the runtime and numerics plane's three
    with their bodies' top-level keys."""
    out = {}
    for path in OPS_ENDPOINTS:
        code, body = _http_get(port, path)
        require(code == 200, f"ops: {tag}: {path} answered {code}: "
                             f"{body[:300]}")
        out[path] = body
    for path, keys in OPS_PLANE.items():
        code, body = _http_get(port, path)
        require(code == 200 and set(json.loads(body)) == keys,
                f"ops: {tag}: {path} answered {code}, not 200 with keys "
                f"{sorted(keys)}: {body[:300]}")
        out[path] = body
    return out


def _first_tokens(futs, t_submit):
    """A thread per stream that waits for its first token: the threads and
    a list that they fill with each stream's TTFT in ms."""
    import threading
    ttft = [None] * len(futs)

    def wait(i):
        for _ in futs[i]:
            ttft[i] = (time.perf_counter() - t_submit[i]) * 1e3
            return

    threads = [threading.Thread(target=wait, args=(i,), daemon=True)
               for i in range(len(futs))]
    for t in threads:
        t.start()
    return threads, ttft


def _wait_for(cond, timeout_s, what, tag="ops"):
    t0 = time.perf_counter()
    while not cond():
        require(time.perf_counter() - t0 < timeout_s,
                f"{tag}: {what} did not happen within {timeout_s} s")
        time.sleep(0.005)


def _reset_paged_counts():
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    cpa.launches = cpa.plain_calls = 0
    cpa.launches_by, cpa.launches_by_kernel = {}, {}


def _ops_engine(state, model) -> dict:
    """The scheduled engine run: bulk wave, the over-quota request, the
    realtime wave that parks bulk streams; the endpoints read over HTTP
    while it runs; then a draining shutdown with /readyz read."""
    import json as _json
    import threading
    import numpy as np
    from paddle_tpu_torch.observability import stepprof, tracing
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving import QuotaExceededError
    from paddle_tpu_torch.serving.generation import GenerationServer
    from paddle_tpu_torch.serving.scheduling import (AdmissionController,
                                                     SchedulerPolicy,
                                                     TenantPolicy)
    cfg = model.config
    layers = cfg.num_layers
    rng = np.random.RandomState(state["seed"] + 17)
    bulk_cost = OPS_BULK_PROMPT + OPS_BULK_NEW
    policy = SchedulerPolicy(tenants={
        "rt": TenantPolicy("rt", rate=0.0, weight=4.0, priority="realtime"),
        # a quota of exactly OPS_BULK requests (the refill is 1e-3 tokens
        # a second: nothing within the run)
        "bulk": TenantPolicy("bulk", rate=1e-3, burst=OPS_BULK * bulk_cost,
                             priority="batch")})
    ctl = AdmissionController(policy, name="ops")
    per_bulk = -(-bulk_cost // PAGE_SIZE)
    per_rt = -(-(OPS_RT_PROMPT + OPS_RT_NEW) // PAGE_SIZE)
    require(OPS_SPARE_PAGES < per_rt, "ops: spare pages must not fit an rt "
                                      "reservation")
    num_pages = 1 + OPS_BULK * per_bulk + OPS_SPARE_PAGES
    srv = GenerationServer(model, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                           num_pages=num_pages, device="cuda",
                           telemetry_port=0, scheduler=ctl, name="ops")
    port = srv.telemetry.port
    log(f"ops: engine of {num_pages} pages ({srv.kv.pool_bytes() / 1e9:.2f} "
        f"GB of bf16 K/V pools), telemetry on 127.0.0.1:{port}")
    bulk_prompts = [rng.randint(0, cfg.vocab_size, OPS_BULK_PROMPT)
                    for _ in range(OPS_BULK + 1)]
    rt_prompts = [rng.randint(0, cfg.vocab_size, OPS_RT_PROMPT)
                  for _ in range(OPS_RT + 1)]
    futs, tenants, contexts, t_submit = [], [], [], []

    def submit(prompt, new, tenant, i):
        ctx = tracing.new_context()          # head-sampled at rate 1.0
        require(ctx.sampled, "ops: a request was not head-sampled at 1.0")
        with tracing.use_context(ctx):
            t_submit.append(time.perf_counter())
            futs.append(srv.submit_generate(
                prompt, max_new_tokens=new,
                temperature=0.0 if i % 2 == 0 else 0.8,
                seed=state["seed"] + 100 + len(futs), tenant=tenant))
        tenants.append(tenant)
        contexts.append(ctx)

    _reset_counts()
    _reset_paged_counts()
    t0 = time.perf_counter()
    for i in range(OPS_BULK):
        submit(bulk_prompts[i], OPS_BULK_NEW, "bulk", i)
    try:
        srv.submit_generate(bulk_prompts[OPS_BULK],
                            max_new_tokens=OPS_BULK_NEW, tenant="bulk")
        refused = None
    except QuotaExceededError as e:
        refused = e
    require(refused is not None and refused.tenant == "bulk",
            f"ops: the over-quota bulk request was not refused with "
            f"QuotaExceededError(tenant='bulk'): {refused!r}")
    threads, ttft = _first_tokens(futs[:OPS_BULK], t_submit)
    # the bulk wave decodes before the realtime wave arrives
    _wait_for(lambda: all(len(f.tokens()) >= 8 for f in futs), 300,
              "the bulk wave's first 8 tokens")
    for t in threads:
        t.join()
    for i in range(OPS_RT):
        submit(rt_prompts[i], OPS_RT_NEW, "rt", i)
    rt_threads, rt_ttft = _first_tokens(futs[OPS_BULK:],
                                        t_submit[OPS_BULK:])
    _wait_for(lambda: srv.metrics_snapshot()["counters"]["parked"] >= 1,
              300, "a bulk stream's parking")
    mid = _scrape(port, "mid-run")
    mid_status = _json.loads(mid["/statusz"])
    mid_sched = _json.loads(mid["/schedz"])
    _parse_prometheus(mid["/metrics"])
    section = (mid_status.get("decode_engines") or {}).get("ops")
    require(section is not None and "tenant_queue_depth" in section,
            f"ops: /statusz has no engine section with tenant_queue_depth: "
            f"{mid_status.get('decode_engines')}")
    events = mid_sched["admission"]["ops"]["events"]
    require({"rt", "bulk"} <= set(events), f"ops: /schedz shows {events}")
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    for t in rt_threads:
        t.join()
    counts = _read_counts()
    by_kernel = dict(cpa.launches_by_kernel)
    paged = (cpa.launches, cpa.plain_calls)
    snap = srv.metrics_snapshot()
    calls = dict(srv.decoder.calls)
    c = snap["counters"]
    news = [OPS_BULK_NEW] * OPS_BULK + [OPS_RT_NEW] * OPS_RT
    for i, (f, toks, n) in enumerate(zip(futs, outs, news)):
        require(f.finish_reason == "length" and len(toks) == n,
                f"ops: stream {i} ({tenants[i]}) ended {f.finish_reason} "
                f"after {len(toks)} of {n} tokens")
    require(c["parked"] >= 1 and c["resumed"] >= 1 and c["preempted"] == 0,
            f"ops: counters {c}")
    end = _scrape(port, "end")
    samples = _parse_prometheus(end["/metrics"])
    key = ("paddle_decode_requests_total", '{event="parked",server="ops"}')
    require(samples.get(key) == c["parked"],
            f"ops: /metrics reads {samples.get(key)} parked, the engine "
            f"{c['parked']}")
    # the kernels: cold prefills on the flash forward, decode on the split
    # decode kernel, the resumed streams' chunked prefill on the window
    # kernel, every call through all layers, no plain version
    require(counts["plain_calls"]["flash_fwd"] == 0 and paged[1] == 0,
            f"ops: plain calls: flash {counts['plain_calls']['flash_fwd']}, "
            f"paged {paged[1]}")
    want = {"paged_window_bf16": layers * calls["chunked"],
            "paged_decode_split_bf16": layers * calls["decode"]}
    require(calls["chunked"] > 0 and calls["decode"] > 0
            and by_kernel == want
            and counts["launches"]["flash_fwd"] == layers * calls["prefill"],
            f"ops: paged launches {by_kernel}, flash "
            f"{counts['launches']['flash_fwd']}, against the decoder's "
            f"calls {calls}")
    # every traced request: its queue, prefill and decode_step spans under
    # its trace id, in the recorder and over /tracez
    for i, ctx in enumerate(contexts):
        stages = {s["stage"] for s in tracing.spans(ctx.trace_id)}
        require({"queue", "prefill", "decode_step"} <= stages,
                f"ops: stream {i}'s trace has stages {sorted(stages)}")
    code, body = _http_get(port, f"/tracez?trace_id={contexts[-1].trace_id}")
    got = _json.loads(body)["traces"]
    require(code == 200 and len(got) == 1 and {"queue", "prefill",
            "decode_step"} <= {s["stage"] for s in got[0]["spans"]},
            f"ops: /tracez?trace_id= answered {code} with {len(got)} traces")
    prof = stepprof.default_profiler().summary()
    steps_env = prof["kinds"].get("decode", {}).get("samples", 0)
    require(steps_env == snap["decode_steps"],
            f"ops: {steps_env} decode envelopes for "
            f"{snap['decode_steps']} engine decode steps")
    # a draining shutdown: /readyz reads 503 while the last stream drains,
    # and the engine's checks are gone once it returned
    extra_ctx = tracing.new_context()
    with tracing.use_context(extra_ctx):
        extra = srv.submit_generate(rt_prompts[OPS_RT],
                                    max_new_tokens=OPS_DRAIN_NEW, tenant="rt")
    _wait_for(lambda: len(extra.tokens()) >= 1, 120, "the drain stream")
    code_before, _ = _http_get(port, "/readyz")
    closer = threading.Thread(target=srv.shutdown, daemon=True)
    closer.start()
    readyz_draining = None
    while closer.is_alive():
        code, _ = _http_get(port, "/readyz")
        if code == 503:
            readyz_draining = 503
            break
        time.sleep(0.005)
    closer.join(300)
    require(not closer.is_alive(), "ops: shutdown did not return")
    require(code_before == 200 and readyz_draining == 503,
            f"ops: /readyz read {code_before} before shutdown and "
            f"{readyz_draining} while draining, not 200 and 503")
    require(extra.finish_reason == "length"
            and len(extra.result()) == OPS_DRAIN_NEW,
            f"ops: the drained stream ended {extra.finish_reason}")
    code, body = _http_get(port, "/readyz")
    require("decode:ops" not in _json.loads(body)["checks"],
            f"ops: the engine's readiness check outlived shutdown: {body}")
    leak = srv.leak_check()
    require(leak["ok"], f"ops: leak check after shutdown {leak}")
    rec = {"streams": {"bulk": OPS_BULK, "rt": OPS_RT},
           "telemetry_port": port,
           "prompt_new": {"bulk": [OPS_BULK_PROMPT, OPS_BULK_NEW],
                          "rt": [OPS_RT_PROMPT, OPS_RT_NEW]},
           "kv_pages": num_pages, "pool_bytes": srv.kv.pool_bytes(),
           "wall_s": wall, "counters": c,
           "ttft_ms": {"bulk": ttft, "rt": rt_ttft},
           "decode_step_ms": snap["step_ms"]["decode"],
           "prefill_step_ms": snap["step_ms"]["prefill"],
           "decode_steps": snap["decode_steps"],
           "decoder_calls": calls, "prefix": snap["prefix"],
           "launches": {"flash_fwd": counts["launches"]["flash_fwd"],
                        "paged_attention": paged[0]},
           "paged_launches_by_kernel": by_kernel,
           "plain_calls": {"flash_fwd": counts["plain_calls"]["flash_fwd"],
                           "paged_attention": paged[1]},
           "sched_events": srv.scheduler.snapshot()["events"],
           "stepprof": {k: prof["kinds"][k] for k in prof["kinds"]},
           "device_peak_bytes": max(
               (e.get("device_peak_bytes", 0) for e in
                stepprof.default_profiler().envelopes(limit=10 ** 6)),
               default=None),
           "spans": tracing.default_buffer().stats(),
           "readyz": {"before": code_before, "draining": readyz_draining},
           "leak_check": leak["ok"]}
    del srv
    return rec


# the profiled run's kernels, by name: its session must see them
OPS_PREFILL_KERNELS = ("flash_fwd_wgmma_kernel",)
OPS_DECODE_KERNELS = ("paged_attention_decode_kernel",
                      "paged_attention_combine_kernel")
OPS_WINDOW = "chip_smoke::decode_window"   # the window's span on this thread


def _device_kernels(prof) -> dict:
    """Device ms by kernel name over a finished session."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        out[ev.key] = out.get(ev.key, 0.0) + ms
    return out


def _window_kernels(prof, mark: str) -> tuple:
    """Device ms by kernel name over a finished session, of the kernels
    that started before the host span ``mark`` and of those that started
    inside it."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = [e for e in events
             if e.name == mark and e.device_type == DeviceType.CPU]
    require(len(spans) == 1,
            f"ops: the profiled session holds {len(spans)} {mark} spans")
    a, b = spans[0].time_range.start, spans[0].time_range.end
    before, inside = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.time_range.start
        into = inside if a <= t <= b else before if t < a else None
        if into is not None:
            into[e.name] = into.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return before, inside


def _require_seen(kernels: dict, want, what: str):
    """Every name of ``want`` among the kernels a session saw: a blind
    profile fails."""
    missing = [k for k in want if not any(k in n for n in kernels)]
    require(not missing, f"ops: the profiled {what} saw none of {missing} "
            f"(kernels seen: {sorted(kernels)[:8]})")


def _ops_profiled_run(srv, prompts, new) -> tuple:
    """``prompts`` submitted inside one torch.profiler session, opened
    while the engine is idle (a session opened while the engine's worker
    thread decodes can keep none of its kernels: ROADMAP queue 3); after
    the first tokens, a window of OPS_PROFILE_STEPS decode steps marked by
    a span on this thread. Returns the futures, device ms by kernel name
    before the window (the prefills) and inside it, and the window's
    steps and wall ms."""
    import torch
    with _cuda_profile() as prof:
        futs = [srv.submit_generate(p, max_new_tokens=new) for p in prompts]
        _wait_for(lambda: all(len(f.tokens()) >= 2 for f in futs), 300,
                  "the profiled run's first tokens")
        with torch.profiler.record_function(OPS_WINDOW):
            s0 = srv.metrics_snapshot()["decode_steps"]
            t0 = time.perf_counter()
            _wait_for(lambda: srv.metrics_snapshot()["decode_steps"]
                      >= s0 + OPS_PROFILE_STEPS, 300, "profiled steps")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            s1 = srv.metrics_snapshot()["decode_steps"]
    before, inside = _window_kernels(prof, OPS_WINDOW)
    return futs, before, inside, {"steps": s1 - s0, "wall_ms": wall_ms}


def _ops_compare(state, model) -> dict:
    """The decode step with telemetry and head sampling at 1.0 against
    without, in turns off, on, on, off, fresh engines of the same shape;
    then one more "on" run is profiled in one session opened while its
    engine is idle: its prefills (the flash forward must be seen by name)
    and a window of its decode steps (device ms a step, busy share; the
    paged decode and combine kernels must be seen by name), apart from
    the compared runs. One try: a blind profile fails."""
    import numpy as np
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.serving.generation import GenerationServer
    rng = np.random.RandomState(state["seed"] + 29)
    prompts = [rng.randint(0, model.config.vocab_size, OPS_CMP_PROMPT)
               for _ in range(OPS_CMP_STREAMS)]
    pages = 1 + OPS_CMP_STREAMS * -(-(OPS_CMP_PROMPT + OPS_PROFILE_NEW)
                                    // PAGE_SIZE)
    runs, window = {"off": [], "on": []}, None
    for turn in ("off", "on", "on", "off", "profiled"):
        on = turn != "off"
        set_flags({"FLAGS_trace_sample_rate": 1.0 if on else 0.0})
        srv = GenerationServer(
            model, max_batch=MAX_BATCH, page_size=PAGE_SIZE, num_pages=pages,
            prefix_cache=False, device="cuda",
            telemetry_port=0 if on else -1, name=f"ops_cmp_{turn}")
        new = OPS_PROFILE_NEW if turn == "profiled" else OPS_CMP_NEW
        if turn != "profiled":
            futs = [srv.submit_generate(p, max_new_tokens=new)
                    for p in prompts]
        else:
            futs, prefill, kernels, win = _ops_profiled_run(srv, prompts,
                                                            new)
            _require_seen(prefill, OPS_PREFILL_KERNELS, "prefills")
            _require_seen(kernels, OPS_DECODE_KERNELS, "decode window")
            busy = sum(kernels.values())
            require(all(not f.done() for f in futs),
                    "ops: the profiled streams ended inside the window")
            steps, wall_ms = win["steps"], win["wall_ms"]
            window = {"steps": steps, "wall_ms": wall_ms,
                      "device_ms_per_step": busy / max(1, steps),
                      "wall_ms_per_step": wall_ms / max(1, steps),
                      "busy_share": busy / wall_ms if wall_ms else None,
                      "kernels_seen": sorted(
                          k for k in OPS_PREFILL_KERNELS + OPS_DECODE_KERNELS
                          if any(k in n for n in list(prefill)
                                 + list(kernels))),
                      "prefill_device_ms": sum(prefill.values())}
            for f in futs:
                f.cancel()
        for f in futs:
            toks = f.result(timeout=600)
            require(len(toks) == new or (turn == "profiled"
                                         and f.cancelled()),
                    f"ops: a compared stream ({turn}) ended "
                    f"{f.finish_reason} after {len(toks)} tokens")
        snap = srv.metrics_snapshot()
        srv.shutdown()
        if turn != "profiled":
            runs[turn].append(snap["step_ms"]["decode"]["mean"])
        del srv
    set_flags({"FLAGS_trace_sample_rate": 0.0})
    return {"decode_step_ms_mean": runs,
            "on_over_off": (statistics.mean(runs["on"])
                            / statistics.mean(runs["off"])),
            "profiled_window": window}


# The profiler probe (--phases card,build,opsprobe; not in the default
# run): for each configuration of the engine's telemetry (head sampling
# rate, telemetry port; -1 is off), OPS_PROBE_PROCS fresh processes, each
# a gpt3_1p3b bf16 engine decoding 8 streams: one session opened while
# the engine is idle (as _ops_compare opens it), then OPS_PROBE_MID
# sessions opened while its worker thread decodes. Each session is blind
# when it names none of the paged decode and combine kernels.
OPS_PROBE_CONFIGS = {"off": (0.0, -1), "telemetry_only": (0.0, 0),
                     "sampling_only": (1.0, -1), "on": (1.0, 0)}
OPS_PROBE_PROCS = 2
OPS_PROBE_MID = 4


def _ops_probe_child(seed: int, config: str) -> dict:
    """One probe process (``--ops-probe-child CONFIG``): the idle-opened
    session's and each mid-decode session's device ms a step and whether
    it named the paged kernels."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.observability import stop_telemetry_server
    from paddle_tpu_torch.serving.generation import GenerationServer
    rate, port = OPS_PROBE_CONFIGS[config]
    model = _model({"seed": seed})
    rng = np.random.RandomState(seed + 29)
    prompts = [rng.randint(0, model.config.vocab_size, OPS_CMP_PROMPT)
               for _ in range(OPS_CMP_STREAMS)]
    pages = 1 + OPS_CMP_STREAMS * -(-(OPS_CMP_PROMPT + OPS_PROFILE_NEW)
                                    // PAGE_SIZE)
    set_flags({"FLAGS_trace_sample_rate": rate})
    srv = GenerationServer(
        model, max_batch=MAX_BATCH, page_size=PAGE_SIZE, num_pages=pages,
        prefix_cache=False, device="cuda", telemetry_port=port,
        name=f"ops_probe_{config}")

    def row(kernels, steps):
        return {"seen": all(any(k in n for n in kernels)
                            for k in OPS_DECODE_KERNELS),
                "device_ms_per_step": sum(kernels.values()) / max(1, steps)}

    futs, _, inside, win = _ops_profiled_run(srv, prompts, OPS_PROFILE_NEW)
    out = {"config": config, "pid": os.getpid(),
           "idle": row(inside, win["steps"]), "mid": []}
    for _ in range(OPS_PROBE_MID):
        with _cuda_profile() as prof:
            s0 = srv.metrics_snapshot()["decode_steps"]
            _wait_for(lambda: srv.metrics_snapshot()["decode_steps"]
                      >= s0 + OPS_PROFILE_STEPS, 300, "probe steps")
            torch.cuda.synchronize()
            s1 = srv.metrics_snapshot()["decode_steps"]
        out["mid"].append(row(_device_kernels(prof), s1 - s0))
    require(all(not f.done() for f in futs),
            "opsprobe: the streams ended inside the windows")
    for f in futs:
        f.cancel()
    for f in futs:
        f.result(timeout=600)
    srv.shutdown()
    stop_telemetry_server()
    return out


def phase_opsprobe(state):
    """The profiler probe (see OPS_PROBE_CONFIGS): its processes in turns
    over the configurations; logs each process's sessions and, for each
    configuration, the blind sessions of each kind over all."""
    rows = []
    for _ in range(OPS_PROBE_PROCS):
        for config in OPS_PROBE_CONFIGS:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--ops-probe-child", config, "--seed", str(state["seed"])],
                cwd=str(REPO), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("OPSPROBE ")]
            require(proc.returncode == 0 and lines,
                    f"opsprobe: the {config} process exited "
                    f"{proc.returncode}: {proc.stderr[-2000:]}")
            rows.append(json.loads(lines[-1][len("OPSPROBE "):]))
            log("opsprobe: " + json.dumps(rows[-1]))
    summary = {}
    for config in OPS_PROBE_CONFIGS:
        mine = [r for r in rows if r["config"] == config]
        summary[config] = {
            "idle_blind": sum(not r["idle"]["seen"] for r in mine),
            "idle": len(mine),
            "mid_blind": sum(not m["seen"] for r in mine for m in r["mid"]),
            "mid": sum(len(r["mid"]) for r in mine)}
    state["opsprobe"] = {"card": state.get("smi"), "summary": summary,
                         "processes": rows}
    log("opsprobe summary: " + json.dumps(summary))


def _ops_inference(state, engine_port) -> dict:
    """InferenceServer over ERNIE-base saved by jit.save (float32, as the
    inference phase saves it) under two tenants, with the telemetry
    endpoint: typed quota refusals, 12 flash launches a batch, the latency
    histogram with an exemplar whose trace is in /tracez, outputs against
    Predictor.run on each request alone."""
    import json as _json
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import inference, jit, serving
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base)
    from paddle_tpu_torch.serving import QuotaExceededError
    from paddle_tpu_torch.serving.scheduling import (AdmissionController,
                                                     SchedulerPolicy,
                                                     TenantPolicy)
    from paddle_tpu_torch.static import InputSpec
    seed = state["seed"]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ops_"))
    try:
        cfg = ernie_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        model = ErnieForSequenceClassification(cfg, num_classes=2,
                                               device="cuda",
                                               seed=seed).eval()
        jit.save(model, str(work / "ernie_f32"),
                 input_spec=[InputSpec([None, None], "int64", "input_ids")])
        del model
        _release()
        pred = inference.create_predictor(
            inference.Config(str(work / "ernie_f32")))
        policy = SchedulerPolicy(tenants={
            "online": TenantPolicy("online", rate=0.0, weight=2.0,
                                   priority="realtime"),
            "offline": TenantPolicy("offline", rate=1e-3,
                                    burst=OPS_INFER_BURST, priority="batch")})
        ctl = AdmissionController(policy, name="ops_infer")
        srv = serving.InferenceServer(
            pred, max_batch_size=SERVER_MAX_BATCH,
            seq_buckets=SERVER_BUCKETS, pipeline_depth=2,
            queue_capacity=4 * OPS_INFER_REQUESTS, name="ops_infer",
            scheduler=ctl, telemetry_port=0, ready_requires_warmup=True)
        port = srv.telemetry.port
        require(port == engine_port,
                "ops: the server did not share the process's endpoint")
        srv.warmup()
        rng = np.random.RandomState(seed + 31)
        reqs = {t: [rng.randint(1, cfg.vocab_size, (1, n)).astype(np.int64)
                    for n in rng.randint(SERVER_MIN_LEN,
                                         SERVER_BUCKETS[-1] + 1,
                                         OPS_INFER_REQUESTS)]
                for t in ("online", "offline")}
        _reset_counts()
        futs, refused = [], []
        for i in range(OPS_INFER_REQUESTS):
            for tenant in ("online", "offline"):
                try:
                    futs.append((tenant, i, srv.submit([reqs[tenant][i]],
                                                       tenant=tenant)))
                except QuotaExceededError as e:
                    refused.append(e.tenant)
        outs = [(t, i, f.result(timeout=300)[0]) for t, i, f in futs]
        counts = _read_counts()
        snap = srv.metrics.snapshot()
        c = snap["counters"]
        require(refused == ["offline"] * (OPS_INFER_REQUESTS
                                          - OPS_INFER_BURST),
                f"ops: refusals {refused}")
        require(c["completed"] == len(futs) and c["failed"] == 0,
                f"ops: server counters {c}")
        _require_launches("ops_infer", counts,
                          {"flash_fwd": cfg.num_layers}, c["batches"])
        scraped = _scrape(port, "inference leg")
        samples = _parse_prometheus(scraped["/metrics"])
        lat = [k for k in samples if k[0] == "paddle_serving_latency_ms_count"
               and 'server="ops_infer"' in k[1]]
        require(lat and samples[lat[0]] == len(futs),
                f"ops: /metrics latency count {lat and samples[lat[0]]}")
        ex = _json.loads(scraped["/tracez"])["exemplars"].get(
            "paddle_serving_latency_ms", {})
        require(ex, "ops: no exemplar on paddle_serving_latency_ms")
        for le, e in ex.items():
            code, body = _http_get(port, f"/tracez?trace_id={e['trace_id']}")
            require(code == 200 and len(_json.loads(body)["traces"]) == 1,
                    f"ops: exemplar {le} trace {e['trace_id']} is not in "
                    f"/tracez")
        srv.shutdown()
        # each request alone through Predictor.run, padded to its bucket
        worst = 0.0
        for tenant, i, out in outs:
            padded = srv.policy.pad_request_seq([reqs[tenant][i]])[0]
            alone = pred.run([padded])[0]
            worst = max(worst, _dist(out, alone))
        require(worst <= F32_MODEL_LIMIT, f"ops: server outputs {worst:.2e} "
                f"from Predictor.run alone, beyond {F32_MODEL_LIMIT}")
        rec = {"requests": len(futs), "refused": len(refused),
               "batches": c["batches"],
               "launches": counts["launches"]["flash_fwd"],
               "plain_calls": counts["plain_calls"]["flash_fwd"],
               "latency_ms": snap["latency_ms"],
               "vs_predictor_alone": worst,
               "exemplars": len(ex),
               "sched_events": ctl.snapshot()["events"]}
        del pred, srv
        _release()
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rec


def phase_ops(state):
    """The serving operations plane on the card: gpt3_1p3b under a
    two-tenant scheduler with priority preemption, the telemetry endpoint
    read over HTTP, traces, step profiles; the decode step with telemetry
    and sampling against without; then InferenceServer under two tenants.
    Head sampling at 1.0 for the phase (the flag restored after)."""
    from paddle_tpu_torch.framework.flags import flag_value, set_flags
    from paddle_tpu_torch.observability import (SpanBuffer, StepProfiler,
                                                stop_telemetry_server,
                                                tracing)
    from paddle_tpu_torch.observability import stepprof
    model = _model(state)
    rate = flag_value("FLAGS_trace_sample_rate")
    prev_buf = tracing.set_default_buffer(
        SpanBuffer(max_spans=1 << 16, max_per_trace=1024))
    prev_prof = stepprof.set_default_profiler(StepProfiler(window=1 << 16))
    tracing.clear_exemplars()
    try:
        set_flags({"FLAGS_trace_sample_rate": 1.0})
        t0 = time.perf_counter()
        engine = _ops_engine(state, model)
        engine_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        compare = _ops_compare(state, model)
        compare_s = time.perf_counter() - t0
        set_flags({"FLAGS_trace_sample_rate": 1.0})
        tracing.set_default_buffer(SpanBuffer(max_spans=1 << 16))
        t0 = time.perf_counter()
        infer = _ops_inference(state, engine["telemetry_port"])
        infer_s = time.perf_counter() - t0
    finally:
        set_flags({"FLAGS_trace_sample_rate": rate})
        tracing.set_default_buffer(prev_buf)
        stepprof.set_default_profiler(prev_prof)
        stop_telemetry_server()
    out = {"card": state.get("smi"), "engine": engine, "compare": compare,
           "inference_server": infer,
           "seconds": {"engine": engine_s, "compare": compare_s,
                       "inference_server": infer_s}}
    state["ops"] = out
    log("ops: " + json.dumps(out))


FLEET_CLIENTS = 4
FLEET_STREAMS, FLEET_STREAM_NEW = 16, 64
FLEET_PROMPT_LENS = (64, 1024)
FLEET_PREAMBLE = 128       # tokens the longer even streams share (8 pages)
FLEET_SUBMITS = 128        # leg A's /submit_many requests, 16-512 tokens
FLEET_GEN_BATCH = 8        # each replica engine's decode lanes
# the generation model's depth: gpt3_1p3b's width at 12 of its 24 layers
# (its streams are held against the same model alone; the depth only sets
# how long the leg takes, and the smoke must stay inside its time limit)
FLEET_GEN_LAYERS = 12
FLEET_BURST = 256          # leg B's burst through the router
FLEET_POOL = 64            # distinct requests leg B draws from
FLEET_WINDOW = 8           # leg B's requests in flight a client
FLEET_SPAWN_S = 300.0      # bound on a worker's spawn to ready
# the router's merged views of the runtime and numerics plane (501 before
# the plane was ported) and each body's top-level keys
FLEET_PLANE = {"/execz": {"router", "replicas", "fleet"},
               "/numericsz": {"router", "replicas", "fleet"},
               "/profilez": {"replicas", "captured", "replicas_merged"}}
FLEET_WEDGE_MS = 500
FLEET_HANG = 777.0         # the stub's hang poison

# Written onto the leg B workers' PYTHONPATH: at a clean exit, each worker
# process dumps the port's kernel counters (no program feature needed).
_FLEET_SITECUSTOMIZE = r'''
import atexit, json, os, sys


def _dump():
    ca = sys.modules.get("paddle_tpu_torch.ops.cuda_attention")
    cpa = sys.modules.get("paddle_tpu_torch.ops.cuda_paged_attention")
    rec = {"pid": os.getpid(),
           "flash_fwd": getattr(ca, "launches", 0),
           "flash_fwd_plain": getattr(ca, "plain_calls", 0),
           "paged_attention": getattr(cpa, "launches", 0),
           "paged_attention_plain": getattr(cpa, "plain_calls", 0)}
    out = os.path.join(os.environ["CHIP_SMOKE_FLEET_COUNTS"],
                       "counts-%d.json" % os.getpid())
    with open(out, "w") as f:
        json.dump(rec, f)


if os.environ.get("CHIP_SMOKE_FLEET_COUNTS"):
    atexit.register(_dump)
'''


def _opener():
    import urllib.request
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _fleet_stream(url, prompt, new, traceparent=None):
    """One greedy /generate stream over HTTP: tokens, the terminal event
    and the time to the first token (ms)."""
    import urllib.request
    body = {"prompt": prompt, "max_new_tokens": new, "temperature": 0.0}
    if traceparent:
        body["traceparent"] = traceparent
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    req.add_header("Content-Type", "application/json")
    toks, done, ttft = [], None, None
    t0 = time.perf_counter()
    with _opener().open(req, timeout=600) as resp:
        for line in resp:
            ev = json.loads(line)
            if ev.get("done"):
                done = ev
                break
            if ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            toks.append(int(ev["t"]))
    return toks, done, ttft


def _fleet_submit(url, arr, codec):
    """One request through POST /submit_many: its outputs and ms."""
    import urllib.request
    req = urllib.request.Request(url + "/submit_many",
                                 data=codec.encode_batch([[arr]]),
                                 method="POST")
    req.add_header("Content-Type", "application/x-paddle-fleet")
    t0 = time.perf_counter()
    with _opener().open(req, timeout=600) as resp:
        (res,) = codec.decode_results(resp.read())
    require(not isinstance(res, BaseException),
            f"fleet: a /submit_many request failed: {res!r}")
    return res, (time.perf_counter() - t0) * 1e3


def _fleet_percentiles(ms) -> dict:
    import numpy as np
    ms = np.asarray(ms, np.float64)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()), "n": int(ms.size)}


def _fleet_dispatches(text: str) -> int:
    """Every dispatch a worker process ran, from its own /metrics: the
    compile-cache lookups (hit or miss) of all its servers, warmup
    included, one a batch."""
    samples = _parse_prometheus(text)
    return int(sum(v for (name, _), v in samples.items()
                   if name == "paddle_serving_compile_total"))


def _fleet_margin(model, prompt, agreed) -> float:
    """Top-2 logit margin over std(logits) at the step after ``agreed``
    tokens of ``prompt``'s stream, from the plain forward (no cache)."""
    import torch
    ids = torch.tensor([list(prompt) + list(agreed)], device=model.device)
    with torch.no_grad():
        logits = model(ids)[0, -1].float()
    top = torch.topk(logits, 2).values
    return float((top[0] - top[1]) / logits.std())


def _fleet_thread_leg(state, work, ernie_prefix, ernie_vocab) -> dict:
    """Leg A: two thread replicas (``ThreadReplicaFactory``), each a
    PredictorBackend over float32 ERNIE-base with the float32 gpt3_1p3b at
    FLEET_GEN_LAYERS layers as its generation model (one model object, an
    engine and pools each),
    behind ``RouterApp``; 16 greedy streams and 128 /submit_many requests
    over HTTP from 4 clients."""
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving import ShapeBucketPolicy, fleet
    from paddle_tpu_torch.serving.fleet import codec
    from paddle_tpu_torch.serving.generation import GenerationServer
    seed = state["seed"]
    t0 = time.perf_counter()
    gpt = GPTForCausalLM(gpt3_1p3b(num_layers=FLEET_GEN_LAYERS),
                         device="cuda", dtype=torch.float32,
                         seed=seed).eval()
    layers, vocab = gpt.config.num_layers, gpt.config.vocab_size
    # each engine's pool priced explicitly: the second engine must not
    # size itself from the memory the first one left
    pages = 1 + FLEET_GEN_BATCH * -(-gpt.config.max_seq_len // 16)
    gen_kw = {"num_pages": pages, "max_batch": FLEET_GEN_BATCH,
              "page_size": 16}
    backends = {}

    def factory(rid):
        be = fleet.PredictorBackend(
            ernie_prefix, max_batch_size=SERVER_MAX_BATCH,
            seq_buckets=SERVER_BUCKETS, warmup_mode="lattice",
            name=f"fleet-a{rid}", generation_model=gpt,
            generation_kwargs=gen_kw)
        backends[rid] = be
        return be

    sup = fleet.ReplicaSupervisor(fleet.ThreadReplicaFactory(factory), 2,
                                  name="fleet_a")
    t_spawn = time.perf_counter()
    sup.start()
    router = fleet.FleetRouter(supervisor=sup, name="fleet_a",
                               health_interval_ms=100)
    app = fleet.RouterApp(router, host="127.0.0.1").start()
    url = app.url()
    try:
        require(router.wait_ready(2, timeout=FLEET_SPAWN_S),
                f"fleet A: replicas not ready: {router.replica_states()}")
        ready_s = time.perf_counter() - t_spawn
        rng = np.random.RandomState(seed + 41)
        preamble = rng.randint(1, vocab, FLEET_PREAMBLE)
        prompts = []
        for i, n in enumerate(rng.randint(FLEET_PROMPT_LENS[0],
                                          FLEET_PROMPT_LENS[1] + 1,
                                          FLEET_STREAMS)):
            p = rng.randint(1, vocab, int(n))
            if i % 2 == 0 and n > FLEET_PREAMBLE:
                p[:FLEET_PREAMBLE] = preamble
            prompts.append(p.tolist())
        reqs = [rng.randint(1, ernie_vocab, (1, int(n))).astype(np.int64)
                for n in rng.randint(SERVER_MIN_LEN, SERVER_BUCKETS[-1] + 1,
                                     FLEET_SUBMITS)]
        traced = tracing.new_context(sampled=True)
        calls0 = {r: dict(b.generation_server.decoder.calls)
                  for r, b in backends.items()}
        batches0 = {r: b.server.metrics.snapshot()["counters"]["batches"]
                    for r, b in backends.items()}
        streams = [None] * FLEET_STREAMS
        outs, lat = [None] * FLEET_SUBMITS, [None] * FLEET_SUBMITS
        errors = []

        def stream(i):
            try:
                streams[i] = _fleet_stream(
                    url, prompts[i], FLEET_STREAM_NEW,
                    traced.to_traceparent() if i == 0 else None)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def client(c):
            subs = [threading.Thread(target=stream, args=(i,))
                    for i in range(c, FLEET_STREAMS, FLEET_CLIENTS)]
            for t in subs:
                t.start()
            try:
                for i in range(c, FLEET_SUBMITS, FLEET_CLIENTS):
                    outs[i], lat[i] = _fleet_submit(url, reqs[i], codec)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
            for t in subs:
                t.join()

        _reset_counts()
        _reset_paged_counts()
        t_traffic = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        wall = time.perf_counter() - t_traffic
        counts = _read_counts()
        by_kernel = dict(cpa.launches_by_kernel)
        paged = (cpa.launches, cpa.plain_calls)
        require(not errors, f"fleet A: a client failed: {errors[:1]!r}")
        calls = {k: sum(b.generation_server.decoder.calls[k] - calls0[r][k]
                        for r, b in backends.items())
                 for k in ("prefill", "chunked", "decode", "verify")}
        batches = sum(b.server.metrics.snapshot()["counters"]["batches"]
                      - batches0[r] for r, b in backends.items())
        snaps = {r: b.generation_server.metrics_snapshot()
                 for r, b in backends.items()}
        served = {r: sn["counters"]["completed"] for r, sn in snaps.items()}
        decode_ms = {r: sn["step_ms"]["decode"] for r, sn in snaps.items()}
        want_flash = layers * calls["prefill"] + 12 * batches
        require(counts["launches"]["flash_fwd"] == want_flash
                and counts["plain_calls"]["flash_fwd"] == 0,
                f"fleet A: flash launches {counts['launches']['flash_fwd']} "
                f"(plain {counts['plain_calls']['flash_fwd']}), want "
                f"{layers} x {calls['prefill']} prefills + 12 x {batches} "
                f"batches")
        want_paged = {"paged_decode_split_f32": layers * calls["decode"],
                      "paged_window_f32": layers * calls["chunked"]}
        require({k: v for k, v in by_kernel.items() if v} ==
                {k: v for k, v in want_paged.items() if v}
                and paged[1] == 0 and calls["verify"] == 0,
                f"fleet A: paged launches {by_kernel} (plain {paged[1]}), "
                f"want {want_paged} from the decoders' calls {calls}")
        require(all(n > 0 for n in served.values()) and
                sum(served.values()) == FLEET_STREAMS,
                f"fleet A: streams served per replica {served}")
        # the HTTP surface while the fleet is up
        code, body = _http_get(app.port, "/metrics?merged=1")
        require(code == 200 and all(
            f'paddle_decode_requests_total{{replica="{r}",' in body
            for r in ("0", "1")),
            "fleet A: /metrics?merged=1 lacks an engine family under "
            "replica 0 or 1")
        merged_samples = len(_parse_prometheus(body))
        code, body = _http_get(app.port, f"/tracez?trace_id="
                                         f"{traced.trace_id}")
        doc = json.loads(body)
        stages = {s["stage"] for t in doc["traces"] for s in t["spans"]}
        require(code == 200 and len(doc["traces"]) == 1 and
                {"router", "queue", "prefill", "decode_step"} <= stages,
                f"fleet A: the traced stream's /tracez has "
                f"{len(doc['traces'])} traces, stages {sorted(stages)}")
        code, body = _http_get(app.port, "/statusz")
        st = json.loads(body)
        require(code == 200 and st["ready_replicas"] == 2,
                f"fleet A: /statusz {code} {body[:300]}")
        for path, keys in FLEET_PLANE.items():
            code, body = _http_get(app.port, path)
            require(code == 200 and set(json.loads(body)) == keys,
                    f"fleet A: {path} answered {code}, not 200 with keys "
                    f"{sorted(keys)}: {body[:200]}")
    finally:
        app.stop()
        router.shutdown()
        sup.stop()
    leaks = {r: b.generation_server.leak_check() for r, b in backends.items()}
    require(all(v["ok"] for v in leaks.values()),
            f"fleet A: leak checks after shutdown {leaks}")
    del backends, sup, router, app, factory
    _release()
    # each stream against the same model's GenerationServer on that prompt
    # alone; where one parts from it, the top-2 margin there must be within
    # the model phase's float32 limit
    ref = GenerationServer(gpt, name="fleet_a_ref", **gen_kw)
    parted = []
    try:
        for i, p in enumerate(prompts):
            toks, done, _ = streams[i]
            require(done["finish_reason"] == "length"
                    and len(toks) == FLEET_STREAM_NEW,
                    f"fleet A: stream {i} ended {done} after {len(toks)}")
            want = ref.generate(p, max_new_tokens=FLEET_STREAM_NEW)
            if toks != want:
                k = next(j for j, (a, b) in enumerate(zip(toks, want))
                         if a != b)
                margin = _fleet_margin(gpt, p, want[:k])
                parted.append({"stream": i, "step": k, "margin": margin})
                require(margin <= F32_MODEL_LIMIT,
                        f"fleet A: stream {i} parts from the single engine "
                        f"at step {k} with a top-2 margin of {margin:.2e} x "
                        f"std, beyond {F32_MODEL_LIMIT}")
        require(ref.leak_check()["ok"], "fleet A: the reference engine leaks")
    finally:
        ref.shutdown()
    del ref, gpt
    _release()
    # each /submit_many response against Predictor.run on it alone
    pred = inference.create_predictor(inference.Config(ernie_prefix))
    pol = ShapeBucketPolicy(seq_buckets=SERVER_BUCKETS)
    alone = [pred.run(pol.pad_request_seq([r]))[0] for r in reqs]
    scale = _fleet_scale(alone)
    worst = max(_fleet_gap(o[0], a, scale) for o, a in zip(outs, alone))
    require(worst <= F32_MODEL_LIMIT, f"fleet A: predictor outputs "
            f"{worst:.2e} x std from Predictor.run alone, beyond "
            f"{F32_MODEL_LIMIT}")
    worst_own = max(_dist(o[0], a) for o, a in zip(outs, alone))
    del pred
    _release()
    ttft = [s[2] for s in streams]
    return {"replicas_ready_s": ready_s, "wall_s": wall,
            "decoder_calls": calls, "predictor_batches": batches,
            "streams_per_replica": served, "decode_step_ms": decode_ms,
            "launches": {"flash_fwd": counts["launches"]["flash_fwd"]},
            "paged_launches_by_kernel": by_kernel,
            "plain_calls": {"flash_fwd": counts["plain_calls"]["flash_fwd"],
                            "paged_attention": paged[1]},
            "streams_parted": parted,
            "stream_ttft": _fleet_percentiles(ttft),
            "submit_latency": _fleet_percentiles(lat),
            "vs_predictor_alone": worst,
            "vs_predictor_alone_own_std": worst_own,
            "merged_samples": merged_samples,
            "trace_stages": sorted(stages),
            "seconds": time.perf_counter() - t0}


class _FleetLoad:
    """Client threads sending requests (indices into ``reqs``) through
    ``submit`` (a router's or a server's); each completion is recorded as
    (index, submit time, done time, outputs or the exception). ``burst``
    sends n at once from every client and waits; ``start``/``stop`` keep
    ``window`` requests in flight a client until stopped."""

    def __init__(self, submit, n_reqs, clients=FLEET_CLIENTS):
        import threading
        self.submit, self.n_reqs, self.clients = submit, n_reqs, clients
        self.records = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._next = 0

    def _send(self, sem=None):
        with self._lock:
            i = self._next % self.n_reqs
            self._next += 1
        t0 = time.perf_counter()
        fut = self.submit(i)

        def done(f):
            exc = f.exception()
            rec = (i, t0, time.perf_counter(),
                   exc if exc is not None else f.result())
            with self._lock:
                self.records.append(rec)
            if sem is not None:
                sem.release()
        fut.add_done_callback(done)
        return fut

    def burst(self, n):
        import concurrent.futures
        import threading
        futs = []

        def client(k):
            for _ in range(k):
                futs.append(self._send())

        threads = [threading.Thread(target=client, args=(n // self.clients,))
                   for _ in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        concurrent.futures.wait(futs, timeout=600)

    def start(self, window=FLEET_WINDOW):
        import threading
        self._stop.clear()

        def client():
            sem = threading.Semaphore(window)
            while not self._stop.is_set():
                if sem.acquire(timeout=0.1):
                    self._send(sem)
            for _ in range(window):      # wait for this client's tail
                sem.acquire(timeout=600)

        self._threads = [threading.Thread(target=client)
                         for _ in range(self.clients)]
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join()


def _fleet_scale(outs) -> float:
    """The std of a model's outputs over a request pool: the scale the
    fleet's responses are held at. A 2-logit classifier's own output can
    have an arbitrarily small std, so one request's is no scale."""
    import numpy as np
    return float(np.std(np.stack([np.asarray(o, np.float32)
                                  for o in outs])))


def _fleet_gap(res, want, scale) -> float:
    import numpy as np
    return float(np.abs(np.asarray(res, np.float32)
                        - np.asarray(want, np.float32)).max()) / scale


def _fleet_versions_check(records, outs, when) -> tuple:
    """Each ok record against the version(s) ``when(t_submit, t_done)``
    allows, at 1e-4 x the std of that version's outputs over the pool:
    the worst distance, and the failures."""
    worst, failed = 0.0, []
    scales = {v: _fleet_scale(o) for v, o in outs.items()}
    for i, t0, t1, res in records:
        if isinstance(res, BaseException):
            failed.append((t0, t1, res))
            continue
        allowed = when(t0, t1)
        d = min(_fleet_gap(res[0], outs[v][i], scales[v]) for v in allowed)
        require(d <= F32_MODEL_LIMIT, f"fleet B: a response ({allowed}) is "
                f"{d:.2e} x std from its version's Predictor.run")
        worst = max(worst, d)
    return worst, failed


def _fleet_process_leg(state, work, prefixes, ernie_vocab) -> dict:
    """Leg B: worker processes (``ProcessReplicaFactory``) under a
    supervisor, the autoscaler, a rolling swap, a SIGKILL and the wedge
    drill."""
    import os
    import signal
    import threading
    import numpy as np
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.serving import ShapeBucketPolicy, fleet
    from paddle_tpu_torch.serving.scheduling import (FleetAutoscaler,
                                                     register_autoscaler)
    seed = state["seed"]
    t0 = time.perf_counter()
    counts_dir, site_dir = work / "counts", work / "site"
    for d in (counts_dir, site_dir, work / "announce",
              work / "announce_wedge"):
        d.mkdir()
    (site_dir / "sitecustomize.py").write_text(_FLEET_SITECUSTOMIZE)
    env = {"PYTHONPATH": os.pathsep.join(
               [str(site_dir), str(REPO)] +
               [p for p in [os.environ.get("PYTHONPATH")] if p]),
           "CHIP_SMOKE_FLEET_COUNTS": str(counts_dir)}
    logf = open(work / "workers.log", "w")
    rng = np.random.RandomState(seed + 53)
    reqs = [rng.randint(1, ernie_vocab, (1, int(n))).astype(np.int64)
            for n in rng.randint(SERVER_MIN_LEN, SERVER_BUCKETS[-1] + 1,
                                 FLEET_POOL)]
    pol = ShapeBucketPolicy(seq_buckets=SERVER_BUCKETS)
    outs, preds = {}, {}
    for v in ("v1", "v2"):
        preds[v] = inference.create_predictor(
            inference.Config(prefixes[v]))
        outs[v] = [preds[v].run(pol.pad_request_seq([r]))[0] for r in reqs]
    # the same burst through one in-process InferenceServer over v1
    srv = serving.InferenceServer(
        preds["v1"], max_batch_size=SERVER_MAX_BATCH,
        seq_buckets=SERVER_BUCKETS, queue_capacity=4 * FLEET_BURST,
        name="fleet_b_local", ready_requires_warmup=True)
    srv.warmup()
    local = _FleetLoad(lambda i: srv.submit([reqs[i]]), FLEET_POOL)
    t_local = time.perf_counter()
    local.burst(FLEET_BURST)
    local_s = time.perf_counter() - t_local
    srv.shutdown()
    worst_local, failed_local = _fleet_versions_check(
        local.records, outs, lambda a, b: ("v1",))
    require(not failed_local and len(local.records) == FLEET_BURST,
            f"fleet B: the local server failed {failed_local[:1]}")
    del srv, preds
    _release()
    # the workers share one compile cache (the supervisor hands them the
    # live FLAGS_compile_cache_dir) and one name (after the supervisor's
    # --name, so it wins), so one manifest a program: the first warms the
    # whole lattice cold and its traffic writes the fleet's manifest;
    # every later spawn replays that manifest (--warmup manifest)
    from paddle_tpu_torch import compile_cache
    _rt_flags(compile_cache_dir=str(work / "cc"))
    compile_cache.reset_default_cache()
    args = ["--name", "fleet_b",
            "--model-prefix", prefixes["v1"], "--warmup", "lattice",
            "--max-batch-size", str(SERVER_MAX_BATCH), "--seq-buckets",
            ",".join(str(b) for b in SERVER_BUCKETS)]
    fac = fleet.ProcessReplicaFactory(extra_args=args, env=env,
                                      announce_dir=str(work / "announce"),
                                      stdout=logf, stderr=logf,
                                      forkserver=state.get("forkserver"))
    sup = fleet.ReplicaSupervisor(fac, 1, name="fleet_b")
    router = fleet.FleetRouter(supervisor=sup, name="fleet_b",
                               health_interval_ms=100)
    asc = FleetAutoscaler(
        sup, queue_depth_fn=lambda: sum(s["outstanding"]
                                        for s in router.replica_states()),
        min_replicas=1, max_replicas=2, cooldown_s=2.0,
        scale_in_quiet_s=4.0, queue_high=8.0, interval_s=0.1,
        name="fleet_b")
    register_autoscaler(asc)
    load = _FleetLoad(lambda i: router.submit([reqs[i]]), FLEET_POOL)
    rec = {}

    def log_tail():
        logf.flush()
        return (work / "workers.log").read_text()[-4000:]

    try:
        t_spawn = time.perf_counter()
        sup.start()
        # announced once its predictor is loaded and its app listens;
        # ready once the lattice warmup ran
        _wait_for(lambda: bool(sup.endpoints()), FLEET_SPAWN_S,
                  "the first worker's announce", tag="fleet B")
        rec["spawn_to_announce_s"] = time.perf_counter() - t_spawn
        require(router.wait_ready(1, timeout=FLEET_SPAWN_S),
                f"fleet B: the first worker is not ready:\n{log_tail()}")
        rec["spawn_to_ready_s"] = time.perf_counter() - t_spawn
        first_pid = sup._managed[0].proc.pid
        starts = {"first": _fleet_startup(sup, 0, "the first worker")}
        cold = starts["first"]["compile_cache"]
        require(cold["misses"] > 0 and cold["hits"] == 0,
                f"fleet B: the first worker's warmup ran {cold} (cold: "
                f"misses only)")
        fac.extra_args[fac.extra_args.index("--warmup") + 1] = "manifest"
        code, body = _http_get(int(sup.endpoints()[0].rsplit(":", 1)[1]),
                               "/statusz")
        info = json.loads(body)
        require(code == 200 and info["package"] ==
                "paddle_tpu_torch.serving.fleet" and
                info["version"].startswith("model_v1@"),
                f"fleet B: the worker's /statusz {body[:300]}")
        asc.start()
        # 1. the burst scales the fleet out; the second worker warms
        t_burst = time.perf_counter()
        load.burst(FLEET_BURST)
        burst_s = time.perf_counter() - t_burst
        burst = list(load.records)
        # a decision is logged once scale_to returned: wait for the log
        _wait_for(lambda: asc.snapshot()["decisions"], 30,
                  "the burst's scale-out decision", tag="fleet B")
        out_d = [d for d in asc.snapshot()["decisions"]
                 if d["direction"] == "out"]
        require(len(out_d) == 1 and out_d[0]["to"] == 2,
                f"fleet B: the burst's decisions {asc.snapshot()}")
        load.start()
        t_out = time.perf_counter()
        require(router.wait_ready(2, timeout=FLEET_SPAWN_S),
                f"fleet B: the second worker is not ready:\n{log_tail()}")
        rec["scale_out_to_ready_s"] = time.perf_counter() - t_out
        starts["scale_out"] = _fleet_warm_startup(sup, 1, "scale-out")
        port_1 = int(sup.endpoints()[1].rsplit(":", 1)[1])

        def completed_on_second():
            code, body = _http_get(port_1, "/metrics")
            require(code == 200, f"fleet B: worker 1 /metrics {code}")
            return sum(v for (n, lab), v in _parse_prometheus(body).items()
                       if n == "paddle_serving_requests_total"
                       and 'event="completed"' in lab)

        t_took = time.perf_counter()
        while completed_on_second() == 0:
            require(time.perf_counter() - t_took < 60,
                    "fleet B: the second worker took no traffic in 60 s")
            time.sleep(0.1)
        rec["second_worker_first_completion_s"] = \
            time.perf_counter() - t_took
        # 2. the rolling swap under traffic (both replicas polled ready:
        # the swap skips a replica the router does not see alive)
        require(router.wait_ready(2, timeout=60),
                f"fleet B: not 2 ready before the swap "
                f"{router.replica_states()}")
        t_swap0 = time.perf_counter()
        report = router.swap_weights(prefixes["v2"])
        t_swap1 = time.perf_counter()
        fac.extra_args[fac.extra_args.index("--model-prefix") + 1] = \
            prefixes["v2"]
        require([r["version"].split("@")[0] for r in report["replicas"]]
                == ["model_v2", "model_v2"],
                f"fleet B: swap report {report}")
        router.poll_replicas()
        require(all(s["version"].startswith("model_v2@")
                    for s in router.replica_states()),
                f"fleet B: versions after the swap "
                f"{router.replica_states()}")
        n_swapped = len(load.records)
        _wait_for(lambda: len(load.records) > n_swapped + 64, 60,
                  "traffic after the swap", tag="fleet B")
        # 3. SIGKILL the second worker in the middle of a batch
        victim = sup._managed[1].proc.pid
        _wait_for(lambda: any(s["replica"] == "1" and s["outstanding"] > 0
                              for s in router.replica_states()), 60,
                  "a batch in flight on replica 1", tag="fleet B")
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        _wait_for(lambda: sup.restart_counts().get(1, 0) == 1, 60,
                  "the respawn", tag="fleet B")
        require(router.wait_ready(2, timeout=FLEET_SPAWN_S),
                f"fleet B: the respawned worker is not ready:\n{log_tail()}")
        rec["kill_to_ready_s"] = time.perf_counter() - t_kill
        starts["relaunch"] = _fleet_warm_startup(sup, 1, "relaunch")
        n_ready = len(load.records)
        _wait_for(lambda: len(load.records) > n_ready + 64, 60,
                  "traffic after the respawn", tag="fleet B")
        load.stop()
        t_quiet = time.perf_counter()
        # every live worker's dispatches from its own /metrics (no more
        # traffic reaches them after this)
        dispatches, caches = {}, {}
        for rid, m in sorted(sup._managed.items()):
            code, body = _http_get(int(m.proc.url().rsplit(":", 1)[1]),
                                   "/metrics")
            require(code == 200, f"fleet B: worker {rid} /metrics {code}")
            dispatches[m.proc.pid] = _fleet_dispatches(body)
            caches[rid] = _fleet_cache_counts(body)
        # the swap's replacement servers replayed the manifest: the first
        # worker measured nothing after its lattice, the relaunch nothing
        require(caches[0]["misses"] == cold["misses"]
                and caches[1]["misses"] == 0,
                f"fleet B: compile-cache counts at the end {caches} (the "
                f"first worker's lattice: {cold['misses']} misses)")
        worst, failed = _fleet_versions_check(
            load.records, outs,
            lambda a, b: ("v1",) if b < t_swap0 else
            ("v2",) if a > t_swap1 else ("v1", "v2"))
        # a failure that ended before the kill is the swap's (or steady
        # state's); after it, only the typed failures of the killed
        # worker's in-flight requests are allowed
        in_swap = [f for f in failed if t_swap0 < f[1] < t_kill]
        bad = [f for f in failed if f[1] < t_kill or not isinstance(
            f[2], (fleet.ReplicaError, serving.ServerClosedError))]
        require(not in_swap and not bad,
                f"fleet B: failed in the swap {in_swap[:2]}, untyped or "
                f"outside the kill {bad[:2]} (swap {t_swap0:.3f}-"
                f"{t_swap1:.3f}, kill {t_kill:.3f})")
        # 4. quiet scales the fleet in
        _wait_for(lambda: asc.snapshot()["decisions"][-1]["direction"]
                  == "in", 60, "the quiet scale-in", tag="fleet B")
        rec["quiet_to_scale_in_s"] = time.perf_counter() - t_quiet
        require(sup.replica_ids == [0],
                f"fleet B: replicas after the scale-in {sup.replica_ids}")
        snap = asc.snapshot()
        last = snap["decisions"][-1]
        require(last["direction"] == "in" and last["to"] == 1 and
                last["reason"] == "slow_burn_quiet",
                f"fleet B: decision log {snap['decisions']}")
        schedz = router.merged_schedz()["autoscalers"].get("fleet_b")
        require(schedz is not None and schedz["decisions"][-1] == last,
                f"fleet B: /schedz autoscalers {schedz}")
        rec.update(
            first_pid=first_pid, killed_pid=victim,
            burst={"requests": len(burst), "wall_s": burst_s,
                   "qps": len(burst) / burst_s,
                   **_fleet_percentiles([(b - a) * 1e3
                                         for _, a, b, _ in burst])},
            local_server={"requests": FLEET_BURST, "wall_s": local_s,
                          "qps": FLEET_BURST / local_s,
                          **_fleet_percentiles([(b - a) * 1e3 for _, a, b, _
                                                in local.records])},
            swap_s=t_swap1 - t_swap0, swap_report=report,
            responses=len(load.records), failed=len(failed),
            failed_types=sorted({type(f[2]).__name__ for f in failed}),
            vs_predictor_alone=max(worst, worst_local),
            dispatches_by_pid=dispatches, decisions=snap["decisions"],
            startup=starts, compile_cache_end=caches)
        for tag, st in starts.items():
            log(f"fleet B: {tag} worker start-up split (s): "
                + json.dumps(st))
    finally:
        load.stop()
        asc.stop()
        router.shutdown()
        sup.stop()
        _rt_flags(compile_cache_dir="")
        compile_cache.reset_default_cache()
    # the workers that exited cleanly dumped their counters
    dumps = [json.loads(p.read_text()) for p in counts_dir.glob("*.json")]
    by_pid = {d["pid"]: d for d in dumps}
    require(victim not in by_pid and set(by_pid) == set(dispatches),
            f"fleet B: dumps from {sorted(by_pid)}, live workers "
            f"{sorted(dispatches)}, killed {victim}")
    for pid, d in by_pid.items():
        require(d["flash_fwd"] == 12 * dispatches[pid] and
                d["flash_fwd_plain"] == 0 and d["paged_attention"] == 0,
                f"fleet B: worker {pid} launched {d} for "
                f"{dispatches[pid]} batches (12 a batch, no plain call)")
    rec["worker_launches"] = {str(p): d["flash_fwd"]
                              for p, d in by_pid.items()}
    rec["wedge"] = _fleet_wedge(work, env, logf, state.get("forkserver"))
    logf.close()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _fleet_startup(sup, rid, what) -> dict:
    """A ready worker's start-up split and warmup report (its /readyz
    ``startup``: seconds from the process's start to main, the CUDA
    context, the kernel library, the model, the warmup; the compile
    cache's counts and the manifest's signatures when the warmup ended)."""
    port = int(sup._managed[rid].proc.url().rsplit(":", 1)[1])
    code, body = _http_get(port, "/readyz")
    doc = json.loads(body)
    require(code == 200 and doc.get("startup"),
            f"fleet B: {what}'s /readyz {code}: {body[:300]}")
    return doc["startup"]


def _fleet_warm_startup(sup, rid, what) -> dict:
    """A worker started with --warmup manifest: ready only after its
    replay, which hit the cache once a manifest signature and never
    missed."""
    st = _fleet_startup(sup, rid, what)
    cc, n = st["compile_cache"], st["manifest_signatures"]
    require(n and cc == {"hits": n, "misses": 0},
            f"fleet B: the {what} worker's replay: {cc} over {n} manifest "
            f"signatures")
    return st


def _fleet_cache_counts(text: str) -> dict:
    samples = _parse_prometheus(text)
    return {k: int(sum(v for (name, _), v in samples.items()
                       if name == f"paddle_compile_cache_{k}_total"))
            for k in ("hits", "misses")}


def _fleet_wedge(work, env, logf, forkserver=None) -> dict:
    """The wedge drill on a ``--stub`` worker process: the hang poison's
    dispatch wedges the stub's device, the watchdog (500 ms) flips
    /readyz, the request queued behind it gets the typed 503 "wedged",
    the worker exits and the supervisor respawns it."""
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import codec
    fac = fleet.ProcessReplicaFactory(
        extra_args=["--stub", "--stub-device-ms", "1", "--stub-hang-value",
                    str(FLEET_HANG), "--wedge-timeout-ms",
                    str(FLEET_WEDGE_MS)],
        env=env, announce_dir=str(work / "announce_wedge"), stdout=logf,
        stderr=logf, forkserver=forkserver)
    sup = fleet.ReplicaSupervisor(fac, 1, restart_backoff_ms=50,
                                  name="fleet_wedge").start()
    router = fleet.FleetRouter(supervisor=sup, name="fleet_wedge",
                               health_interval_ms=50, retries=0)
    seen = {"readyz": []}
    try:
        require(router.wait_ready(1, timeout=FLEET_SPAWN_S),
                "fleet wedge: the stub worker is not ready")
        url = sup.endpoints()[0]
        port = int(url.rsplit(":", 1)[1])

        def stub_outstanding():
            code, body = _http_get(port, "/healthz")
            return json.loads(body)["info"]["outstanding"]

        t0 = time.perf_counter()
        poison = router.submit([np.full((1, 4), FLEET_HANG, np.float32)])
        # the poison inside the stub (it takes the free device at once);
        # the waiter sent after it queues behind it
        _wait_for(lambda: stub_outstanding() > 0, 30,
                  "the poison in flight", tag="fleet wedge")
        waiter = {}

        def wait_typed():
            req = urllib.request.Request(
                url + "/submit_many",
                data=codec.encode_batch([[np.ones((1, 4), np.float32)]]),
                method="POST")
            try:
                _opener().open(req, timeout=60).read()
                waiter["answer"] = "ok"
            except urllib.error.HTTPError as e:
                waiter["answer"] = (e.code, e.read().decode())
            except Exception as e:  # noqa: BLE001 - reported below
                waiter["answer"] = repr(e)

        wt = threading.Thread(target=wait_typed)
        wt.start()
        # /readyz read until it flips (the worker answers one health
        # interval more, then exits)
        while True:
            try:
                code, body = _http_get(port, "/readyz", timeout=2)
            except OSError:
                break
            seen["readyz"].append((code, json.loads(body)))
            if code == 503:
                break
            require(time.perf_counter() - t0 < 60,
                    "fleet wedge: /readyz never flipped")
            time.sleep(0.01)
        wt.join(60)
        try:
            poison.result(60)
            poison_err = None
        except Exception as e:  # noqa: BLE001 - expected
            poison_err = type(e).__name__
        wedge_s = time.perf_counter() - t0
        flipped = [b for c, b in seen["readyz"] if c == 503]
        require(flipped and flipped[0].get("wedged") is True,
                f"fleet wedge: /readyz reads {seen['readyz'][-3:]}")
        ans = waiter.get("answer")
        require(isinstance(ans, tuple) and ans[0] == 503 and
                "wedged" in ans[1],
                f"fleet wedge: the waiter got {ans!r}, not a typed 503")
        require(poison_err is not None, "fleet wedge: the poison returned")
        _wait_for(lambda: sup.restart_counts().get(0, 0) == 1, 60,
                  "the respawn", tag="fleet wedge")
        require(router.wait_ready(1, timeout=FLEET_SPAWN_S),
                "fleet wedge: the respawned worker is not ready")
        return {"wedge_to_typed_s": wedge_s, "poison": poison_err,
                "waiter": ans[0], "readyz": flipped[0],
                "respawn_s": time.perf_counter() - t0}
    finally:
        router.shutdown()
        sup.stop()


def phase_fleet(state):
    """The serving fleet on the card: leg A, two thread replicas of ERNIE-
    base with gpt3_1p3b generation behind RouterApp; leg B, worker
    processes under the autoscaler, a rolling swap, a SIGKILL and the
    wedge drill. Float32 throughout (the reference's default serving
    precision)."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.static import InputSpec
    t0 = time.perf_counter()
    from paddle_tpu_torch.framework.forkserver import ForkServer
    _build.load_library()       # once here: the workers load it as built
    seed = state["seed"]
    state.pop("model", None)    # the bf16 model of earlier phases
    _release()
    # leg B's workers fork from a server that imported torch and the
    # artifact loader's modules once (it starts importing them now)
    state["forkserver"] = ForkServer().start()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        cfg = ernie_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        prefixes = {}
        for v, s in (("v1", seed), ("v2", seed + 1)):
            model = ErnieForSequenceClassification(
                cfg, num_classes=2, device="cuda", seed=s).eval()
            prefixes[v] = str(work / f"model_{v}")
            jit.save(model, prefixes[v], input_spec=[
                InputSpec([None, None], "int64", "input_ids")])
            del model
        _release()
        thread = _fleet_thread_leg(state, work, prefixes["v1"],
                                   cfg.vocab_size)
        log("fleet A: " + json.dumps(thread))
        process = _fleet_process_leg(state, work, prefixes, cfg.vocab_size)
        log("fleet B: " + json.dumps(process))
        torch.cuda.synchronize()
    finally:
        state.pop("forkserver").stop()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": state.get("smi"), "thread": thread, "process": process,
           "seconds": time.perf_counter() - t0}
    state["fleet"] = out
    log(f"fleet: {out['seconds']:.1f} s ({state.get('smi')})")


# ------------------------------------------------ elastic training
# Leg A: the north star at full width and ELASTIC_LAYERS of its 24 layers
# (the whole smoke must end well inside its time limit since the runtime
# phase came; the checkpoint's bytes, and so its save and restore
# seconds, scale with the depth) (gpt3_1p3b stacked,
# recompute "full", b=2 s=2048, bf16 O2, AdamW with float32 moments under
# a LinearWarmup schedule) under CheckpointManager; leg B: the
# cross-process kill drills (faultinject) at PARITY_LAYERS depth; leg C:
# Model.fit of the hapi phase's float32 encoder with ElasticCheckpoint and
# the training telemetry.
ELASTIC_LAYERS = 6
ELASTIC_STEPS = 11          # saves at 4 and 8, keep=1; resume at 8
ELASTIC_INTERVAL = 4
ELASTIC_FAULT_STEPS, ELASTIC_FAULT_INTERVAL = 12, 3
ELASTIC_FIT_INTERVAL = 4
ELASTIC_WORKER_TIMEOUT_S = 300.0


def _elastic_root(ckpt_bytes: int, tag: str) -> tuple:
    """A directory for checkpoints of ``ckpt_bytes`` each, in the
    temporary directory (``TMPDIR``; point it at a tmpfs for a faster
    one), which must hold two of them and 2 GB more, else the phase
    fails. Returns (path, why)."""
    import shutil
    import tempfile
    where = Path(tempfile.gettempdir())
    free = shutil.disk_usage(where).free
    require(free >= 2 * ckpt_bytes + 2e9,
            f"elastic {tag}: {where} cannot hold two checkpoints of "
            f"{ckpt_bytes / 1e9:.2f} GB ({free / 1e9:.1f} GB free)")
    path = Path(tempfile.mkdtemp(prefix=f"chip_smoke_elastic_{tag}_",
                                 dir=where))
    why = {"dir": str(path), "free_gb": free / 1e9,
           "checkpoint_gb": ckpt_bytes / 1e9}
    log(f"elastic {tag}: checkpoints in {path} " + json.dumps(why))
    return path, why


def _gpt_params(cfg) -> int:
    """Parameters of a GPT config: embeddings, 12 h^2 + 13 h a layer
    (attention, the 4h MLP, two LayerNorms), the final LayerNorm."""
    h = cfg.hidden_size
    return (cfg.vocab_size + cfg.max_seq_len) * h + cfg.num_layers * (
        12 * h * h + 13 * h) + 2 * h


# checkpoint bytes a parameter: float32 weights and two float32 moments
ELASTIC_BYTES_PER_PARAM = 12


def _gauge(name, *labels):
    from paddle_tpu_torch.observability.registry import default_registry
    fam = default_registry().get(name)
    if fam is None:
        return 0
    return (fam.labels(*labels) if labels else fam).value


def _elastic_north_star(state) -> dict:
    """Leg A: 11 steps of gpt3_1p3b at ELASTIC_LAYERS layers under
    CheckpointManager (async saves
    every 4 steps, keep=1), then a fresh model, optimizer and schedule from
    another seed restored from step 8's checkpoint, and steps 9-11 again:
    losses, parameters and AdamW moments bit for bit; the launches exact;
    the goodput identity; the paddle_ckpt_* families."""
    import shutil
    import torch
    from paddle_tpu_torch.elastic import CheckpointManager
    from paddle_tpu_torch.framework import checkpoint as ck
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.models import gpt3_1p3b
    from paddle_tpu_torch.observability import goodput
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    from paddle_tpu_torch.tools import elastic_ckpt_worker as worker
    seed = state["seed"]
    ledger = goodput.GoodputLedger()
    prev_ledger = goodput.set_default_ledger(ledger)
    ledger.start()
    saves_ok0 = _gauge("paddle_ckpt_saves_total", "ok")
    lost0 = _gauge("paddle_ckpt_steps_lost_total")
    cfg = gpt3_1p3b(stacked=True, recompute="full",
                    num_layers=ELASTIC_LAYERS)
    per_step = {"flash_fwd": cfg.num_layers * STACKED_FWD_PER_LAYER["full"],
                **{n: cfg.num_layers for n in cab.KERNELS}}
    root, where = _elastic_root(
        ELASTIC_BYTES_PER_PARAM * _gpt_params(cfg), "north_star")
    saves, step_ms, managers = [], [], []

    def run(mgr, model, sched, train_step, steps):
        """Steps ``steps`` (global numbers) with ``mgr.step`` after each:
        each step's ms (synchronised; ``host_ms`` until the step's calls
        return) and whether a save was in flight; at a save step, the wait
        for the previous save (which ``save`` does first) apart from the
        save's synchronous half, and, when its writer ends, its total."""
        losses = []
        for i in steps:
            busy = bool(saves) and "total_s" not in saves[-1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = worker.gpt_batch(model, "cuda")
            loss = train_step(ids, ids)
            sched.step()
            t_host = time.perf_counter()
            losses.append(float(loss))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_ms.append({"step": i, "ms": (t1 - t0) * 1e3,
                            "host_ms": (t_host - t0) * 1e3,
                            "save_in_flight": busy})
            wait_s = None
            if i % ELASTIC_INTERVAL == 0:
                mgr.wait()
                wait_s = time.perf_counter() - t1
                t1 = time.perf_counter()
            handle = mgr.step(i)
            if handle is not None:
                rec = {"step": i, "waited_for_previous_s": wait_s,
                       "sync_s": time.perf_counter() - t1}
                handle.add_done_callback(
                    lambda _h, rec=rec, t1=t1: rec.update(
                        total_s=time.perf_counter() - t1))
                saves.append(rec)
        return losses

    try:
        trandom.seed(seed + 11)
        model, opt, sched, step = worker.build_gpt(cfg.num_layers, "cuda",
                                                   seed=seed)
        mgr = CheckpointManager(str(root), model=model, optimizer=opt,
                                save_interval_steps=ELASTIC_INTERVAL,
                                async_save=True, keep=1,
                                health_check=False)
        managers.append(mgr)
        _reset_counts()
        straight = run(mgr, model, sched, step,
                       range(1, ELASTIC_STEPS + 1))
        counts_a = _read_counts()
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        mgr.close()
        for rec in saves:
            rec["writer_s"] = rec["total_s"] - rec["sync_s"]
        kept = [Path(p).name for p in ck.list_checkpoints(str(root))]
        nbytes = ck.checkpoint_nbytes(str(root / "step_00000008"))
        require(kept == ["step_00000008"],
                f"elastic A: keep=1 left {kept}, not step 8's checkpoint")
        require(_gauge("paddle_ckpt_saves_total", "ok") - saves_ok0 == 2,
                "elastic A: not 2 successful saves")
        # a fresh model, optimizer and schedule from another seed, the
        # generator reseeded: the restore must bring back all of it
        trandom.seed(seed + 999)
        model2, opt2, sched2, step2 = worker.build_gpt(
            cfg.num_layers, "cuda", seed=seed + 1)
        mgr2 = CheckpointManager(str(root), model=model2, optimizer=opt2,
                                 save_interval_steps=ELASTIC_INTERVAL,
                                 async_save=True, keep=1,
                                 health_check=False)
        managers.append(mgr2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mgr2.restore_latest()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(res is not None and res.step == 8 and res.steps_lost == 3,
                f"elastic A: restored {res}, not step 8 with 3 steps lost")
        _reset_counts()
        resumed = run(mgr2, model2, sched2, step2,
                      range(res.step + 1, ELASTIC_STEPS + 1))
        counts_b = _read_counts()
        mgr2.close()
        report = ledger.report()
        same_p = all(torch.equal(a, b) for a, b in zip(
            model.parameters(), model2.parameters()))
        same_m = all(torch.equal(opt._accumulators[an][id(a)],
                                 opt2._accumulators[an][id(b)])
                     for a, b in zip(opt._parameters, opt2._parameters)
                     for an in opt._accum_names)
        out = {"config": f"gpt3_1p3b(stacked=True, recompute='full', "
                         f"num_layers={ELASTIC_LAYERS}), "
                         f"b={worker.GPT_BATCH} s={worker.GPT_SEQ}, bf16 "
                         f"O2, AdamW (float32 moments), LinearWarmup",
               "params": model.num_params(), "where": where,
               "checkpoint_bytes": nbytes, "saves": saves,
               "wait_for_last_save_s": wait_s, "restore_s": restore_s,
               "restore_ms_manager": res.restore_ms,
               "losses_straight": straight, "losses_resumed": resumed,
               "params_bit_for_bit": same_p, "moments_bit_for_bit": same_m,
               "step_ms": step_ms, "launches_straight": counts_a,
               "launches_resumed": counts_b,
               "goodput": report, "card": state.get("smi")}
        with_save = [r["ms"] for r in step_ms[1:] if r["save_in_flight"]]
        without = [r["ms"] for r in step_ms[1:] if not r["save_in_flight"]]
        out["step_ms_with_save_in_flight"] = statistics.median(with_save) \
            if with_save else None
        out["step_ms_without_save"] = statistics.median(without) \
            if without else None
        log("elastic A: " + json.dumps(out))
        require(resumed == straight[res.step:],
                f"elastic A: steps 9-11 lost {resumed} against "
                f"{straight[res.step:]}")
        require(same_p, "elastic A: parameters differ after the resume")
        require(same_m, "elastic A: AdamW moments differ after the resume")
        _require_launches("elastic A", counts_a, per_step, ELASTIC_STEPS)
        _require_launches("elastic A resumed", counts_b, per_step,
                          ELASTIC_STEPS - res.step)
        acc, cats = report["accounting"], report["categories_s"]
        require(acc["closes"], f"elastic A: goodput accounting does not "
                               f"close: {acc}")
        require(cats["ckpt_save"] > 0 and cats["ckpt_restore"] > 0
                and cats["recovery"] > 0
                and report["replay_steps_pending"] == 0,
                f"elastic A: goodput categories {cats}")
        require(_gauge("paddle_ckpt_last_success_step") == 8,
                "elastic A: paddle_ckpt_last_success_step is not 8")
        require(_gauge("paddle_ckpt_steps_lost_total") - lost0 == 3,
                "elastic A: paddle_ckpt_steps_lost_total did not rise by 3")
        out["launches"] = _add_launches(counts_a["launches"],
                                        counts_b["launches"])
        return out
    finally:
        goodput.set_default_ledger(prev_ledger)
        for m in managers:      # frees the page-locked snapshot buffer
            m.close()
        shutil.rmtree(root, ignore_errors=True)


def _elastic_drills(state) -> dict:
    """Leg B: faultinject over elastic_ckpt_worker --model gpt --layers
    PARITY_LAYERS on the card: an uninterrupted run, then a SIGKILL
    mid-step, mid-save and mid-commit and a SIGTERM, each relaunched; every
    loss bitwise, launches 8/4/4 a step in each completed worker."""
    import shutil
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    cfg = gpt3_1p3b(stacked=True, recompute="full",
                    num_layers=PARITY_LAYERS)
    root, where = _elastic_root(
        ELASTIC_BYTES_PER_PARAM * _gpt_params(cfg), "drills")
    out_json = OUT_DIR / "elastic_faultinject.json"
    OUT_DIR.mkdir(exist_ok=True)
    per_step = (PARITY_LAYERS * STACKED_FWD_PER_LAYER["full"],
                PARITY_LAYERS, PARITY_LAYERS)
    torch.cuda.empty_cache()
    cache_dir = root / "compile_cache"
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.faultinject",
             "--model", "gpt", "--layers", str(PARITY_LAYERS),
             "--steps", str(ELASTIC_FAULT_STEPS),
             "--interval", str(ELASTIC_FAULT_INTERVAL), "--keep", "2",
             "--kills", "3", "--sleep-s", "0.05", "--midstep-sleep", "1.0",
             "--seed", str(state["seed"]),
             "--expect-launches", ",".join(map(str, per_step)),
             "--dir", str(root), "--timeout-s",
             str(ELASTIC_WORKER_TIMEOUT_S), "--out", str(out_json),
             "--forkserver"],
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, timeout=12 * ELASTIC_WORKER_TIMEOUT_S,
            env=dict(os.environ, FLAGS_compile_cache_dir=str(cache_dir)))
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("elastic B: faultinject stderr: " + proc.stderr[-3000:])
    require(proc.returncode == 0,
            f"elastic B: faultinject exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    require(rec["trajectory_bitwise_equal"] and rec["final_digest_equal"]
            and rec["kills_survived"] == 3 and rec["sigterm"] is not None,
            f"elastic B: {rec}")
    # the workers share one compile cache: the two fresh processes (the
    # reference and the fault run's first) measure their first step, and
    # every relaunch's TrainStep loads that record (0 misses)
    starts = [st for st in rec["startup"] if st.get("compile_cache")]
    relaunched = [st for st in starts if st["resumed"]]
    require(len(starts) == len(rec["startup"]) and relaunched and all(
        st["compile_cache"]["misses"] == 0 and st["compile_cache"]["hits"]
        >= 1 for st in relaunched) and all(
        st["compile_cache"]["misses"] >= 1 for st in starts
        if not st["resumed"]),
        f"elastic B: the workers' compile-cache counts "
        f"{[(st['attempt'], st['compile_cache']) for st in rec['startup']]}")
    for st in rec["startup"]:
        log("elastic B: worker start-up split (s): " + json.dumps(st))
    rec.update({"where": where, "seconds": seconds,
                "card": state.get("smi")})
    log("elastic B: " + json.dumps(rec))
    wl = rec["worker_launches"]
    steps_done = ELASTIC_FAULT_STEPS + wl["final_steps"]
    rec["launches"] = {
        name: wl["reference"][i] + wl["final"][i]
        for i, name in enumerate(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"))}
    require(all(rec["launches"][k] == n * steps_done for k, n in zip(
        rec["launches"], per_step)),
        f"elastic B: launches {rec['launches']} over {steps_done} steps")
    return rec


def _elastic_fit(state) -> dict:
    """Leg C: the hapi phase's float32 encoder classifier (BERT-base
    widths, LAMB) through Model.fit with ElasticCheckpoint and
    TrainingTelemetryCallback, the optimizers instrumented and the
    telemetry server up: /goodputz closes, the training and optimizer
    counters equal the steps; a second fit on a fresh model resumes from
    the last save with the first fit's parameters at that step, bit for
    bit; the float32 flash kernels launch, their plain versions never."""
    import shutil
    import tempfile
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.observability import goodput, httpd, training
    script = _load_script(ENCODER_SCRIPT, "encoder_script")
    h = _load_script(HAPI_SCRIPT, "hapi_script")
    paddle.set_device("gpu")
    seed = state["seed"]
    train = h.samples(paddle, NN_CFG, HAPI_TRAIN_BATCHES, seed + 1)
    ledger = goodput.GoodputLedger()
    prev_ledger = goodput.set_default_ledger(ledger)
    srv = httpd.start_telemetry_server(port=0, host="127.0.0.1")
    training.uninstrument_optimizers()
    training.instrument_optimizers()
    steps0 = _gauge("paddle_training_steps_total")
    lamb0 = _gauge("paddle_optimizer_steps_total", "Lamb")

    class Keep(paddle.callbacks.Callback):
        """Each global step's parameters (after the update), and the
        parameters as training begins (after ElasticCheckpoint's
        restore)."""
        def __init__(self, start=0):
            super().__init__()
            self.at, self.step, self.begin = {}, start, None

        def on_train_begin(self, logs=None):
            self.begin = {n: p._data.detach().clone() for n, p in
                          self.model.network.named_parameters()}

        def on_train_batch_end(self, step, logs=None):
            self.step += 1
            self.at[self.step] = {n: p._data.detach().clone() for n, p in
                                  self.model.network.named_parameters()}

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        paddle.seed(seed)
        model = h.make_model(paddle, script, NN_CFG, warmup=HAPI_WARMUP)
        elastic = paddle.callbacks.ElasticCheckpoint(
            str(root), save_interval_steps=ELASTIC_FIT_INTERVAL, keep=2)
        keep = Keep()
        _reset_counts()
        t0 = time.perf_counter()
        hist = model.fit(train, batch_size=NN_CFG["batch"], epochs=1,
                         shuffle=False, verbose=0, callbacks=[
                             paddle.callbacks.LRScheduler(
                                 by_step=True, by_epoch=False),
                             elastic, training.TrainingTelemetryCallback(
                                 batch_size=NN_CFG["batch"]), keep])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _read_counts()
        steps = len(hist["loss"])
        code, body = _http_get(srv.port, "/goodputz")
        doc = json.loads(body)
        # a second fit on a fresh model from another seed resumes
        paddle.seed(seed + 5)
        model2 = h.make_model(paddle, script, NN_CFG, warmup=HAPI_WARMUP)
        elastic2 = paddle.callbacks.ElasticCheckpoint(
            str(root), save_interval_steps=ELASTIC_FIT_INTERVAL, keep=2)
        keep2 = Keep()
        _reset_counts()
        hist2 = model2.fit(train, batch_size=NN_CFG["batch"], epochs=1,
                           shuffle=False, verbose=0, callbacks=[
                               paddle.callbacks.LRScheduler(
                                   by_step=True, by_epoch=False),
                               elastic2, keep2])
        torch.cuda.synchronize()
        counts2 = _read_counts()
        restored = elastic2.restored
        same = restored is not None and restored.step in keep.at and all(
            torch.equal(keep2.begin[n], p)
            for n, p in keep.at[restored.step].items())
    finally:
        training.uninstrument_optimizers()
        goodput.set_default_ledger(prev_ledger)
        shutil.rmtree(root, ignore_errors=True)
    per_step = {k: NN_CFG["layers"] for k in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")}
    out = {"config": "bert_base encoder classifier, float32, LAMB, "
                     "Model.fit + ElasticCheckpoint + "
                     "TrainingTelemetryCallback",
           "steps": steps, "fit_s": fit_s, "goodputz_status": code,
           "goodput": doc.get("goodput"),
           "training_steps_total": _gauge("paddle_training_steps_total")
           - steps0,
           "lamb_steps_total": _gauge("paddle_optimizer_steps_total", "Lamb")
           - lamb0,
           "restored_step": None if restored is None else restored.step,
           "params_at_restore_bit_for_bit": same,
           "losses": hist["loss"], "losses_second_fit": hist2["loss"],
           "launches": counts, "launches_second_fit": counts2,
           "card": state.get("smi")}
    log("elastic C: " + json.dumps(out))
    require(code == 200 and doc["goodput"]["accounting"]["closes"],
            f"elastic C: /goodputz {code}: {body[:400]}")
    require(out["training_steps_total"] == steps == HAPI_TRAIN_BATCHES,
            f"elastic C: paddle_training_steps_total "
            f"{out['training_steps_total']} for {steps} steps")
    require(out["lamb_steps_total"] == steps + len(hist2["loss"]),
            f"elastic C: paddle_optimizer_steps_total{{optimizer=Lamb}} "
            f"{out['lamb_steps_total']}")
    require(out["restored_step"] == steps,
            f"elastic C: the second fit restored step "
            f"{out['restored_step']}, not the last save's {steps}")
    require(same, "elastic C: parameters after the restore differ from "
                  "the first fit's at that step")
    _require_launches("elastic C", counts, per_step, steps)
    _require_launches("elastic C second fit", counts2, per_step,
                      len(hist2["loss"]))
    out["launches_f32"] = _add_launches(counts["launches"],
                                        counts2["launches"])
    return out


def phase_elastic(state):
    """Elastic training on the card: leg A, gpt3_1p3b at full width and
    ELASTIC_LAYERS layers resumed bit for bit from an async checkpoint in
    one process; leg
    B, the kill -9 and SIGTERM drills across processes at PARITY_LAYERS
    depth; leg C, Model.fit with ElasticCheckpoint and the training
    telemetry, /goodputz over HTTP."""
    import torch
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()       # built once: the drill's workers load it
    state.pop("model", None)
    _release()
    out = {"north_star": _elastic_north_star(state)}
    _release()
    out["drills"] = _elastic_drills(state)
    out["fit"] = _elastic_fit(state)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["card"] = state.get("smi")
    state["elastic"] = out
    log(f"elastic: {out['seconds']:.1f} s ({state.get('smi')})")


# ------------------------------------------------ the runtime plane
# Leg A: gpt3_1p3b (bf16) serving under the numerics plane (every decode,
# chunked and verify call tripwired and shadow-checked); leg B: the
# north-star training step under the gradient tripwires; leg C: profiles
# and the runtime collectors; leg D: the SDC canary on the card and behind
# the router.
RT_REQUESTS = 8            # leg A's requests a run
RT_NEW = 32                # their new tokens
RT_PROMPT_LENS = (64, 512)
RT_SYSTEM = 256            # the prompt two requests share
RT_SPEC_K = 4
RT_GATE_BATCH, RT_GATE_PAGES = 4, 20   # the direct gate's decoder
RT_GATE_LENS = (200, 130, 170, 90)
RT_GATE_CHUNK, RT_GATE_VERIFY = 40, RT_SPEC_K + 1
RT_TIMED_CALLS = 8         # decode calls timed per mode and turn
RT_FAULT_REQUESTS, RT_FAULT_NEW = 4, 16
RT_TRAIN_STEPS = 4         # the gated steps (FLAGS_check_nan_inf)
RT_TIMED_STEPS = 3         # steps a turn, tripwires on and off
RT_NORM_RTOL = 1e-3
RT_COST_TOL = 0.15         # bench.py's _COST_AGREE_TOL
RT_CAPTURE_MS = 500
RT_TRAIN_KERNELS = ("flash_fwd_wgmma_kernel", "dq_wgmma_kernel",
                    "dkv_wgmma_kernel")
RT_F16_LAYERS = PARITY_LAYERS
RT_CANARY_PERIOD_S = 0.5
RT_D_REQUESTS, RT_D_SEQ = 32, 128
RT_SITES = ("generate_prefill", "generate_decode", "generate_chunked",
            "generate_verify", "train_step", "serving")


def _rt_flags(**values):
    """Set ``FLAGS_<name>`` values; returns the old ones."""
    from paddle_tpu_torch.framework.flags import flag_value, set_flags
    values = {f"FLAGS_{k}": v for k, v in values.items()}
    old = {k: flag_value(k) for k in values}
    set_flags(values)
    return old


def _rt_http_json(port, path, timeout=30.0):
    code, body = _http_get(port, path, timeout=timeout)
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body


def _rt_clone(pools):
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.clone(), pools)


def _rt_same(a, b) -> bool:
    """Per-layer pools equal byte for byte outside page 0, the trash page:
    masked positions of several rows write the same trash slots, and
    ``index_copy_`` on CUDA leaves such duplicates in no fixed order, with
    or without a shadow (the page holds garbage by contract)."""
    import torch
    from torch.utils._pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x[1:].view(torch.uint8), y[1:].view(torch.uint8))
        for x, y in zip(la, lb))


def _rt_pages_apart(a, b) -> list:
    """The pages where two per-layer pools differ (for a failure's
    message)."""
    from torch.utils._pytree import tree_leaves
    pages = set()
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        diff = x.ne(y).reshape(x.shape[0], -1).any(1)
        pages.update(diff.nonzero().flatten().tolist())
    return sorted(pages)


def _rt_rng_state():
    import torch
    from paddle_tpu_torch.framework import random as trandom
    st = trandom.get_rng_state()[0]
    return ({k: v.clone() for k, v in st["states"].items()}, st["seed"],
            torch.cuda.get_rng_state().clone())


def _rt_same_rng(a, b) -> bool:
    import torch
    return (a[1] == b[1] and a[0].keys() == b[0].keys()
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and torch.equal(a[2], b[2]))


def _rt_direct_gate(model, kv_dtype, seed) -> dict:
    """One decode, one chunked and one verify call of a CachedDecoder, each
    from the same cloned pools, with the shadow off, with it on, and
    through a decoder on the plain versions: the shadow leaves outputs,
    pools, tables and the generators bit for bit, runs 24 plain calls, and
    publishes max|kernel - plain| to the float. Then the decode step's ms
    with the plane off, the tripwires only, and tripwires and shadow."""
    import numpy as np
    import torch
    from paddle_tpu_torch.observability import numerics
    from paddle_tpu_torch.observability.registry import default_registry
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
    cfg = model.config
    b, p = RT_GATE_BATCH, RT_GATE_PAGES
    kw = {"max_batch": b, "page_size": PAGE_SIZE, "pages_per_seq": p,
          "kv_dtype": kv_dtype, "device": "cuda"}
    dec = CachedDecoder(model, **kw)
    plain = CachedDecoder(model, use_kernels=False, **kw)
    label = dec._dtype_label
    k, v = model.init_kv_pools(1 + 2 * b * p, PAGE_SIZE,
                               dtype="int8" if kv_dtype == "int8" else None)
    # every other page: the pools hold pages no table names
    tables = (1 + 2 * np.arange(b * p, dtype=np.int32)).reshape(b, p)
    rng = np.random.RandomState(seed + 61)
    lens = np.array(RT_GATE_LENS, np.int32)
    ids = np.zeros((b, int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, cfg.vocab_size, n)
    old = _rt_flags(numerics_shadow_rate=0.0, numerics_sample_rate=0.0)
    try:
        dec.prefill(ids, lens, tables, k, v)
        torch.cuda.synchronize()
        base = (k, v)
        chunk = rng.randint(1, cfg.vocab_size, (b, RT_GATE_CHUNK))
        window = rng.randint(1, cfg.vocab_size, (b, RT_GATE_VERIFY))
        rng_tok = rng.randint(1, cfg.vocab_size, b)
        calls = {
            "decode": lambda d, kk, vv: d.decode(
                rng_tok, lens, np.array([1, 1, 1, 0], bool), lens + 1,
                tables, kk, vv),
            "chunked": lambda d, kk, vv: d.prefill_chunked(
                chunk, lens, np.array([RT_GATE_CHUNK, 17, 1, 0], np.int32),
                tables, kk, vv),
            "verify": lambda d, kk, vv: d.verify(
                window, lens, np.array([RT_GATE_VERIFY] * 3 + [0],
                                       np.int32), tables, kk, vv)}
        fam = default_registry().get("paddle_numerics_shadow_divergence")
        out = {"dtype": label}
        for kind, call in calls.items():
            runs = {}
            for mode in ("off", "shadow", "plain"):
                _rt_flags(numerics_shadow_rate=1.0 if mode == "shadow"
                          else 0.0)
                kk, vv = _rt_clone(base)
                t0 = tables.copy()
                rng0 = _rt_rng_state()
                plain0 = cpa.plain_calls
                logits = call(plain if mode == "plain" else dec, kk, vv)[0]
                torch.cuda.synchronize()
                runs[mode] = {"logits": logits, "pools": (kk, vv),
                              "plain_calls": cpa.plain_calls - plain0,
                              "tables_same": np.array_equal(tables, t0),
                              "rng_same": _rt_same_rng(rng0,
                                                       _rt_rng_state())}
            numerics.drain()
            fam = default_registry().get("paddle_numerics_shadow_divergence")
            published = fam.labels(kind=kind, dtype=label).value
            mine = float((runs["off"]["logits"].float()
                          - runs["plain"]["logits"].float()).abs().max())
            off, sh = runs["off"], runs["shadow"]
            row = {"divergence": published, "max_abs_kernel_plain": mine,
                   "shadow_plain_calls": sh["plain_calls"],
                   "plain_decoder_plain_calls": runs["plain"]["plain_calls"]}
            log(f"runtime A: direct gate {label} {kind}: {row}")
            require(torch.equal(off["logits"], sh["logits"]),
                    f"runtime A: {label} {kind}: the shadow changed the "
                    f"logits")
            require(_rt_same(off["pools"], sh["pools"]),
                    f"runtime A: {label} {kind}: the shadow changed the "
                    f"pools (pages "
                    f"{_rt_pages_apart(off['pools'], sh['pools'])[:20]})")
            require(sh["tables_same"] and sh["rng_same"] and
                    off["rng_same"],
                    f"runtime A: {label} {kind}: tables or generators moved")
            require(sh["plain_calls"] == cfg.num_layers and
                    off["plain_calls"] == 0,
                    f"runtime A: {label} {kind}: {sh['plain_calls']} plain "
                    f"calls with the shadow, {off['plain_calls']} without, "
                    f"not {cfg.num_layers} and 0")
            require(published == mine,
                    f"runtime A: {label} {kind}: published divergence "
                    f"{published!r} is not the phase's max|kernel - plain| "
                    f"{mine!r}")
            out[kind] = row
        # the decode step with the plane off, tripwires only, and both
        ms = {"off": [], "tripwires": [], "tripwires_shadow": []}
        kk, vv = _rt_clone(base)
        modes = {"off": (0.0, 0.0), "tripwires": (1.0, 0.0),
                 "tripwires_shadow": (1.0, 1.0)}
        for name in ("off", "tripwires", "tripwires_shadow",
                     "tripwires_shadow", "tripwires", "off") * 2:
            sample, shadow = modes[name]
            _rt_flags(numerics_sample_rate=sample,
                      numerics_shadow_rate=shadow)
            turn = []
            for _ in range(RT_TIMED_CALLS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls["decode"](dec, kk, vv)
                torch.cuda.synchronize()
                turn.append((time.perf_counter() - t0) * 1e3)
            ms[name].append(turn[1:])          # each turn's first call out
        numerics.drain()
        out["decode_step_ms"] = {
            n: statistics.median(sum(v, [])) for n, v in ms.items()}
        out["decode_step_ms_turns"] = {
            n: [statistics.median(t) for t in v] for n, v in ms.items()}
        log(f"runtime A: {label} decode step ms (batch {b}, median of "
            f"{4 * RT_TIMED_CALLS}; each turn's median): "
            f"{out['decode_step_ms']} {out['decode_step_ms_turns']}")
    finally:
        _rt_flags(**{k[len("FLAGS_"):]: v for k, v in old.items()})
    del dec, plain, k, v, base
    return out


def _rt_prompts(cfg, seed, n, system=True):
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(RT_PROMPT_LENS[0], RT_PROMPT_LENS[1] + 1, n)
    prompts = [rng.randint(1, cfg.vocab_size, int(m)) for m in lens]
    if system:
        # the first and the last share a system prompt: the last one's
        # admission hits the first one's pages (a chunked call)
        sys_prompt = rng.randint(1, cfg.vocab_size, RT_SYSTEM)
        for i in (0, n - 1):
            prompts[i] = np.concatenate([sys_prompt, prompts[i][:192]])
    return [p.tolist() for p in prompts]


def _rt_engine(model, kv_dtype):
    from paddle_tpu_torch.serving.generation import GenerationServer
    old_kv = _set_kv_dtype(kv_dtype)
    try:
        return GenerationServer(model, max_batch=MAX_BATCH,
                                page_size=PAGE_SIZE, draft_model=model,
                                spec_k=RT_SPEC_K, device="cuda",
                                name=f"rt-{kv_dtype or 'bf16'}", start=False)
    finally:
        _set_kv_dtype(old_kv)


def _rt_serve(srv, prompts, seed) -> tuple:
    """Leg A's traffic: every request but the last, queued before the
    engine starts (so the first admission takes them all: the same
    dispatch signatures in every run), then, once the first ended, the
    last (it shares the first's system prompt: a prefix hit). Returns the
    streams and the first request's time to its first token."""
    futs = [srv.submit_generate(p, max_new_tokens=RT_NEW, temperature=0.0,
                                seed=seed + i)
            for i, p in enumerate(prompts[:-1])]
    t0 = time.perf_counter()
    srv.start()
    _wait_for(lambda: len(futs[0].tokens()) >= 1, 900,
              "the first request's first token", tag="runtime A")
    ttft = time.perf_counter() - t0
    first = futs[0].result(timeout=900)
    futs.append(srv.submit_generate(prompts[-1], max_new_tokens=RT_NEW,
                                    temperature=0.0))
    return [first] + [f.result(timeout=900) for f in futs[1:]], ttft


def _rt_engine_run(model, kv_dtype, seed, port, cache_dir=None) -> dict:
    """The engine (prefix cache, self-speculation at spec_k=4) with every
    call tripwired and shadow-checked: launches by kind 24 x the decoders'
    calls, plain calls 24 x the shadowed calls, every tripwire finite, no
    anomaly, /numericsz with the decode, chunked and verify sections (and
    the int8 scale drift over int8 pools), a clean leak check. With
    ``cache_dir``, the compile cache is on (an empty directory): every
    record it stores is one miss, and the warmup manifest holds exactly
    the traffic's signatures."""
    from paddle_tpu_torch import compile_cache
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    cfg = model.config
    layers = cfg.num_layers
    prompts = _rt_prompts(cfg, seed + 62, RT_REQUESTS)
    if cache_dir is not None:
        _rt_flags(compile_cache_dir=str(cache_dir))
        compile_cache.reset_default_cache()
        st0 = compile_cache.stats()
    srv = _rt_engine(model, kv_dtype)
    pool = "int8" if kv_dtype == "int8" else "bfloat16"
    require(srv.prefix is not None and srv.kv.kv_dtype == kv_dtype,
            "runtime A: engine not configured")
    code, doc0 = _rt_http_json(port, "/numericsz")
    require(code == 200, f"runtime A: /numericsz {code}")
    old = _rt_flags(numerics_shadow_rate=1.0, numerics_sample_rate=1.0)
    ca.launches = ca.plain_calls = 0
    cpa.launches, cpa.plain_calls = 0, 0
    cpa.launches_by, cpa.launches_by_kernel = {}, {}
    try:
        t0 = time.perf_counter()
        with srv:
            outs, ttft = _rt_serve(srv, prompts, seed)
        wall = time.perf_counter() - t0
    finally:
        _rt_flags(**{k[len("FLAGS_"):]: v for k, v in old.items()})
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              "paged": (cpa.launches, cpa.plain_calls)}
    by = dict(cpa.launches_by)
    calls = {"target": dict(srv.decoder.calls),
             "draft": dict(srv.draft.calls)}
    code, doc = _rt_http_json(port, "/numericsz")
    snap = srv.metrics_snapshot()
    for i, toks in enumerate(outs):
        require(len(toks) == RT_NEW and all(0 <= t < cfg.vocab_size
                                            for t in toks),
                f"runtime A: {pool} request {i} emitted {len(toks)} tokens")
    want_chunked = layers * (calls["target"]["chunked"]
                             + calls["target"]["verify"]
                             + calls["draft"]["chunked"])
    want_decode = layers * (calls["target"]["decode"]
                            + calls["draft"]["decode"])
    shadowed = sum(c[k] for c in calls.values()
                   for k in ("decode", "chunked", "verify"))
    require(calls["target"]["chunked"] > 0 and calls["target"]["verify"] > 0
            and calls["draft"]["decode"] > 0,
            f"runtime A: {pool}: a route was not taken: {calls}")
    require(by.get(("chunked", pool), 0) == want_chunked
            and by.get(("decode", pool), 0) == want_decode
            and sum(by.values()) == want_chunked + want_decode,
            f"runtime A: {pool}: paged launches {by} against the decoders' "
            f"calls {calls}")
    require(counts["flash_fwd"][0] == layers * (
        calls["target"]["prefill"] + calls["draft"]["prefill"])
        and counts["flash_fwd"][1] == 0,
        f"runtime A: {pool}: flash {counts['flash_fwd']} against {calls}")
    require(counts["paged"][1] == layers * shadowed,
            f"runtime A: {pool}: {counts['paged'][1]} plain calls, not "
            f"{layers} x the {shadowed} shadowed calls")
    require(code == 200, f"runtime A: /numericsz {code}")
    kinds = doc["serving"]
    require({"decode", "chunked", "verify"} <= set(kinds),
            f"runtime A: {pool}: /numericsz sections {sorted(kinds)}")
    require(all(kinds[k]["finite_fraction"] == 1.0 for k in kinds),
            f"runtime A: {pool}: finite fractions "
            f"{ {k: kinds[k]['finite_fraction'] for k in kinds} }")
    new_anomalies = doc["anomalies"]["total"] - doc0["anomalies"]["total"]
    require(new_anomalies == 0,
            f"runtime A: {pool}: {new_anomalies} anomalies "
            f"({doc['anomalies']['last']})")
    label = srv.decoder._dtype_label
    shadow = {k: doc["shadow"][f"{k}/{label}"]
              for k in ("decode", "chunked", "verify")}
    if kv_dtype == "int8":
        require(doc["int8"] and all(r["notes"] > 0
                                    for r in doc["int8"].values()),
                f"runtime A: int8 scale drift missing: {doc['int8']}")
    require(snap["kv_leak_check"]["ok"],
            f"runtime A: {pool}: leak check {snap['kv_leak_check']}")
    out = {"pool": pool, "wall_s": wall, "decoder_calls": calls,
           "shadowed_calls": shadowed, "paged_launches_by":
           {"/".join(k): n for k, n in by.items()},
           "paged_launches_by_kernel": dict(cpa.launches_by_kernel),
           "launches": {"flash_fwd": counts["flash_fwd"][0],
                        "paged_attention": counts["paged"][0]},
           "plain_calls": counts["paged"][1],
           "prefix_hits": snap["prefix"]["hits"],
           "shadow_divergence": shadow,
           "argmax_entropy": {k: kinds[k]["argmax_entropy"] for k in kinds},
           "finite_fraction": {k: kinds[k]["finite_fraction"]
                               for k in kinds},
           "int8_scale_drift": {k: r["drift"]
                                for k, r in doc["int8"].items()},
           "first_token_s": ttft}
    if cache_dir is not None:
        st1 = compile_cache.stats()
        d = {k: st1[k] - st0[k] for k in ("hits", "misses", "stored")}
        stored = compile_cache.CacheStore(str(cache_dir)).entries()
        traffic = sorted(json.dumps([site, [list(sh) for sh, _ in feeds]])
                         for site, feeds in srv.dispatch_signatures
                         if not site.startswith("draft_"))
        manifest = sorted(json.dumps([m["site"], [list(sh) for sh, _ in
                                                  m["feeds"]]])
                          for m in srv.warmup_manifest.specs())
        # every key stored is one miss; the draft (the model itself)
        # finds the target's records: the hits
        require(d["misses"] > 0 and d["stored"] == d["misses"]
                == len(stored),
                f"runtime A: cache: {d} with {len(stored)} records")
        require(manifest == traffic,
                f"runtime A: the manifest {manifest} is not the traffic's "
                f"signatures {traffic}")
        out["cache"] = dict(d, records=len(stored),
                            manifest_signatures=len(manifest))
        out["outs"] = outs
    log(f"runtime A: engine {pool}: " + json.dumps(
        {k: v for k, v in out.items() if k != "outs"}))
    del srv
    return out


def _rt_cache_replay(model, seed, port, cache_dir, first) -> dict:
    """A second engine on the same model and the warm directory: its
    manifest replayed before traffic (every first dispatch a hit, none a
    miss, no xstats entry created after), the same requests with the same
    seeds (streams bit for bit the first engine's), /metrics against
    ``compile_cache.stats()``, and a stored record's FLOPs against the
    phase's own measurement of that signature."""
    import numpy as np
    import torch
    from paddle_tpu_torch import compile_cache
    from paddle_tpu_torch.observability import xstats
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
    prompts = _rt_prompts(model.config, seed + 62, RT_REQUESTS)
    _rt_flags(compile_cache_dir=str(cache_dir))
    try:
        reg = xstats.default_exec_registry()
        st0 = compile_cache.stats()
        n0 = (ca.launches, cpa.launches, ca.plain_calls, cpa.plain_calls)
        srv = _rt_engine(model, "")
        t0 = time.perf_counter()
        fresh = srv.warmup_from_manifest()
        replay_s = time.perf_counter() - t0
        st1 = compile_cache.stats()
        n_entries = len(reg.entries())
        with srv:
            outs, ttft = _rt_serve(srv, prompts, seed)
        st2 = compile_cache.stats()
        launches = {"flash_fwd": ca.launches - n0[0],
                    "paged_attention": cpa.launches - n0[1]}
        require(ca.plain_calls == n0[2] and cpa.plain_calls == n0[3]
                and all(launches.values()),
                f"runtime A: the warm engine launched {launches} and ran "
                f"{ca.plain_calls - n0[2]}, {cpa.plain_calls - n0[3]} plain "
                f"calls")
        hits = st1["hits"] - st0["hits"]
        # the replay's hits, then the traffic's first dispatches the
        # manifest does not name (the draft's decode step): hits too
        require(st2["misses"] == st0["misses"] and hits > 0,
                f"runtime A: replay: {st0} -> {st1} -> {st2}")
        require(len(reg.entries()) == n_entries,
                f"runtime A: {len(reg.entries()) - n_entries} xstats "
                f"entries created after the replay")
        require(outs == first["outs"],
                "runtime A: the warm engine's streams differ from the cold "
                "engine's")
        samples = _parse_prometheus(_http_get(port, "/metrics")[1])
        scraped = {k: int(sum(v for (n, _), v in samples.items()
                              if n == f"paddle_compile_cache_{k}_total"))
                   for k in ("hits", "misses")}
        require(scraped == {k: st2[k] for k in ("hits", "misses")},
                f"runtime A: /metrics {scraped} against stats() {st2}")
        skipped_ms = sum((e.analysis or {}).get("measure_host_ms", 0.0)
                         for e in reg.entries()
                         if e.provenance.get("cache") == "hit")
        # a stored decode record against the phase's own measurement of
        # the same signature (the cache off: the registered entry only
        # notes the dispatch, the outer counter sees all of it)
        store = compile_cache.CacheStore(str(cache_dir))
        recs = [store.get(k) for k, _, _ in store.entries()]
        rec = next(r["payload"] for r in recs
                   if r["meta"]["extra"]["site"] == "generate_decode")
        _rt_flags(compile_cache_dir="")
        dec = CachedDecoder(model, max_batch=srv.max_batch,
                            page_size=srv.page_size,
                            pages_per_seq=srv.pages_per_seq,
                            max_positions=srv.max_seq_len, device="cuda")
        b = srv.max_batch
        with torch.inference_mode():
            _, ana = xstats.measure(lambda: dec.decode(
                np.zeros(b, np.int64), np.zeros(b, np.int32),
                np.zeros(b, bool), np.zeros(b, np.int32),
                np.zeros_like(srv._tables), srv.kv.k, srv.kv.v),
                torch.device("cuda"))
        require(ana["flops"] == rec["flops"]
                and ana["kernel_flops"] == rec["kernel_flops"],
                f"runtime A: the stored decode record's FLOPs "
                f"{rec['flops']} against the phase's {ana['flops']}")
        out = {"replayed_fresh": fresh, "replay_s": replay_s,
               "replay_hits": hits,
               "traffic_hits": st2["hits"] - st1["hits"], "misses": 0,
               "first_token_s": {"cold": first["first_token_s"],
                                 "warm": ttft},
               "skipped_measurement_host_ms": skipped_ms,
               "decode_record_flops": rec["flops"],
               "scraped": scraped, "launches": launches}
        del srv, dec
    finally:
        _rt_flags(compile_cache_dir="")
        compile_cache.reset_default_cache()
    log("runtime A: cache: " + json.dumps(out))
    return out


def _rt_fault(model, seed, port) -> dict:
    """The shadow off, the tripwires on, FLAGS_profile_on_anomaly armed:
    NaN written into one page of one live request's K pool. The first
    decode that reads it records one non-finite anomaly of kind decode
    (one a note, as the reference counts), promoted into /tracez; exactly
    one capture appears in /profilez (the rate limit holds back the rest);
    the other streams are the clean run's token for token; the leak check
    stays clean."""
    import torch
    from paddle_tpu_torch.observability import stepprof, xstats
    from paddle_tpu_torch.serving.generation import GenerationServer
    cfg = model.config
    prompts = _rt_prompts(cfg, seed + 63, RT_FAULT_REQUESTS, system=False)

    def engine(name):
        return GenerationServer(model, max_batch=RT_FAULT_REQUESTS,
                                page_size=PAGE_SIZE, device="cuda",
                                name=name, start=False)

    def submit(srv):
        return [srv.submit_generate(p, max_new_tokens=RT_FAULT_NEW,
                                    temperature=0.0) for p in prompts]

    old = _rt_flags(numerics_shadow_rate=0.0, numerics_sample_rate=1.0,
                    profile_on_anomaly=True)
    # a step profiler that never flags a straggler: the capture this drill
    # gates must be the numerics anomaly's, not a slow step's (the process
    # profiler's baselines come from every earlier phase)
    prev_prof = stepprof.set_default_profiler(
        stepprof.StepProfiler(min_samples=10 ** 9))
    try:
        clean = engine("rt-clean")
        with clean:
            futs = submit(clean)
            clean.start()
            want = [f.result(timeout=600) for f in futs]
        xstats.default_profile_ring().clear()
        _, doc0 = _rt_http_json(port, "/numericsz")
        srv = engine("rt-fault")
        futs = submit(srv)
        with torch.inference_mode():
            srv._admit_and_prefill()
            active = [s for s in srv._slots if s is not None]
            require(len(active) == RT_FAULT_REQUESTS,
                    f"runtime A: fault: {len(active)} admitted")
            victim = min(active, key=lambda s: s.slot)
            page = victim.pages[0]
            srv.kv.k[0][page].fill_(float("nan"))
            srv._decode_iteration(active)
        code, doc1 = _rt_http_json(port, "/numericsz")
        an0, an1 = doc0["anomalies"], doc1["anomalies"]
        first = {
            "nonfinite": an1["by_reason"].get("nonfinite", 0)
            - an0["by_reason"].get("nonfinite", 0),
            "decode": doc1["serving"]["decode"]["anomalies"]
            - doc0["serving"].get("decode", {}).get("anomalies", 0)}
        last = an1["last"]
        require(code == 200 and first == {"nonfinite": 1, "decode": 1}
                and last["kind"] == "decode"
                and last["reason"] == "nonfinite",
                f"runtime A: fault: after the first decode {first}, last "
                f"{last}")
        trace_id = last["trace_id"]
        code, tz = _rt_http_json(port, f"/tracez?trace_id={trace_id}")
        spans = [s for t in tz["traces"] for s in t["spans"]]
        require(code == 200 and any(
            s["name"] == "numerics::nonfinite" and s["status"] == "error"
            for s in spans),
            f"runtime A: fault: no promoted error span in /tracez: {spans}")
        with srv:
            srv.start()
            got = [f.result(timeout=600) for f in futs]
        xstats.wait_captures(30.0)
        code, ring = _rt_http_json(port, "/profilez")
        arts = ring["artifacts"]
        require(code == 200 and len(arts) == 1
                and arts[0]["reason"] == "anomaly"
                and arts[0]["trace_id"] == trace_id,
                f"runtime A: fault: /profilez artifacts {arts}")
        victim_i = [f is victim.req.future for f in futs].index(True)
        same = [got[i] == want[i] for i in range(RT_FAULT_REQUESTS)
                if i != victim_i]
        require(all(same), f"runtime A: fault: the other streams moved "
                           f"{same}")
        _, doc2 = _rt_http_json(port, "/numericsz")
        srv.clear_prefix_cache()
        leak = srv.leak_check()
        require(leak["ok"], f"runtime A: fault: leak check {leak}")
        out = {"victim": victim_i, "page": int(page),
               "anomalies_first_decode": first,
               "anomalies_run": doc2["serving"]["decode"]["anomalies"]
               - doc0["serving"].get("decode", {}).get("anomalies", 0),
               "capture": {k: arts[0][k] for k in ("id", "duration_ms",
                                                   "events", "bytes")},
               "victim_stream_same": got[victim_i] == want[victim_i]}
        log("runtime A: fault: " + json.dumps(out))
        return out
    finally:
        _rt_flags(**{k[len("FLAGS_"):]: v for k, v in old.items()})
        stepprof.set_default_profiler(prev_prof)
        xstats.wait_captures(30.0)


def _rt_leg_a(state, port) -> dict:
    import shutil
    import tempfile
    model = _model(state)
    out = {"direct": {}, "engine": {}}
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cc_")
    try:
        for kv in ("", "int8"):
            out["direct"][kv or "bf16"] = _rt_direct_gate(model, kv,
                                                          state["seed"])
            _release()
            eng = _rt_engine_run(model, kv, state["seed"], port,
                                 cache_dir=None if kv else cache_dir)
            _release()
            if not kv:
                eng["cache"].update(_rt_cache_replay(
                    model, state["seed"], port, cache_dir, eng))
                eng.pop("outs")
                _release()
            out["engine"][kv or "bf16"] = eng
    finally:
        _rt_flags(compile_cache_dir="")
        shutil.rmtree(cache_dir, ignore_errors=True)
    state.pop("model", None)
    del model
    _release()
    return out


def _rt_gauge(name, **labels):
    from paddle_tpu_torch.observability.registry import default_registry
    fam = default_registry().get(name)
    for lab, child in (fam.collect() if fam is not None else []):
        if all(lab.get(k) == v for k, v in labels.items()):
            return child.value
    return None


def _rt_capture_during(port, step, ids) -> tuple:
    """GET /profilez?duration_ms=RT_CAPTURE_MS on another thread while the
    training steps run: (status, chrome document, steps taken)."""
    import threading
    import torch
    got = {}

    def fetch():
        got["r"] = _rt_http_json(
            port, f"/profilez?duration_ms={RT_CAPTURE_MS}", timeout=120.0)

    t = threading.Thread(target=fetch, name="rt-profilez")
    t.start()
    n = 0
    while t.is_alive() or n == 0:
        step(ids, ids)
        torch.cuda.synchronize()
        n += 1
    t.join()
    return got["r"][0], got["r"][1], n


def _rt_step_turns(step, ids) -> dict:
    """The training step's ms (synchronised, median of 2 x RT_TIMED_STEPS)
    with the tripwires off and on, in turns (off, on, on, off); the step
    is left armed."""
    import torch
    ms = {True: [], False: []}
    for armed in (False, True, True, False):
        step._numerics_armed = armed
        for _ in range(RT_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids, ids)
            torch.cuda.synchronize()
            ms[armed].append((time.perf_counter() - t0) * 1e3)
    step._numerics_armed = True
    return {"tripwires": statistics.median(ms[True]),
            "off": statistics.median(ms[False])}


def _rt_leg_b(state, port) -> dict:
    """gpt3_1p3b(stacked=True, recompute="full") at b=2 s=2048, bf16 O2,
    AdamW, FLAGS_check_nan_inf on: the grad norm published one step late
    within RT_NORM_RTOL of the phase's own vector_norm of the step's
    gradients, finite fraction 1.0, 48/24/24 launches a step and 0 plain
    calls, the train_step entry's FLOPs per token within 15% of the hand
    formulas, paddle_mfu{kind="train"} in (0, 1). Leg C's capture runs on
    another thread during two more steps. Then the step's ms with and
    without the tripwires."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt3_1p3b
    from paddle_tpu_torch.observability import numerics
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    cfg = gpt3_1p3b(stacked=True, recompute="full")
    b, s = 2, 2048
    per_step = {"flash_fwd": cfg.num_layers * STACKED_FWD_PER_LAYER["full"],
                **{n: cfg.num_layers for n in cab.KERNELS}}
    old = _rt_flags(check_nan_inf=True)
    norms = []
    real = numerics.grad_stats

    def recording(grads, loss):
        # the phase's own norm of the same gradients (a patch local to
        # this leg): float32 norms of each, then of those
        norms.append(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads])))
        return real(grads, loss)

    model = opt = step = None
    try:
        model, opt, step = _train_parts(cfg, state["seed"])
        require(step._numerics_armed, "runtime B: tripwires not armed")
        ids = torch.from_numpy(np.random.RandomState(state["seed"] + 64)
                               .randint(0, cfg.vocab_size, (b, s))).cuda()
        numerics.grad_stats = recording
        _reset_counts()
        published, losses = [], []
        for i in range(RT_TRAIN_STEPS):
            losses.append(float(step(ids, ids)))
            torch.cuda.synchronize()
            published.append(_rt_gauge("paddle_numerics_grad_norm"))
        counts = _read_counts()
        numerics.grad_stats = real
        _require_launches("runtime B", counts, per_step, RT_TRAIN_STEPS)
        mine = [float(n) for n in norms]
        # after step i (synchronised), step i+1's note publishes step i's
        late = [(published[i], mine[i - 1])
                for i in range(1, RT_TRAIN_STEPS)]
        for got, want in late:
            require(got is not None and abs(got - want) <= RT_NORM_RTOL
                    * abs(want),
                    f"runtime B: published grad norm {got} against the "
                    f"step's {want}")
        frac = _rt_gauge("paddle_numerics_finite_fraction", kind="train")
        require(frac == 1.0, f"runtime B: grad finite fraction {frac}")
        # this step's entry: the tag, the batch and the parameters (an
        # earlier phase's model of the same shapes shares it)
        from paddle_tpu_torch.observability import xstats
        sig = [[list(shape), dt] for shape, dt in (
            (((0,), "tag:single"),) + xstats.signature_of([ids, ids])
            + xstats.signature_of(step._params))]
        code, execz = _rt_http_json(port, "/execz")
        ents = [e for e in execz["entries"]
                if e["site"] == "train_step" and e["signature"] == sig]
        require(code == 200 and len(ents) == 1,
                f"runtime B: /execz train_step entries {len(ents)} of "
                f"this step's signature")
        ana = ents[0]["analysis"]
        n_params = model.num_params()
        attn = 12 * cfg.num_layers * cfg.hidden_size * s
        per_token = ana["flops"] / (b * s)
        ratios = {"plain": per_token / (6 * n_params + attn),
                  "remat": per_token / (8 * n_params + 2 * attn)}
        require(min(abs(r - 1.0) for r in ratios.values()) <= RT_COST_TOL,
                f"runtime B: train_step FLOPs per token {per_token:.4e}, "
                f"ratios {ratios} to the hand formulas")
        mfu = _rt_gauge("paddle_mfu", kind="train")
        require(mfu is not None and 0.0 < mfu < 1.0,
                f"runtime B: paddle_mfu{{kind=train}} {mfu}")
        before = _rt_step_turns(step, ids)
        # leg C: a capture on another thread while steps run
        xstats.default_profile_ring().clear()
        code, doc, n_cap = _rt_capture_during(port, step, ids)
        require(code == 200 and isinstance(doc, dict),
                f"runtime C: /profilez capture answered {code}")
        names = " ".join(str(e.get("name", ""))
                         for e in doc.get("traceEvents", []))
        seen = {k: k in names for k in RT_TRAIN_KERNELS}
        require(all(seen.values()),
                f"runtime C: the capture lacks kernels: {seen}")
        code2, refused = _rt_http_json(port, "/profilez?duration_ms=100")
        code3, ring = _rt_http_json(port, "/profilez")
        require(code2 == 429 and code3 == 200
                and len(ring["artifacts"]) == 1,
                f"runtime C: second capture {code2}, ring {code3} "
                f"{ring.get('artifacts') if isinstance(ring, dict) else ''}")
        capture = {"status": code, "events": len(doc["traceEvents"]),
                   "steps_during": n_cap, "kernels_seen": seen,
                   "second_status": code2,
                   "artifact": {k: ring["artifacts"][0][k]
                                for k in ("id", "duration_ms", "bytes",
                                          "events")}}
        after = _rt_step_turns(step, ids)
        numerics.drain()
        out = {"steps": RT_TRAIN_STEPS, "losses": losses,
               "published_vs_phase_norm": late,
               "finite_fraction": frac, "launches": counts["launches"],
               "flops_per_token": per_token, "cost_ratios": ratios,
               "analysis": ana, "mfu_gauge": mfu,
               "step_ms": before, "step_ms_after_capture": after,
               "capture": capture}
        log("runtime B: " + json.dumps(
            {k: v for k, v in out.items() if k != "analysis"}))
        log(f"runtime B: train_step entry {json.dumps(ana)}")
        return out
    finally:
        numerics.grad_stats = real
        _rt_flags(**{k[len("FLAGS_"):]: v for k, v in old.items()})
        model = opt = step = None
        _release()


def _rt_fp16_drill(state) -> dict:
    """PARITY_LAYERS layers of gpt3_1p3b in float16 O2 under GradScaler,
    FLAGS_check_nan_inf on: one good step, then the scale forced to
    OVERFLOW_SCALE (as the recipe phase forces it) for two steps whose
    gradients overflow. The tripwire reads the good step finite, classes
    each overflowed step as a non-finite train anomaly with a finite loss
    (the reference's classes), and publishes the loss scale after each
    step's schedule: 2^15, then OVERFLOW_SCALE, then its half."""
    import numpy as np
    import torch
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models import gpt3_1p3b
    from paddle_tpu_torch.observability import numerics
    cfg = gpt3_1p3b(num_layers=RT_F16_LAYERS)
    old = _rt_flags(check_nan_inf=True)
    model = opt = step = None
    try:
        scaler = GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=OVERFLOW_DECR_EVERY)
        model, opt, step = _train_parts(cfg, state["seed"] + 65, "float16",
                                        scaler)
        ids = torch.from_numpy(np.random.RandomState(state["seed"] + 65)
                               .randint(0, cfg.vocab_size, (2, 2048))).cuda()
        _reset_counts()
        rows = []
        for i in range(3):
            if i == 1:
                scaler.load_state_dict({"scale": OVERFLOW_SCALE,
                                        "incr_count": 0, "decr_count": 0})
            a0 = numerics.numericsz_payload()["anomalies"]
            loss = float(step(ids, ids))
            numerics.drain()
            doc = numerics.numericsz_payload()
            a1 = doc["anomalies"]
            t = doc["train"]
            rows.append({"loss": loss, "found_inf": bool(scaler._found_inf),
                         "grad_finite_fraction": t["grad_finite_fraction"],
                         "grad_norm": t["grad_norm"],
                         "loss_finite": t["loss_finite"],
                         "loss_scale": t["loss_scale"],
                         "new_anomalies": a1["total"] - a0["total"],
                         "last": a1["last"] if a1["total"] > a0["total"]
                         else None})
        counts = _read_counts()
        good, bad1, bad2 = rows
        require(good["grad_finite_fraction"] == 1.0
                and good["new_anomalies"] == 0
                and good["loss_scale"] == 2.0 ** 15,
                f"runtime B: fp16 good step {good}")
        for row, scale in ((bad1, OVERFLOW_SCALE),
                           (bad2, OVERFLOW_SCALE / 2)):
            last = row["last"] or {}
            require(row["found_inf"] and row["grad_finite_fraction"] < 1.0
                    and row["new_anomalies"] == 1
                    and last.get("kind") == "train"
                    and last.get("reason") == "nonfinite"
                    and last["detail"]["loss_finite"] is True
                    and row["loss_scale"] == scale,
                    f"runtime B: fp16 overflowed step {row}, want scale "
                    f"{scale}")
        out = {"layers": RT_F16_LAYERS, "steps": rows,
               "launches": counts["launches"]}
        log("runtime B: fp16 drill " + json.dumps(out, default=str))
        return out
    finally:
        _rt_flags(**{k[len("FLAGS_"):]: v for k, v in old.items()})
        model = opt = step = None
        _release()


def _rt_collectors(port) -> dict:
    """Leg C's collectors: the allocated-bytes series at a scrape equals
    torch.cuda.memory_allocated() read beside it; paddle_build_info carries
    the card's name and the kernel library's hash; the goodput ledger's
    compile category is above 0 after the build."""
    import torch
    from paddle_tpu_torch.observability import goodput
    from paddle_tpu_torch.ops import _build
    dev = torch.cuda.current_device()
    before = torch.cuda.memory_allocated(dev)
    code, text = _http_get(port, "/metrics")
    after = torch.cuda.memory_allocated(dev)
    require(code == 200, f"runtime C: /metrics {code}")
    samples = _parse_prometheus(text)
    key = ("paddle_device_memory_bytes",
           f'{{device="cuda:{dev}",stat="bytes_in_use"}}')
    scraped = samples.get(key)
    require(scraped is not None and before == after == scraped,
            f"runtime C: scraped allocated bytes {scraped}, "
            f"memory_allocated {before} / {after}")
    name = torch.cuda.get_device_name(dev)
    info = [lab for (n, lab) in samples if n == "paddle_build_info"]
    require(len(info) == 1 and f'device="{name}"' in info[0]
            and f'kernels="{_build.library_hash()}"' in info[0],
            f"runtime C: paddle_build_info {info}")
    compile_s = goodput.default_ledger().report()["categories_s"]["compile"]
    require(_build.build_seconds() > 0 and compile_s > 0,
            f"runtime C: goodput compile {compile_s} s after a build of "
            f"{_build.build_seconds()} s")
    out = {"allocated_bytes": scraped, "build_info": info[0],
           "goodput_compile_s": compile_s,
           "build_s": _build.build_seconds()}
    log("runtime C: collectors " + json.dumps(out))
    return out


def _rt_leg_d(state, port) -> dict:
    """The canary on the card equals its golden twin; two thread replicas
    of float32 ERNIE-base (jit.save) behind the router, each sweeping
    every RT_CANARY_PERIOD_S; one replica's device checksum corrupted by a
    patch local to this leg (its sweep's result XORed with 1 on that
    replica's canary thread): that replica's /readyz answers 503 and its
    breaker opens, RT_D_REQUESTS requests all go to the other replica with
    0 failures, and the router's merged /execz, /numericsz and /profilez
    answer 200 with both replicas."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_base)
    from paddle_tpu_torch.observability import numerics
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.static import InputSpec
    res = numerics.run_device_canary(record=False)
    require(res["ok"] and res["got"] == numerics.canary_reference(),
            f"runtime D: device canary {res}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_runtime_"))
    apps, backends, router, rapp = [], [], None, None
    real = numerics.canary_sweep
    try:
        cfg = ernie_base(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
        model = ErnieForSequenceClassification(
            cfg, num_classes=2, device="cuda", seed=state["seed"]).eval()
        prefix = str(work / "ernie")
        jit.save(model, prefix, input_spec=[
            InputSpec([None, None], "int64", "input_ids")])
        del model
        _release()
        for i in range(2):
            be = fleet.PredictorBackend(prefix, max_batch_size=8,
                                        seq_buckets=[RT_D_SEQ],
                                        warmup_mode="none",
                                        name=f"rt-d{i}")
            be.warmup()
            app = fleet.ReplicaApp(be).start()
            fleet.arm_canary(be, app, period_s=RT_CANARY_PERIOD_S,
                             name=f"rt-d{i}")
            backends.append(be)
            apps.append(app)
        router = fleet.FleetRouter({i: a.url for i, a in enumerate(apps)},
                                   name="rt_d", health_interval_ms=50)
        rapp = fleet.RouterApp(router, host="127.0.0.1").start()
        require(router.wait_ready(2, timeout=60),
                f"runtime D: replicas not ready {router.replica_states()}")
        bad_thread = "numerics-canary-rt-d0"

        def corrupted(device):
            got = real(device)
            if threading.current_thread().name == bad_thread:
                got = got ^ 1       # one flipped bit of the checksum
            return got

        numerics.canary_sweep = corrupted
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = {s["replica"]: s for s in router.replica_states()}["0"]
            if not st["ready"] and st["breaker"]["state"] == "open":
                break
            time.sleep(0.05)
        ready_code, ready = _rt_http_json(int(apps[0].port), "/readyz")
        st = {s["replica"]: s for s in router.replica_states()}
        require(ready_code == 503 and ready.get("corrupt")
                and st["0"]["breaker"]["state"] == "open"
                and st["1"]["ready"],
                f"runtime D: corrupt replica not fenced: {ready_code} "
                f"{ready} "
                f"{st}")
        batches0 = [be.server.metrics.snapshot()["counters"]["batches"]
                    for be in backends]
        launches0 = ca.launches
        rng = np.random.RandomState(state["seed"] + 66)
        futs = [router.submit([rng.randint(1, cfg.vocab_size,
                                           (1, RT_D_SEQ))])
                for _ in range(RT_D_REQUESTS)]
        failures = 0
        for f in futs:
            try:
                out = f.result(timeout=120)
                require(np.all(np.isfinite(np.asarray(out[0]))),
                        "runtime D: a non-finite response")
            except SmokeFailure:
                raise
            except Exception:  # noqa: BLE001 - counted below
                failures += 1
        torch.cuda.synchronize()
        batches = [be.server.metrics.snapshot()["counters"]["batches"]
                   - b0 for be, b0 in zip(backends, batches0)]
        launches = ca.launches - launches0
        require(failures == 0 and batches[0] == 0 and batches[1] > 0
                and launches == cfg.num_layers * batches[1],
                f"runtime D: {failures} failures, batches by replica "
                f"{batches}, {launches} flash launches")
        merged = {}
        for path in ("/execz", "/numericsz", "/profilez"):
            code, doc = _rt_http_json(rapp.port, path)
            n = (doc["fleet"] if "fleet" in doc else doc)["replicas_merged"]
            require(code == 200 and n == 2,
                    f"runtime D: merged {path} {code}, {n} replicas")
            merged[path] = n
        corrupt = _rt_http_json(rapp.port, "/numericsz")[1]["fleet"][
            "corrupt_replicas"]
        require(corrupt == ["0"], f"runtime D: corrupt replicas {corrupt}")
        out = {"device_canary": res, "requests": RT_D_REQUESTS,
               "failures": failures, "batches_by_replica": batches,
               "launches": {"flash_fwd_f32": launches},
               "readyz": [ready_code, ready], "merged_replicas": merged,
               "corrupt_replicas": corrupt,
               "corruption": "the sweep's checksum XORed with 1 on the "
                             "replica's canary thread"}
        log("runtime D: " + json.dumps(out))
        return out
    finally:
        numerics.canary_sweep = real
        if rapp is not None:
            rapp.stop()
        if router is not None:
            router.shutdown()
        for app in apps:
            app.stop()
        for be in backends:
            be.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        _release()


def phase_runtime(state):
    """The runtime and numerics plane on the card (legs A-D)."""
    import torch
    from paddle_tpu_torch.observability import httpd
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    srv = httpd.start_telemetry_server(port=0, host="127.0.0.1")
    port = int(srv.port)
    out = {"leg_a": _rt_leg_a(state, port)}
    # leg B's capture comes before the fault's, so its step times before
    # the capture follow no profiler session of this phase
    out["leg_b"] = _rt_leg_b(state, port)
    out["leg_a"]["fault"] = _rt_fault(_model(state), state["seed"], port)
    state.pop("model", None)
    _release()
    out["fp16"] = _rt_fp16_drill(state)
    out["leg_c"] = _rt_collectors(port)
    out["leg_d"] = _rt_leg_d(state, port)
    code, execz = _rt_http_json(port, "/execz")
    sites = set(execz["sites"])
    require(code == 200 and set(RT_SITES) <= sites,
            f"runtime C: /execz sites {sorted(sites)}")
    torch.cuda.synchronize()
    a = out["leg_a"]["engine"]
    warm = a["bf16"]["cache"]["launches"]     # leg A's warm engine
    out["launches"] = {
        "flash_fwd": sum(r["launches"]["flash_fwd"] for r in a.values())
        + out["leg_b"]["launches"]["flash_fwd"] + warm["flash_fwd"],
        "flash_bwd_dq": out["leg_b"]["launches"]["flash_bwd_dq"],
        "flash_bwd_dkv": out["leg_b"]["launches"]["flash_bwd_dkv"],
        "paged_attention": a["bf16"]["launches"]["paged_attention"]
        + warm["paged_attention"],
        "paged_attention_int8": a["int8"]["launches"]["paged_attention"],
        "flash_fwd_f32": out["leg_d"]["launches"]["flash_fwd_f32"],
        "f16": out["fp16"]["launches"]}
    out["execz_sites"] = sorted(sites)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = state.get("smi")
    state["runtime"] = out
    log(f"runtime: {out['seconds']:.1f} s ({state.get('smi')})")



# ---------------------------------------------------------------- mesh
MESH_MPS = (2, 4)            # leg A's tensor-parallel degrees
MESH_F32_LAYERS = 4          # the float32 copy's depth (full width)
MESH_F32_STEPS = 32          # its greedy decode steps
MESH_REQUESTS = 8            # the served requests a run
MESH_NEW = 32                # their new tokens
MESH_DP_LAYERS = 2           # leg B: gpt3_1p3b's width at this depth
MESH_DP_STEPS = 3
MESH_DP_BATCH = 4
MESH_DP_SEQ = 2048
MESH_DP_TIMEOUT_S = 300.0


def _slots(mp):
    """``mp`` slots on the one card."""
    import torch
    from paddle_tpu_torch.distributed.mesh_utils import build_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    return build_mesh({"mp": mp}, devices=[dev] * mp)


def _mesh_pool_check(k, v, mp, heads, head_dim, tag):
    """Every pool shard is its own contiguous ``[pages, page, heads/mp,
    head_dim]`` tensor (int8 scales ``[pages, page, heads/mp]``)."""
    from paddle_tpu_torch.distributed.mesh_utils import MeshTensor
    leaves = []

    def walk(p):
        if isinstance(p, (list, tuple)):
            for x in p:
                walk(x)
        else:
            leaves.append(p)
    walk((k, v))
    for leaf in leaves:
        require(isinstance(leaf, MeshTensor) and len(leaf.shards) == mp,
                f"{tag}: a pool leaf is not placed on {mp} slots")
        for t in leaf.shards:
            want = (leaf.shape[0], PAGE_SIZE, heads // mp)
            ok = tuple(t.shape[:3]) == want and t.is_contiguous()
            if t.ndim == 4:
                ok = ok and t.shape[3] == head_dim
            require(ok, f"{tag}: pool shard {tuple(t.shape)} "
                        f"(contiguous {t.is_contiguous()}), want "
                        f"{want} + [{head_dim}]")
    return len(leaves)


def _mesh_run(model, mp, kv, ids, lens, tables, extra, plan, feed):
    """The unsharded model's comparison, re-run through a decoder over
    ``mp`` slots with the same forced tokens: (logits per step, stats)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import CachedDecoder
    from paddle_tpu_torch.serving.mesh import ServingMesh
    b, pps = tables.shape
    cfg = model.config
    tag = f"mesh A mp={mp} {kv or 'bf16'}"
    mesh = _slots(mp) if mp > 1 else None
    dec = CachedDecoder(model, max_batch=b, page_size=PAGE_SIZE,
                        pages_per_seq=pps, kv_dtype=kv, device="cuda",
                        mesh=mesh)
    k, v = ServingMesh(mesh).place_pools(
        *model.init_kv_pools(1 + b * pps, PAGE_SIZE, kv or None))
    stats = {"pool_leaves": (_mesh_pool_check(
        k, v, mp, cfg.num_heads, cfg.hidden_size // cfg.num_heads, tag)
        if mp > 1 else 0)}
    plain0, f0 = cpa.plain_calls, ca.plain_calls
    paged0 = dict(cpa.launches_by_kernel)
    torch.cuda.synchronize()
    flash0 = ca.launches
    t0 = time.perf_counter()
    last, k, v = dec.prefill(ids, lens, tables, k, v)
    torch.cuda.synchronize()
    stats["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    stats["prefill_flash_launches"] = ca.launches - flash0
    outs = [last.float().cpu()]
    ctx = lens.copy()
    decode_ms, decode_paged = [], []
    for step, what in enumerate(plan):
        before = sum(cpa.launches_by_kernel.values())
        t0 = time.perf_counter()
        logits, k, v, ctx = _model_step(dec, what, feed[step], ctx, tables,
                                        k, v, extra)
        torch.cuda.synchronize()
        if what == "decode":
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            decode_paged.append(sum(cpa.launches_by_kernel.values())
                                - before)
        outs.append(logits.float().cpu())
    stats.update(
        decode_ms=float(np.median(decode_ms)),
        decode_paged_launches=decode_paged,
        paged_launches_by_kernel=_launch_delta(cpa.launches_by_kernel,
                                               paged0),
        plain_calls=cpa.plain_calls - plain0 + ca.plain_calls - f0)
    del k, v, dec
    torch.cuda.empty_cache()
    return outs, stats


def _mesh_refs(state, model):
    """The model phase's references, or (in a run without that phase)
    the same runs made here."""
    import torch
    refs = state.get("mesh_refs", {})
    if set(refs) >= {"", "int8"}:
        return refs
    from paddle_tpu_torch.models import GPTForCausalLM
    cfg = model.config
    ids, lens, tables, extra = _model_inputs(cfg, state["seed"])
    m32 = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    m32.eval()
    for kv, plan in (("", ["decode"] * 8), ("int8", MESH_PLAN8)):
        runs, feed, _ = _model_runs(model, m32, ids, lens, tables, kv, plan,
                                    extra, tag="mesh refs")
        refs[kv] = _mesh_ref(runs, feed)
        del runs
    del m32
    torch.cuda.empty_cache()
    state["mesh_refs"] = refs
    return refs


def _mesh_steps(state, model) -> dict:
    """Leg A's step comparisons: the model phase's plan through decoders
    over 2 and 4 slots, bf16 and int8 pools, against the unsharded
    decoder by the rounding-floor rule."""
    ids, lens, tables, extra = _model_inputs(model.config, state["seed"])
    refs = _mesh_refs(state, model)
    layers = model.config.num_layers

    def dist(a, ref):
        return max_abs_err(a, ref) / float(ref.float().std())

    out = {}
    for kv, plan in (("", ["decode"] * 8), ("int8", MESH_PLAN8)):
        ref = refs[kv]
        floors = [dist(p, r) for p, r in zip(ref["plain"], ref["plain_f32"])]
        limit = BF16_FLOOR_FACTOR * max(floors)
        rows = {}
        for mp in (1,) + MESH_MPS:
            outs, stats = _mesh_run(model, mp, kv, ids, lens, tables, extra,
                                    plan, ref["feed"])
            to_f32 = [dist(a, r) for a, r in zip(outs, ref["plain_f32"])]
            to_one = [dist(a, r) for a, r in zip(outs, ref["kernels"])]
            tag = f"mesh A mp={mp} {kv or 'bf16'} pools"
            log(f"{tag}: prefill {stats['prefill_ms']:.1f} ms, decode step "
                f"{stats['decode_ms']:.2f} ms; max |mesh - plain f32| / std "
                + " ".join(f"{x:.4f}" for x in to_f32)
                + f" (limit {limit:.4f}); max |mesh - unsharded| / std "
                + " ".join(f"{x:.4f}" for x in to_one))
            require(all(bool(a.isfinite().all()) for a in outs),
                    f"{tag}: non-finite logits")
            require(max(to_f32) <= limit,
                    f"{tag}: {max(to_f32):.4f} x std from float32, beyond "
                    f"{BF16_FLOOR_FACTOR} x the plain path's "
                    f"{max(floors):.4f}")
            require(stats["plain_calls"] == 0,
                    f"{tag}: {stats['plain_calls']} plain calls")
            if mp > 1:
                require(stats["prefill_flash_launches"] == layers * mp,
                        f"{tag}: {stats['prefill_flash_launches']} flash "
                        f"launches in the prefill, not {layers * mp}")
                require(min(stats["decode_paged_launches"]) >= layers * mp,
                        f"{tag}: paged launches per decode step "
                        f"{stats['decode_paged_launches']} < layers x mp = "
                        f"{layers * mp}")
            rows[mp] = dict(stats, max_to_f32_over_std=max(to_f32),
                            max_to_unsharded_over_std=max(to_one),
                            floor_over_std=max(floors))
        out[kv or "bf16"] = rows
    return out


def _mesh_f32(state) -> dict:
    """A float32 copy at full width and MESH_F32_LAYERS layers, greedy
    over MESH_F32_STEPS decode steps unsharded and over 2 slots: the same
    tokens, logits within F32_MODEL_LIMIT x std."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.serving.generation import CachedDecoder
    from paddle_tpu_torch.serving.mesh import ServingMesh
    m4 = GPTForCausalLM(gpt3_1p3b(num_layers=MESH_F32_LAYERS), device="cuda",
                        dtype=torch.float32, seed=state["seed"]).eval()
    ids, lens, tables, _ = _model_inputs(m4.config, state["seed"])
    b, pps = tables.shape
    runs = {}
    for mp in (1, 2):
        mesh = _slots(mp) if mp > 1 else None
        dec = CachedDecoder(m4, max_batch=b, page_size=PAGE_SIZE,
                            pages_per_seq=pps, device="cuda", mesh=mesh)
        k, v = ServingMesh(mesh).place_pools(
            *m4.init_kv_pools(1 + b * pps, PAGE_SIZE))
        logits, k, v = dec.prefill(ids, lens, tables, k, v)
        toks, outs, ctx = [], [logits.cpu()], lens.copy()
        for _ in range(MESH_F32_STEPS):
            tok = logits.argmax(-1).cpu().numpy()
            toks.append(tok)
            logits, k, v = dec.decode(tok, ctx, np.ones(b, bool), ctx + 1,
                                      tables, k, v)
            ctx = ctx + 1
            outs.append(logits.cpu())
        runs[mp] = (np.stack(toks), outs)
        del k, v, dec
    dist = max(max_abs_err(a, r) / float(r.std())
               for a, r in zip(runs[2][1], runs[1][1]))
    same = bool((runs[1][0] == runs[2][0]).all())
    log(f"mesh A float32 {MESH_F32_LAYERS} layers mp=2: greedy tokens over "
        f"{MESH_F32_STEPS} steps equal {same}; max |mesh - unsharded| / std "
        f"{dist:.2e} (limit {F32_MODEL_LIMIT})")
    require(same, "mesh A float32: greedy tokens differ from the unsharded "
                  "decoder's")
    require(dist <= F32_MODEL_LIMIT,
            f"mesh A float32: logits {dist:.2e} x std from the unsharded "
            f"decoder's")
    del m4
    torch.cuda.empty_cache()
    return {"tokens_equal": same, "max_err_over_std": dist,
            "steps": MESH_F32_STEPS, "layers": MESH_F32_LAYERS}


def _mesh_serve(model, mesh, prompts, seed, name):
    """One engine over ``mesh``: the runtime phase's traffic (self-
    speculation on), its streams, time to first token, and the engine's
    state at the end."""
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    plain0 = cpa.plain_calls
    srv = GenerationServer(model, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                           draft_model=model, spec_k=RT_SPEC_K,
                           device="cuda", mesh=mesh, name=name, start=False)
    try:
        futs = [srv.submit_generate(p, max_new_tokens=MESH_NEW,
                                    temperature=0.0, seed=seed + i)
                for i, p in enumerate(prompts[:-1])]
        t0 = time.perf_counter()
        srv.start()
        _wait_for(lambda: len(futs[0].tokens()) >= 1, 900,
                  "the first request's first token", tag="mesh A")
        ttft = time.perf_counter() - t0
        first = futs[0].result(timeout=900)
        futs.append(srv.submit_generate(prompts[-1], max_new_tokens=MESH_NEW,
                                        temperature=0.0))
        streams = [first] + [f.result(timeout=900) for f in futs[1:]]
        snap = srv.metrics_snapshot()
        sz = srv.statusz()
        leak = srv.kv.leak_check()
        fp = srv.decoder.fingerprint()
    finally:
        srv.shutdown(drain=True)
    return {"streams": streams, "ttft_s": ttft, "prefix": snap["prefix"],
            "leak": leak, "statusz": sz, "fingerprint": fp,
            "plain_calls": cpa.plain_calls - plain0}


def _mesh_serving(state, model) -> dict:
    """``GenerationServer(mesh=)`` at mp=2, twice with the same seeds."""
    from paddle_tpu_torch.compile_cache import mesh_fingerprint
    from paddle_tpu_torch.serving.generation import GenerationServer
    prompts = _rt_prompts(model.config, state["seed"], MESH_REQUESTS)
    mesh = _slots(2)
    runs = [_mesh_serve(model, mesh, prompts, state["seed"], f"mesh-{i}")
            for i in range(2)]
    a, b = runs
    require(a["streams"] == b["streams"],
            "mesh A serving: the mp=2 engine's tokens differ on a rerun")
    for r in runs:
        require(r["leak"]["ok"], f"mesh A serving: leak check {r['leak']}")
        require(r["prefix"]["hits"] >= 1,
                f"mesh A serving: no prefix hit {r['prefix']}")
        require(r["plain_calls"] == 0,
                f"mesh A serving: {r['plain_calls']} plain paged calls")
        sec = r["statusz"].get("serving_mesh", {})
        per = sec.get("per_slot_kv_pool_bytes", [])
        require(sec.get("live") and len(per) == 2 and min(per) > 0,
                f"mesh A serving: /statusz mesh section {sec}")
    one = GenerationServer(model, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                           device="cuda", name="mesh-one", start=False)
    try:
        fp_one = one.decoder.fingerprint()
        mfp_one = mesh_fingerprint(one.decoder.serving_mesh
                                   .mesh_for_cache_key())
    finally:
        one.shutdown(drain=False)
    mfp = mesh_fingerprint(mesh)
    require(mfp != mfp_one and a["fingerprint"] != fp_one,
            "mesh A serving: the mesh's fingerprints equal the unsharded "
            "engine's")
    log(f"mesh A serving mp=2: {MESH_REQUESTS} requests x {MESH_NEW} new "
        f"tokens twice, equal; first token {a['ttft_s'] * 1e3:.1f} / "
        f"{b['ttft_s'] * 1e3:.1f} ms; prefix {a['prefix']}; statusz "
        f"{a['statusz']['serving_mesh']}; mesh fingerprint {mfp}")
    return {"equal_on_rerun": True, "ttft_ms": [r["ttft_s"] * 1e3
                                                for r in runs],
            "prefix": a["prefix"], "statusz": a["statusz"]["serving_mesh"],
            "mesh_fingerprint": mfp, "unsharded_mesh_fingerprint": mfp_one}


def _grad_dist(a: dict, ref: dict) -> float:
    """||a - ref|| / ||ref|| over every parameter's gradient."""
    import torch
    num = den = 0.0
    for name, r in ref.items():
        d = a[name].float() - r.float()
        num += float(torch.sum(d * d))
        den += float(torch.sum(r.float() * r.float()))
    return math.sqrt(num / den)


def _mesh_dp(state) -> dict:
    """Leg B: two ranks launched by the port's launcher train
    gpt3_1p3b's width at MESH_DP_LAYERS layers data-parallel on one card;
    the same steps are taken here on the whole batch."""
    import tempfile
    from types import SimpleNamespace

    import torch
    from paddle_tpu_torch.tools import dp_worker
    out_dir = tempfile.mkdtemp(prefix="mesh-dp-")
    argv = ["--out", out_dir, "--model", "1p3b", "--layers",
            str(MESH_DP_LAYERS), "--steps", str(MESH_DP_STEPS), "--batch",
            str(MESH_DP_BATCH), "--seq", str(MESH_DP_SEQ), "--amp", "O2",
            "--collectives"]
    t0 = time.perf_counter()
    before = set(_children())
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir",
         os.path.join(out_dir, "logs"),
         str(REPO / "paddle_tpu_torch" / "tools" / "dp_worker.py"), *argv],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=MESH_DP_TIMEOUT_S,
        # the ranks' first step unmeasured: xstats' first-dispatch
        # measurement is the runtime phase's business
        env={**os.environ, "FLAGS_xstats_enable": "0"})
    launch_s = time.perf_counter() - t0
    logs = ""
    for r in range(2):
        with contextlib.suppress(OSError):
            logs += Path(out_dir, "logs", f"workerlog.{r}").read_text()[-3000:]
    require(proc.returncode == 0,
            f"mesh B: the launcher exited {proc.returncode}: "
            f"{proc.stdout[-2000:]} {logs}")
    left = sorted(set(_children()) - before)
    require(not left, f"mesh B: child processes outlive the job: {left}")
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        tag = f"mesh B rank {r['rank']}"
        require(r["backend"] == "gloo", f"{tag}: backend {r['backend']}")
        bad = [k for k, ok in r["collectives"].items() if not ok]
        require(not bad, f"{tag}: collectives differ from numpy: {bad}")
        require(all(r["equal_after_each_step"])
                and len(r["equal_after_each_step"]) == MESH_DP_STEPS,
                f"{tag}: parameters differ across ranks after the steps "
                f"{r['equal_after_each_step']}")
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            require(r["launches"][k] > 0 and r["plain_calls"][k] == 0,
                    f"{tag}: {k} launched {r['launches'][k]}, plain "
                    f"{r['plain_calls'][k]}")
    args = SimpleNamespace(model="1p3b", layers=MESH_DP_LAYERS,
                           steps=MESH_DP_STEPS, batch=MESH_DP_BATCH,
                           seq=MESH_DP_SEQ, amp="O2")
    grad_dp = torch.load(os.path.join(out_dir, "grad0.pt"))
    _, g_one, losses_one = dp_worker.single_process(args, "cuda")
    args.steps = 0
    _, g_plain, _ = dp_worker.single_process(args, "cuda", use_kernels=False)
    args.amp = "none"
    _, g_f32, _ = dp_worker.single_process(args, "cuda", use_kernels=False)
    torch.cuda.empty_cache()
    floor = _grad_dist(g_plain, g_f32)
    d_dp, d_one = _grad_dist(grad_dp, g_f32), _grad_dist(g_one, g_f32)
    log(f"mesh B: launcher {launch_s:.1f} s, backend "
        f"{ranks[0]['backend']}; step s rank 0 "
        + " ".join(f"{x:.3f}" for x in ranks[0]["step_s"])
        + f"; losses {ranks[0]['losses']} (one process "
        f"{[round(x, 5) for x in losses_one]}); gradient at the initial "
        f"weights ||. - f32|| / ||f32||: averaged {d_dp:.5f}, one process "
        f"{d_one:.5f}, bf16 plain floor {floor:.5f} (limit "
        f"{BF16_FLOOR_FACTOR} x); launches a rank {ranks[0]['launches']}")
    require(d_dp <= BF16_FLOOR_FACTOR * floor,
            f"mesh B: the averaged gradient is {d_dp:.5f} from float32, "
            f"beyond {BF16_FLOOR_FACTOR} x the floor {floor:.5f}")
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"backend": ranks[0]["backend"], "launcher_s": launch_s,
            "step_s": [r["step_s"] for r in ranks],
            "losses": ranks[0]["losses"], "losses_one_process": losses_one,
            "grad_to_f32": d_dp, "one_process_grad_to_f32": d_one,
            "grad_floor": floor, "launches": launches,
            "collectives": ranks[0]["collectives"]}


def phase_mesh(state):
    """Multi-device, part 1 on one card: leg A, ``gpt3_1p3b`` bf16 served
    tensor-parallel over 2 and 4 slots of the card (step comparisons
    against the unsharded decoder, a float32 copy's greedy tokens, the
    engine with self-speculation); leg B, two launched data-parallel
    ranks."""
    import torch
    t0 = time.perf_counter()
    model = _model(state)
    out = {"steps": _mesh_steps(state, model)}
    out["f32"] = _mesh_f32(state)
    out["serving"] = _mesh_serving(state, model)
    state.pop("model", None)
    state.pop("mesh_refs", None)
    _release()
    out["leg_a_s"] = time.perf_counter() - t0
    out["dp"] = _mesh_dp(state)
    torch.cuda.synchronize()
    steps = out["steps"]
    # the main path's launches: the sharded decoders' (bf16 and int8
    # pools), leg B's ranks'
    out["launches"] = {
        "flash_fwd": sum(steps[kv][mp]["prefill_flash_launches"]
                         for kv in steps for mp in MESH_MPS)
        + out["dp"]["launches"]["flash_fwd"],
        "flash_bwd_dq": out["dp"]["launches"]["flash_bwd_dq"],
        "flash_bwd_dkv": out["dp"]["launches"]["flash_bwd_dkv"],
        "paged_attention": sum(sum(steps["bf16"][mp][
            "paged_launches_by_kernel"].values()) for mp in MESH_MPS),
        "paged_attention_int8": sum(sum(steps["int8"][mp][
            "paged_launches_by_kernel"].values()) for mp in MESH_MPS)}
    times = {mp: steps["bf16"][mp]["decode_ms"] for mp in (1,) + MESH_MPS}
    log("mesh A: decode step ms by mp (bf16 pools) "
        + json.dumps(times) + "; prefill (first token of 8 rows) ms "
        + json.dumps({mp: round(steps["bf16"][mp]["prefill_ms"], 1)
                      for mp in (1,) + MESH_MPS})
        + f"; served first token ms {out['serving']['ttft_ms']}")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = state.get("smi")
    state["mesh"] = out
    log(f"mesh: {out['seconds']:.1f} s (leg A {out['leg_a_s']:.1f} s) "
        f"({state.get('smi')})")


def kernels_line(state) -> dict:
    """One row per kernel. Launches are the main paths' own counts: the
    forward's over the engine's run, the serving run, the training window
    and the stacked decoder's serving runs and training windows together;
    the paged kernel's over the engine's run and the stacked engine's run
    (bf16 pools) and, as its own entry, its int8 variant's over the serving
    run and the stacked engine's int8 run; the float32-query paged kernels
    (``paged_attention_f32``, and ``_f32_int8`` over int8 pools) over the
    model phase's float32 kernel runs and the serving phase's float32 copy,
    by kernel, timed at decode B=8 (the S=5 and S=300 windows in
    ``window_shapes``); the backward kernels' over the
    training windows (per-layer, stacked, and the recipe phase's input
    pipeline window). The float16 variants of the three flash kernels are
    entries of their own (``*_f16``), with the recipe phase's float16
    training window's launches and their times at the training shape.
    The families phase's bf16 runs (the GPT-2 sizes, BERT-base, the
    ERNIE-10B forward) count in the bf16 entries, and each flash entry
    lists its times at those configurations' shapes (``family_shapes``).
    The api and nn phases' Paddle-style scripts count their bf16 O2 steps
    in the bf16 entries and their float32 steps in the float32 ones, each
    entry listing its times at the script's shape (``api_shape``,
    ``nn_shape``); the hapi phase's ``Model.fit`` runs count the same way
    (its O2 run's evaluations run in float32). ``flash_fwd`` also lists its
    times at Sq != Sk (``cross_shapes``). The ops phase's scheduled engine
    run counts in ``flash_fwd`` and ``paged_attention`` (also apart, as
    ``ops_launches``), its InferenceServer leg in ``flash_fwd_f32``. The
    fleet phase's thread replicas count in ``flash_fwd_f32`` and
    ``paged_attention_f32``, its worker processes' launches (dumped at
    their exit) in ``flash_fwd_f32``. The runtime phase's engine runs
    count in ``flash_fwd`` and the paged entries (bf16 and int8 pools),
    its training steps in ``flash_fwd`` and the bf16 backward entries, its
    float16 drill in the ``*_f16`` entries and its canary replicas in
    ``flash_fwd_f32`` (each also apart, as ``runtime_launches``). The
    inference phase's bf16 server
    run counts in
    ``flash_fwd`` (its
    times at the Predictor's shape and the server's: ``serving_shapes``),
    its float32 server run in ``flash_fwd_f32``, the float32 forward's
    entry, timed at the Predictor's shape and at the server's (with the
    float32 training parities' launches: the train, stacked and BERT
    parity runs through the kernels). The float32 backward kernels are
    ``flash_bwd_dq_f32`` and ``flash_bwd_dkv_f32``, with those parities'
    launches, timed at the training shape and at BERT-base's, with
    ``ms_before``: the parent tree's kernel timed in turns with this one in
    this run (``--parent``; null without it)."""
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    eng, train = state["engine"]["launches"], state["train"]["launches"]
    serving = state["serving"]
    st = state["stacked"]
    st_serve = st["serving"]["serve"]
    st_train = [t["launches"] for p in STACKED_POLICIES
                for t in st["train"][p]["turns"]] + \
        [st["train_long"]["launches"], state["recipe"]["pipeline"]["launches"]]
    fp16 = state["recipe"]["fp16"]["launches"]
    fam = state["families"]
    fam_train = [r["launches"] for r in fam["gpt"]] + \
        [fam["bert"]["launches"]]
    fam_fwd = sum(t["flash_fwd"] for t in fam_train) + \
        fam["ernie"]["ernie_3_0_10b"]["launches"]["flash_fwd"]
    infer = state["inference"]["server"]
    api, nn = state["api"], state["nn"]
    api_o2, api_f32 = api["o2"]["launches"], api["f32_launches"]
    nn_o2, nn_f32 = nn["o2"]["launches"], nn["f32_launches"]
    hapi_b, hapi_f = state["hapi"]["launches"]["bf16"], \
        state["hapi"]["launches"]["f32"]
    ops_eng = state["ops"]["engine"]["launches"]
    ops_infer = state["ops"]["inference_server"]["launches"]
    fleet_a = state["fleet"]["thread"]
    fleet_a_flash = fleet_a["launches"]["flash_fwd"]
    fleet_b_flash = sum(state["fleet"]["process"]["worker_launches"]
                        .values())
    el = state["elastic"]
    el_b = _add_launches(el["north_star"]["launches"],
                         el["drills"]["launches"])
    el_f = el["fit"]["launches_f32"]
    rt = state["runtime"]["launches"]
    mesh = state["mesh"]["launches"]

    def api_row(dtype, part, kname=None, phase=api):
        """The flash kernel at a Paddle script's shape (the api phase's, or
        the nn phase's)."""
        r = phase["kernel_rows"][dtype][part]
        if kname is None:
            keys = ("case", "ms", "bound_ms", "bound_by", "plain_ms",
                    "library_ms", "max_abs_err")
            return {k: r[k] for k in keys if k in r}
        return {"case": r["case"], "ms": r[f"{kname}_ms"],
                "bound_ms": r[f"{kname}_bound_ms"],
                "bound_by": r[f"{kname}_bound_by"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"],
                "library_bwd_ms": r["library_bwd_ms"]}
    out = []
    for name, mod, row, launches, by in (
            ("flash_fwd", ca, state["flash_main"],
             eng["flash_fwd"] + serving["launches"]["flash_fwd"]
             + train["flash_fwd"]
             + sum(r["launches"]["flash_fwd"] for r in st_serve.values())
             + sum(t["flash_fwd"] for t in st_train) + fam_fwd
             + infer["bfloat16"]["launches"] + api_o2["flash_fwd"]
             + nn_o2["flash_fwd"] + hapi_b["flash_fwd"]
             + ops_eng["flash_fwd"] + el_b["flash_fwd"] + rt["flash_fwd"]
             + mesh["flash_fwd"],
             None),
            ("paged_attention", cpa, state["paged_main"],
             eng["paged_attention"]
             + st_serve["bfloat16"]["launches"]["paged_attention"]
             + ops_eng["paged_attention"] + rt["paged_attention"]
             + mesh["paged_attention"],
             state["engine"]["paged_launches_by"]),
            ("paged_attention_int8", cpa, state["paged_int8_main"],
             serving["launches"]["paged_attention"]
             + st_serve["int8"]["launches"]["paged_attention"]
             + rt["paged_attention_int8"] + mesh["paged_attention_int8"],
             serving["paged_launches_by"])):
        entry = {"name": name, "route": "cuda", "source": mod.SOURCE,
                 "replaces": mod.REPLACES, "launches": launches,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": row["case"]}
        entry["runtime_launches"] = rt[name]
        entry["mesh_launches"] = mesh[name]
        if name in ("flash_fwd", "paged_attention"):
            entry["ops_launches"] = ops_eng[name]
        if name == "flash_fwd":
            entry["elastic_launches"] = el_b[name]
        if name == "paged_attention":
            entry["ops_launches_by_kernel"] = \
                state["ops"]["engine"]["paged_launches_by_kernel"]
        if by is not None:
            entry["launches_by_kind"] = by
            src = state["engine"] if name == "paged_attention" else serving
            entry["launches_by_kernel"] = src["paged_launches_by_kernel"]
            entry["kernel"] = row["kernel"]
            for key in ("ms_turns", "parent_ms", "kernel_ms_by_name"):
                if key in row:
                    entry[key] = row[key]
        if name == "flash_fwd":
            train_row, long_row = state["flash_train"], state["flash_long"]
            entry.update({"tflops": row["tflops"],
                          "train_shape": train_row["case"],
                          "train_shape_ms": train_row["ms"],
                          "train_shape_library_ms": train_row["library_ms"],
                          "train_shape_bound_ms": train_row["bound_ms"],
                          "long_shape": long_row["case"],
                          "long_shape_ms": long_row["ms"],
                          "long_shape_library_ms": long_row["library_ms"],
                          "long_shape_plain_ms": long_row["plain_ms"],
                          "long_shape_bound_ms": long_row["bound_ms"],
                          "long_shape_max_abs_err": long_row["max_abs_err"],
                          "family_shapes": [
                              {k: r[k] for k in ("case", "ms", "bound_ms",
                                                 "bound_by", "plain_ms",
                                                 "library_ms", "max_abs_err",
                                                 "row_err", "tflops")}
                              for r in state["flash_family_rows"]],
                          "serving_shapes": [
                              {k: r[k] for k in ("case", "ms", "bound_ms",
                                                 "bound_by", "plain_ms",
                                                 "library_ms", "max_abs_err",
                                                 "row_err", "tflops")}
                              for r in state["flash_bf16_infer_rows"]],
                          "api_shape": api_row("bfloat16", "fwd"),
                          "nn_shape": api_row("bfloat16", "fwd",
                                              phase=nn),
                          "cross_shapes": [
                              {k: r[k] for k in ("case", "ms", "bound_ms",
                                                 "bound_by", "plain_ms",
                                                 "library_ms", "max_abs_err",
                                                 "row_err", "tflops")}
                              for r in state["flash_cross_rows"]]})
        out.append(entry)
    # the float32-query paged kernels (decode and window), over float and
    # int8 pools: the model phase's float32 kernel runs (and its lockstep
    # run over int8 pools) and the serving phase's float32 copy
    check = state["model_check"]
    accept = serving["greedy_acceptance_by_model_and_pools"]
    f32_keys_paged = ("case", "kernel", "ms", "ms_turns", "parent_ms",
                      "bound_ms", "bound_by", "fma_bound_ms", "plain_ms",
                      "library_ms", "max_abs_err", "kernel_ms_by_name")
    for name, kv, parts in (
            ("paged_attention_f32", "model",
             (check["paged_calls_vs_plain"]["float32"]["launches_by_kernel"],
              accept["float32/float32"]["paged_launches_by_kernel"],
              fleet_a["paged_launches_by_kernel"])),
            ("paged_attention_f32_int8", "int8",
             (check["int8"]["paged_calls_vs_plain"]["float32"][
                 "launches_by_kernel"],
              check["int8"]["f32_lockstep_launches_by_kernel"],
              accept["float32/int8"]["paged_launches_by_kernel"]))):
        by_kernel = {}
        for part in parts:
            for k, n in part.items():
                by_kernel[k] = by_kernel.get(k, 0) + n
        row, *windows = state["paged_f32_rows"][kv]
        out.append({"name": name, "route": "cuda", "source": cpa.SOURCE,
                    "replaces": cpa.REPLACES,
                    "launches": sum(by_kernel.values()),
                    "launches_by_kernel": by_kernel,
                    "max_abs_err": max(r["max_abs_err"] for r in
                                       state["paged_f32_rows"][kv]),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "shape": row["case"],
                    "kernel": row["kernel"],
                    "ms_before": (statistics.mean(row["parent_ms"])
                                  if "parent_ms" in row else None),
                    **{k: row[k] for k in ("ms_turns", "parent_ms",
                                           "kernel_ms_by_name",
                                           "fma_bound_ms")
                       if k in row},
                    "window_shapes": [{k: r[k] for k in f32_keys_paged
                                       if k in r} for r in windows]})
    # the float32 kernels: the inference phase's float32 server run (the
    # Predictor's default precision) and the float32 training parities
    f32_train = {}
    for parity in (state["train"]["parity"], st["parity"],
                   fam["bert_parity"]):
        f32_train = _add_launches(f32_train, parity["f32_launches"])
    f32_keys = ("case", "ms", "parent_ms", "bound_ms",
                "bound_by", "fma_bound_ms", "plain_ms", "library_ms",
                "max_abs_err", "lse_err", "ref64_err", "plain_ref64_err",
                "tflops")
    row, *served = state["flash_f32_infer_rows"]
    out.append({"name": "flash_fwd_f32", "route": "cuda",
                "source": ca.SOURCE, "replaces": ca.REPLACES,
                "launches": infer["float32"]["launches"]
                + f32_train["flash_fwd"] + api_f32["flash_fwd"]
                + nn_f32["flash_fwd"] + hapi_f["flash_fwd"] + ops_infer
                + fleet_a_flash + fleet_b_flash + el_f["flash_fwd"]
                + rt["flash_fwd_f32"],
                "launches_by_path": {
                    "runtime_canary_replicas": rt["flash_fwd_f32"],
                    "inference_server": infer["float32"]["launches"],
                    "ops_inference_server": ops_infer,
                    "fleet_thread_replicas": fleet_a_flash,
                    "fleet_worker_processes": fleet_b_flash,
                    "training_parities": f32_train["flash_fwd"],
                    "paddle_api_script": api_f32["flash_fwd"],
                    "paddle_nn_script": nn_f32["flash_fwd"],
                    "paddle_model_fit": hapi_f["flash_fwd"],
                    "elastic_model_fit": el_f["flash_fwd"]},
                "api_shape": api_row("float32", "fwd"),
                "nn_shape": api_row("float32", "fwd", phase=nn),
                "max_abs_err": max(r["max_abs_err"] for r in
                                   state["flash_f32_infer_rows"]),
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "fma_bound_ms": row["fma_bound_ms"],
                "library_ms": row["library_ms"],
                "tflops": row["tflops"], "shape": row["case"],
                "serving_shapes": [{k: r[k] for k in f32_keys if k in r}
                                   for r in served],
                "causal_d128_shapes": [
                    {k: r[k] for k in f32_keys if k in r}
                    for r in (state["flash_f32_main"],
                              state["flash_f32_train"])]})
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        entry = {"name": f"{name}_f32", "route": "cuda",
                 "source": cab.SOURCE, "replaces": cab.REPLACES[name],
                 "launches": f32_train[name] + api_f32[name]
                 + nn_f32[name] + hapi_f[name] + el_f[name],
                 "launches_by_path": {"training_parities": f32_train[name],
                                      "paddle_api_script": api_f32[name],
                                      "paddle_nn_script": nn_f32[name],
                                      "paddle_model_fit": hapi_f[name],
                                      "elastic_model_fit": el_f[name]},
                 "api_shape": api_row("float32", "bwd", name),
                 "nn_shape": api_row("float32", "bwd", name, phase=nn)}
        for prefix, r in (("", state["bwd_f32_main"]),
                          ("bert_shape_", state["bwd_f32_bert"])):
            entry.update({
                f"{prefix}shape": r["case"],
                f"{prefix}max_abs_err": max(r[f"{g}_max_abs_err"]
                                            for g in grads),
                f"{prefix}ms": r[f"{name}_ms"],
                f"{prefix}tflops": r[f"{name}_tflops"],
                # one plain call computes dq, dk and dv together
                f"{prefix}plain_ms": r["plain_ms"],
                f"{prefix}bound_ms": r[f"{name}_bound_ms"],
                f"{prefix}bound_by": r[f"{name}_bound_by"],
                f"{prefix}library_ms": r["library_ms"],
                f"{prefix}library_bwd_ms": r["library_bwd_ms"],
                f"{prefix}delta_ms": r["delta_ms"],
                # the parent tree's kernel timed in turns with this one
                # (--parent), else null
                f"{prefix}ms_before": (
                    statistics.mean(r[f"{name}_parent_ms"])
                    if f"{name}_parent_ms" in r else None)})
            for key in ("ms_turns", "parent_ms"):
                if f"{name}_{key}" in r:
                    entry[f"{prefix}{key}"] = r[f"{name}_{key}"]
        for key in ("ref64_err", "plain_ref64_err"):
            entry[key] = state["bwd_f32_main"][key]
        out.append(entry)
    row, long_row = state["bwd_main"], state["bwd_long"]
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        launches = train[name] + sum(t[name] for t in st_train) + \
            sum(t[name] for t in fam_train) + api_o2[name] + nn_o2[name] \
            + hapi_b[name] + el_b[name] + rt[name] + mesh[name]
        out.append({"name": name, "route": "cuda", "source": cab.SOURCE,
                    "replaces": cab.REPLACES[name], "launches": launches,
                    "elastic_launches": el_b[name],
                    "runtime_launches": rt[name],
                    "mesh_launches": mesh[name],
                    "max_abs_err": max(row[f"{g}_max_abs_err"]
                                       for g in grads),
                    "ms": row[f"{name}_ms"],
                    "tflops": row[f"{name}_tflops"],
                    # one plain call computes dq, dk and dv together
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row[f"{name}_bound_ms"],
                    "bound_by": row[f"{name}_bound_by"],
                    # fwd+bwd of scaled_dot_product_attention, beside the
                    # port's fwd+dq+dkv; its backward alone (dq, dk, dv)
                    # beside the two kernels and the wrapper's delta
                    "library_ms": row["library_ms"],
                    "port_fwd_bwd_ms": row["port_fwd_bwd_ms"],
                    "library_bwd_ms": row["library_bwd_ms"],
                    "delta_ms": row["delta_ms"],
                    "shape": row["case"],
                    "long_shape": long_row["case"],
                    "long_shape_ms": long_row[f"{name}_ms"],
                    "long_shape_bound_ms": long_row[f"{name}_bound_ms"],
                    "long_shape_plain_ms": long_row["plain_ms"],
                    "long_shape_library_bwd_ms": long_row["library_bwd_ms"],
                    "api_shape": api_row("bfloat16", "bwd", name),
                    "nn_shape": api_row("bfloat16", "bwd", name, phase=nn),
                    "long_shape_max_abs_err": max(
                        long_row[f"{g}_max_abs_err"] for g in grads),
                    "family_shapes": [
                        {"case": r["case"], "ms": r[f"{name}_ms"],
                         "bound_ms": r[f"{name}_bound_ms"],
                         "bound_by": r[f"{name}_bound_by"],
                         "plain_ms": r["plain_ms"],
                         "library_bwd_ms": r["library_bwd_ms"],
                         "library_ms": r["library_ms"],
                         "max_abs_err": max(r[f"{g}_max_abs_err"]
                                            for g in grads),
                         "grad_err": max(r[f"{g}_grad_err"] for g in grads),
                         "tflops": r[f"{name}_tflops"]}
                        for r in state["bwd_family_rows"]]})
    row, long_row = state["flash_f16_train"], state["flash_f16_long"]
    out.append({"name": "flash_fwd_f16", "route": "cuda",
                "source": ca.SOURCE, "replaces": ca.REPLACES,
                "launches": fp16["flash_fwd"] + rt["f16"]["flash_fwd"],
                "runtime_launches": rt["f16"]["flash_fwd"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "tflops": row["tflops"], "shape": row["case"],
                "batch8_ms": state["flash_f16_main"]["ms"],
                "batch8_library_ms": state["flash_f16_main"]["library_ms"],
                "batch8_bound_ms": state["flash_f16_main"]["bound_ms"],
                "long_shape": long_row["case"],
                "long_shape_ms": long_row["ms"],
                "long_shape_library_ms": long_row["library_ms"],
                "long_shape_bound_ms": long_row["bound_ms"]})
    row, long_row = state["bwd_f16_main"], state["bwd_f16_long"]
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        out.append({"name": f"{name}_f16", "route": "cuda",
                    "source": cab.SOURCE, "replaces": cab.REPLACES[name],
                    "launches": fp16[name] + rt["f16"][name],
                    "runtime_launches": rt["f16"][name],
                    "max_abs_err": max(row[f"{g}_max_abs_err"]
                                       for g in grads),
                    "ms": row[f"{name}_ms"], "tflops": row[f"{name}_tflops"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row[f"{name}_bound_ms"],
                    "bound_by": row[f"{name}_bound_by"],
                    "library_ms": row["library_ms"],
                    "library_bwd_ms": row["library_bwd_ms"],
                    "delta_ms": row["delta_ms"], "shape": row["case"],
                    "long_shape": long_row["case"],
                    "long_shape_ms": long_row[f"{name}_ms"],
                    "long_shape_bound_ms": long_row[f"{name}_bound_ms"],
                    "long_shape_library_bwd_ms":
                        long_row["library_bwd_ms"]})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a tree holding another paddle_tpu_torch/csrc "
                         "(e.g. the parent commit, unpacked with git "
                         "archive): its paged kernel, its flash forward "
                         "(the timed float32 rows) and its float32 "
                         "backward pair (the training and BERT shapes) are "
                         "timed in turns with this tree's in the kernels "
                         "phase")
    ap.add_argument("--ops-probe-child", default=None,
                    choices=sorted(OPS_PROBE_CONFIGS),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    faulthandler.enable(file=sys.stderr, all_threads=True)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - {"opsprobe"}
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this "
              "script measures the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the paddle_tpu_torch package is not next "
              f"to this script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.ops_probe_child:
        print("OPSPROBE " + json.dumps(
            _ops_probe_child(args.seed, args.ops_probe_child)), flush=True)
        return 0
    state = {"seed": args.seed, "parent": args.parent}
    fns = {"card": phase_card, "build": phase_build,
           "kernels": phase_kernels, "tiny": phase_tiny,
           "model": phase_model,
           "engine": phase_engine, "serving": phase_serving,
           "train": phase_train, "stacked": phase_stacked,
           "recipe": phase_recipe, "families": phase_families,
           "inference": phase_inference, "api": phase_api, "nn": phase_nn,
           "hapi": phase_hapi, "ops": phase_ops, "fleet": phase_fleet,
           "elastic": phase_elastic, "runtime": phase_runtime,
           "mesh": phase_mesh, "opsprobe": phase_opsprobe}
    t_start = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fns[name](state)
        except Exception as e:  # noqa: BLE001 - report the phase, exit 1
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: FAIL in phase {name}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 1
        secs = time.perf_counter() - t0
        state.setdefault("phase_s", {})[name] = round(secs, 2)
        log(f"== phase {name} done in {secs:.1f} s")
    state["total_s"] = time.perf_counter() - t_start
    log(f"total {state['total_s']:.1f} s; phases (s) "
        + json.dumps(state["phase_s"]))
    summary = {k: state[k] for k in ("smi", "build_s", "tiny", "model_check",
                                     "decode_profile", "engine", "serving",
                                     "spec_profile", "train", "stacked",
                                     "recipe", "families", "inference",
                                     "api", "nn", "hapi", "ops", "fleet",
                                     "elastic", "runtime", "mesh",
                                     "opsprobe",
                                     "total_s",
                                     "phase_s")
               if k in state}
    if all(k in state for k in ("flash_main", "engine", "serving", "train",
                                "stacked", "recipe", "families",
                                "inference", "api", "nn", "hapi", "ops",
                                "fleet", "elastic", "runtime", "mesh")):
        summary.update(kernels_line(state))
        print(json.dumps({"kernels": summary["kernels"]}), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_summary.json").write_text(json.dumps(summary, indent=1))
    log(state.get("smi", ""))
    _quiesce()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _quiesce() -> None:
    """Stop what the phases leave serving (the process-wide telemetry
    endpoint, background profile captures), synchronise the card, and log
    the live threads and child processes."""
    import threading
    import torch
    from paddle_tpu_torch.observability import httpd, xstats
    httpd.stop_telemetry_server()
    xstats.wait_captures(30.0)
    torch.cuda.synchronize()
    live = sorted(t.name for t in threading.enumerate()
                  if t is not threading.main_thread())
    log(f"exit: {len(live)} live threads {live}; child processes "
        f"{_children()}")


def _children() -> list:
    """The pids whose parent is this process (``/proc``)."""
    kids = []
    for task in Path(f"/proc/{os.getpid()}/task").glob("*/children"):
        with contextlib.suppress(OSError):
            kids += [int(x) for x in task.read_text().split()]
    return sorted(kids)


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
