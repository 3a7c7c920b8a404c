#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --only layout  # the layout phase alone (or
                                         # lm, train_lm or shard)

Phases, each printing one JSON line:

  device   the card, and `nvidia-smi`'s name and power limit;
  build    nvcc builds every kernel from `src/repro_torch/kernels/csrc`;
  kernels  every kernel against its plain PyTorch version on the card, at
           the serving shapes (B=8 and B=5, N in {16, 32, 48, 64}, F=26,
           H=96; the trained step-18 weights and random ones; all-masked
           lanes; out-of-range child indices; and a DQN train step's
           batch, B=64, N=64, F=19), with its time, the plain version's
           time and the card's bound for the same work at the serving and
           the DQN shape; then the encoder's backward kernel against its
           plain version (`ref.tree_cnn_fused_bwd_ref`) at the PPO shapes
           (24 and 32 trees, N=48), at B=8 and B=5 over N in {16, 32, 48,
           64} on step-18 and random weights, on trees with tied maxima
           and at the DQN shape:
           the 12 weight grads, gfeat and gmask each within BWD_ATOL +
           BWD_RTOL * |plain|, every case checked before any fails; the
           same inputs twice give bitwise-equal gradients; its time by
           CUDA events beside its bound and the plain version's, with its
           cluster size, blocks an SM and `cudaOccupancyMaxActiveClusters`;
  serve    the repo's default deployment (JOB-like db at scale 0.25, the
           16-query test split, step-18 weights, 8 async lanes, a 48-query
           open-loop stream at 2 qps) served on the card through the
           kernels and again on the CPU through the plain versions: the
           completions must be identical and every act_batch on the card
           must have launched the encoder kernel once;
  train    the training path at the same deployment: step 18's full
           state (parameters and both AdamW states), `train_agent(...,
           episodes=TRAIN_EPISODES, batch_size=8, seed=0)` lockstep on the
           card and again on the CPU through the plain versions. The
           first episode-batch's actions must be equal, the first
           update's losses within TRAIN_LOSS_RTOL, every leaf finite, and
           every PPO update on the card must have launched the forward
           kernel 1 + 2 * epochs times and called the backward 2 * epochs
           times (4 * epochs launches: per-tree and summing kernel);
           then two serial episodes on the card (`act(explore=True)`), a
           Checkpointer save of the trained state that restores to equal
           leaves; before all that, a fresh `AqoraAgent(meta, seed=0)`
           built on the card and on the CPU must be equal leaf for leaf;
  learn    the lifelong-learning loop at the same deployment from step
           18's full state: the serve's 48-query stream served exploring
           on 8 lanes under `make_online_loop` (a PPO update every 8
           completions on 8 replayed trajectories, a policy-store gate
           every 2 updates on the first 4 test queries, an adaptive
           curriculum), on the card and again on the CPU. Completions,
           learner stats (all but host seconds), gate verdicts and scores
           and curriculum promotions must be identical, the final serving
           state finite and within LEARN_LEAF_ATOL of the CPU's, and each
           update on the card must have launched the forward kernel
           1 + 2 * epochs times and the backward 4 * epochs times. The
           same stream served on the card with a shadow-mode store (no
           curriculum) must be bit-identical to learning off. The line
           gives ms an update and a gate, the learner's host share of the
           serve wall, the walls with learning on, shadow and off, and the
           smallest sampled top-1/top-2 margin;
  qos      a `LatencyPredictor` warm-started from the step-18 critic
           drives `QoSAdmission` (a gold tenant, weight 2, 40 s SLO; a
           bulk tenant rate-limited to 1.5 q/s, 300 s SLO; the standard
           ladder) on 8 EDF lanes over 2 x 24 queries, on the card and on
           the CPU: admissions, deferrals, rejections, degradations, hook
           budgets and completions identical, each prediction within
           QOS_PRED_RTOL of the CPU's (with its smallest relative distance
           from a rung), one forward launch per uncached prediction; then
           `fit_from_replay` (64 samples, batch 16, 2 epochs) on each
           side's learn-phase replay buffer from `default_rng(0)`: the
           same experiences, losses within FIT_LOSS_RTOL, one backward
           call (2 launches) per fit step, the serving critic untouched;
  control  the serving cell under every control plane, on the card and
           on the CPU: JOB-like db at scale 0.25 with a young movie_info
           (90% deleted, then ANALYZEd), the serve's 48-query stream with
           one growth delta of 24x movie_info's young rows after query 24;
           step 18's full state on 8 async lanes; bench_faults' `full`
           recovery arm (seeded chaos, retries, hedges against a
           `LatencyPredictor` warm-started from the step-18 critic, a
           breaker over the run's policy store); a tracer and an SLO
           watchdog (alerts unwired); the drift controller (threshold
           re-ANALYZE at CONTROL_REFRESH, refits of the predictor from a
           harvester's replay); plan memory and its superoptimizer on the
           watchdog's plan ledger. Completions, recovery, drift,
           plan-memory and superoptimizer stats, promotions, incidents,
           breaker trips and the trace export must be identical (the
           trace's fields from a card float, TRACE_FLOAT_KEYS, within
           CONTROL_PRED_RTOL; its host-clock fields: none; the stats'
           host-clock fields are left out), predictions within
           CONTROL_PRED_RTOL, refit losses within REFIT_LOSS_RTOL; one
           encoder launch per act_batch and per uncached prediction, none
           for a memoized hit, one forward and 2 backward launches per
           refit fit step. The card's run without the tracer and the
           watchdog must give the same completions bit for bit; the
           breaker's rollback on the card restores every committed tensor
           bit for bit; `serve.obs.export` and `serve.obs.report`'s
           selftests pass on the card under build/. The line gives the
           walls, the tracer's host cost, ms per prediction and refit,
           the superoptimizer's host seconds and each compared float's
           smallest relative distance from its threshold;
  gen      bench_generalize's serving world (`sample_world(202,
           family="person", scale=0.07, ...)`, 72 queries) served by a
           fresh seeded agent on 4 lanes under the world's fault injector
           and a retry ladder, greedy and then exploring (each on a
           freshly sampled world), on the card and on the CPU: completions
           and table versions identical, log-probabilities within TOL,
           one encoder launch per act_batch;
  ablate   the paper's comparison surface at the ablation experiment's
           deployment (`experiments/ablations.py`: the ExtJOB-like db at
           scale 0.4, `make_workload("extjob", n_train=120,
           n_test_per_template=2, seed=7)`: F=19, 10 tables, the trimmed
           node bucket 32, 64 for the FCNN; hidden 96): (a) a fresh
           `AqoraAgent` of each of the LSTM, FCNN and QueryFormer encoders
           on the card and on the CPU, equal leaf for leaf;
           `train_agent(episodes=ABLATE_EPISODES, batch_size=8, seed=0)`
           on each (first batch equal, first losses within
           TRAIN_LOSS_RTOL, every leaf finite); the CPU's trained state on
           the card and greedy `evaluate` of the 24 test queries on each
           (actions, latencies, failures identical; the smallest top-2
           margin printed); ms an act_batch and a PPO update; (b) the
           `DQNAgent` through `train_agent(agent=dqn,
           episodes=DQN_EPISODES)`, serial, on each: the episodes before
           the first train step identical, that step's loss within
           DQN_LOSS_RTOL, one forward launch a greedy act, two forward
           launches and one backward call a train step (B=64, N=64), the
           smallest Q margin; (c) `main_experiment.run_bench("extjob",
           episodes=ABLATE_EPISODES, batch_size=8)` on each, results under
           build/: Spark, Lero and AutoSteer rows identical but for their
           wall-clock fields, AQORA's first episode-batch identical, the
           smallest Lero and AutoSteer score margins and both walls.
           Episode counts are cut (the experiments train 300-400
           episodes); widths are not. Every case is checked first;
  ops      the `kernels.ops` path at full model widths from the reference's
           configs (src/repro/configs): `mha_flash` at qwen3-8b prefill,
           decode, a 4-query suffix and fp32 and at gemma2-27b's
           sliding-window layer in prefill and decode,
           `selective_scan_fused` at falcon-mamba-7b and at jamba-1.5-large's
           Mamba layer, `tree_conv_batch` at the AQORA encoder's two layer
           shapes on step-18 weights.
           Each call must launch its kernel exactly once and agree with
           the kernel's plain version on the card, |kernel - plain| <=
           atol + rtol * |plain| (ATTENTION_CASES gives the attention
           cases' limits, atol times the std of v; the scan's are 1e-4
           for y and for its final
           state h_last, the tree conv's 1e-5);
           every case is checked before any fails. The line gives each
           case's error and the share of its limit it takes, its kernel's
           time, the plain version's, the card's bound, the special-function
           floor of its exps (`sfu_ms`: exps over 16 a clock on each SM at
           the card's top SM clock) and, where one SDPA call computes the
           same function (every qwen3-8b case), that call's time
           (gemma2-27b's two cases: a compiled `flex_attention` with the
           softcap as its score_mod and the sliding-window causal block
           mask, timed after its compile once its output is within the
           case's limits of the plain version; if it is not, or cannot
           run, the row says why). The scan
           and tree-conv rows add the kernel's own time by torch.profiler
           (`device_ms`); the scan rows also time the whole
           `selective_scan_fused` call (`op_ms`) and count its device
           kernels under torch.profiler, which must be one.
           Then the backward kernels (ATTENTION_BWD_CASES at qwen3-8b's
           train_lm shape and gemma2-27b's sliding-window layer,
           SCAN_BWD_CASES at falcon-mamba-7b's train_lm and ops shapes),
           each through its ops function's autograd Function with a
           seeded cotangent: one forward and two backward launches; every
           gradient within its limits (ATTN_BWD_LIMITS, SCAN_BWD_LIMITS)
           of the plain backward on the same inputs, output and
           cotangent; two planted faults (the plain backward without one
           query tile's or one head's cotangent, without the first 32
           channels' or the middle step's) outside those limits; a
           repeat bit-equal (the bf16 attention backward from the
           forward kernel's logsumexp, the scan's from its chunk
           states); the kernel's ms beside its bound, the previous
           design's ms (`BWD_MS_PREVIOUS`, not re-run), the plain
           backward's ms and,
           for qwen3-8b, SDPA's backward (forward plus backward less
           forward, a yardstick only; the backend its kernels name), for
           gemma2-27b a compiled `flex_attention`'s backward (its
           gradients held to the plain backward at the case's limits
           first). The bf16 attention and scan forward rows add the
           time with the logsumexp or the chunk states written
           (`ms_with_lse`, `ms_with_states`), as training calls them.

After the ops phase, the `train_profile` line: the backward kernel's
device time by torch.profiler at the PPO and DQN shapes, and one PPO
update under torch.profiler (device busy time by kernel, idle share);
then the `ablate_profile` line: each ablation encoder's device kernels
and device ms for one greedy act_batch of its first training batch.
These readings come after the ops phase's own, which then are the first
in the process.

Then the `rng` phase, the seeded build through the threefry kernel
(`kernels/threefry.py`, csrc/threefry.cu): qwen3-8b at full width and
depth (8.19 B fp32 draws, 32.8 GB) from `lm.init_params(prng_key(0))`,
the reference's `init_params(PRNGKey(0))`, one launch a drawn leaf.
Three 2^16-element slices of every leaf (the first key's first, the
middle key's middle, the last key's last) must equal the plain version
(`ref.random_normal_ref`, on the CPU) bit for bit, 0 mismatched words;
two planted faults (one element an ulp off; the plain version with one
Threefry rotation constant wrong) must be refused by the same check.
The line gives the build's seconds, the full draw's kernel time (CUDA
events, the kernel relaunched into the build's leaves), the plain
version's on the card, `torch.Tensor.normal_`'s on the same leaves (it
draws other numbers) and two bounds, each the larger of the output's
bytes at 3.35 TB/s and an issue time of instructions a draw, one a clock
on each of an SM's 4 schedulers at the card's top SM clock: the
function's operations a draw (`work.THREEFRY_DRAW`, an FMA as one: the
kernels line's bound) and the compiled kernel's instructions on its
common path (`cuobjdump -sass`). Then the Gumbel kernel alone at a
sampled decode step's (B, V) (8 rows of qwen3-8b's 151,936 logits): its
noise against the plain version on the CPU, 0 mismatched words, its time
(CUDA events), the plain version's on the card and the same two bounds;
no one PyTorch call draws Gumbel noise.

Then the `lm` phase, the LM serving path (`launch.serve.BatchedServer`)
at the published configs (src/repro_torch/configs), at full width, one
model after another (LM_CELLS): qwen3-8b (36 attention layers, every one
through flash_attention), falcon-mamba-7b (64 Mamba layers, every
prefill through mamba_scan), gemma2-27b (46 layers, sliding window and
softcap on half of them, a tied 256,000-row head), whisper-tiny (4
logical decoder layers of self- and cross-attention at head width 64,
and its 4-layer bidirectional encoder over 1500 frames),
llama-3.2-vision-90b (30 of its 100 layers: tanh-gated cross-attention
over 1600 patch embeddings every 5th), llama4-scout (12 of its 48
layers: MoE 16 x top-1 plus a shared expert, NoPE global layers through
the kernel, chunked layers on torch's dense path), minicpm3-4b (62
layers of MLA, whose v head width differs from its q/k width: torch's
attention, no kernel launch), qwen1.5-4b (40 layers of full MHA with QKV
bias) and dbrx-132b (8 of its 40 layers: MoE 16 x top-4, GQA groups of
6), the cuts named in each row's `reduced`. Weights come from
`BatchedServer(seed=0)`:
prng_key(0) through the threefry kernel (one launch a drawn leaf),
drawn as the bf16 serving copy, so that the build's peak is the serving
copy's size (within LM_BUILD_SLACK_GB), and three 2^16-element slices of
every drawn leaf equal to the plain version's bit for bit. Each serves 8
prompts of 128 tokens (default_rng(0), in [2, vocab)) and 32 greedy
tokens; one `generate` must launch flash_attention once a kernel-route
attention layer a step (and once an encoder layer) and mamba_scan once a
Mamba layer, exactly (1188 at qwen3-8b, 64 at falcon-mamba-7b, 0 at
minicpm3-4b, 1320 at qwen1.5-4b, 264 at dbrx-132b). The
first call of each attention kind (causal, window, bidirectional) at the
prefill and at the decode steps reading 129 and 160 keys, and the first
bidirectional call at each query length (whisper's encoder, the cross
layers at the prefill and at a decode step; llama-vision's from one more
prefill and decode step over a seeded memory: its server feeds zeros),
and the scan's y and h_last at the prefill, are held to the plain
versions on the card at the ops phase's limits (ATTN_BF16 by the keys a
row sees; an attention call's atol scaled by the std of its v), and two
planted faults at the same calls (`planted_faults`, by the call's mask
and length) must fall outside the same limit. gemma2-27b serves one
more greedy generate of 2 prompts of 6144 tokens and 8 tokens, where its
window cuts keys, with its calls at the prefill (the last 1024 query
rows) and the first and last decode steps held the same way. The first
superblocks (at least LM_CPU_LAYERS layers) of the same weights serve 2
prompts of 32 tokens and 4 decode steps on the card and, copied, on the
CPU, with the cross-attention's memory (whisper: its frames) from a seed
and llama-vision's gates at LM_CPU_XGATE, an MoE layer on the card
(llama4's, dbrx's) taking the CPU's experts (the smallest router top-2
margin printed),
each step sampled as a generate samples (the same keys on both sides,
the Gumbel noise from the kernel and from the plain version, which must
be equal bit for bit) and the CPU's sampled tokens fed to both: every
logit within LM_LOGIT_RTOL of the CPU's largest, greedy tokens equal
wherever the top-2 margin exceeds twice that (the smallest such margin
printed), sampled tokens equal wherever the top-2 margin of logits plus
noise exceeds twice the largest logit error (every margin printed). One
sampled `generate` (seed LM_SAMPLE_SEED) on the full model must launch
the Gumbel kernel once a decode step, its first and last steps' noise
equal to the plain version's bit for bit.
The line gives prefill and decode seconds and tok/s of a warm
`generate`, the median ms of a decode step beside its bound (the serving
copy's weights a step reads over 3.35 TB/s), the last LM_PROFILED steps
under torch.profiler (device busy ms, idle share, time by kernel; null
if the profiler returned no device events), the device ms a step spends
copying k and v out of the cache for the kernel, the build's seconds and
peak and the serving copy's and the phase's peak device memory.
Every check runs before any fails. It runs after every other
torch.profiler reading.

Then the `train_lm` phase, the LM training path (`launch.train`'s
train step: `lm.loss_fn` with remat, autograd, AdamW) on the card, each
model built from prng_key(0) through the threefry kernel and freed
before the next, each at its published width (TRAIN_LM_CELLS), cut in
depth only where fp32 params, grads and both moments (16 B a parameter)
and the step's transients, counted on `meta` by
`launch.dryrun.count_train`, would not fit the card:
qwen3-8b at 12 of its 36 layers (3.56 B parameters, 57 GB of state), 4
steps on 4 x 1024 tokens; falcon-mamba-7b at 32 of its 64 layers (3.64
B, 58.2 GB; 36 layers count 74.6 GB), 3 steps on 2 x 512 tokens;
gemma2-27b at 4 of its 46 layers (two local-global superblocks, 55.1 GB
of state) on 1 x 6144 tokens, where its 4096 window cuts keys, in
2048-token CE chunks (TRAIN_LAYOUT); whisper-tiny whole on 8 x 448
tokens and the driver's frames (4 encoder layers over 1500 frames,
cross-attention of 448 queries over them; its layer-0 check and its
card-against-CPU run read seeded, row-distinct frames from
`seeded_source` instead); minicpm3-4b whole (62 layers
of MLA, 65.2 GB of state: no kernel launch) and qwen1.5-4b whole (40
layers of MHA, 20 heads of 128 with QKV bias, 63.2 GB of state) on 2 x
512; 3 steps each;
batches from `SyntheticLMPipeline(seed=0)`,
lr 3e-4 on the driver's cosine. Each step must launch flash_attention
(or mamba_scan) exactly twice a layer, the forward and the remat
re-forward (an encoder layer's too), and its backward kernels exactly
twice a layer (one backward call), and nothing else of the four; every
loss must be finite; the steps' peak is printed beside the step's
`count_train` and, where that count is at least TRAIN_PEAK_GATE_GB, must
lie within LAYOUT_PEAK_RATIO of it.
Before the steps, layer 0's superblock (after the whole encoder at
whisper, whose cross layer reads it), forward and backward, through
the kernels' autograd Functions is held against the same superblock
through the plain versions (`Tap`): the output and every gradient within
TRAIN_LAYER_TOL (gemma2-27b within its own TRAIN_LAYER_TOL_AT), each
kernel call's output at the ops phase's limits
and the gradients its backward kernels return at theirs (against the
plain backward on the call's inputs, output and cotangent); two planted
faults (one element of the call's output, one of the gradient it
returns) must take more than TRAIN_FAULT_SHARE times their limits; and
the first TRAIN_CPU_LAYERS layers, copied, through the cell's schedule
on the card and on the CPU, every step (gemma2-27b's first of 3,
qwen1.5-4b's first 2: TRAIN_CPU_STEPS) (each step's loss within
TRAIN_CPU_LOSS_RTOL, the first gradient norm within
TRAIN_CPU_GNORM_RTOL; each side's seconds by part, with the CPU's
intra-op threads). After the steps, the cells of TRAIN_PLAIN_HOLD
(qwen3-8b, qwen1.5-4b) are built again
from their seed and run the same steps on the same batches with the
plain versions in place of the kernels, forward and backward: each
loss within TRAIN_PLAIN_LOSS_RTOL of the kernels' run, and no kernel
launched. The line gives ms a step (median after the first),
tokens/s, peak GB, the last step under torch.profiler (device busy ms,
idle share, top kernels), and the step's model FLOPs and their share of
989 TFLOP/s. Then `launch.train.train` itself, twice: at the reduced
qwen1.5-4b (DRIVER), 6 steps with an asynchronous checkpoint, then a
restore that runs 2 more, under a temporary directory in build/, its
loss must fall; and at qwen1.5-4b's published widths (DRIVER_FULL), 3
steps on the 256 rows of 16 tokens its pipeline draws, no checkpoint:
every loss finite, exactly 80 flash_attention and 80
flash_attention_bwd launches each step, seconds a step and tokens/s,
and the run's peak within LAYOUT_PEAK_RATIO of its step's
`count_train`.

Then the `layout` phase, the layout re-optimizer and its tooling
(`launch.dryrun`, `launch.opanalysis`, `adapt/`, the policy-driven model
paths, `optim.compress.compressed_psum`) at the train_lm phase's qwen3-8b
cell (full width, LAYOUT_LAYERS layers, LAYOUT_B x LAYOUT_S tokens,
weights from prng_key(0) through the threefry kernel): one train step
counted op by op on the `meta` device and the same step counted on the
card, whose FLOPs, bytes and kernel records must be equal, and the
card's `torch.cuda.max_memory_allocated()` within LAYOUT_PEAK_RATIO of
the meta run's peak live bytes (the dry run's model FLOPs printed beside
`step_flops`); `LayoutReoptimizer.climb`
(LAYOUT_CLIMB_ITERS iterations, kind "train") on meta, each iteration's
hypothesis, predicted multipliers and terms, counted terms and verdict;
the
baseline, the climb's choice where it differs and the remat "dots" flip
run for real from the same weights and batches (a warm-up step and
LAYOUT_STEPS timed steps each: each step's loss within LAYOUT_LOSS_RTOL
of the baseline's where the layouts differ only in knobs that keep the
math, two flash_attention launches a layer a step (one with remat
"none") and two backward launches a layer a step, step ms and peak GB
beside the roofline's t_bound_s, and
whether the card orders them as the roofline does); MLA's absorbed
decode at minicpm3-4b, full width and depth, MLA_B requests over a
MLA_CACHE-token prefilled cache, with and without `mla_absorb` (logits
within MLA_LOGIT_RTOL of the largest, the step's ms both ways beside the
dry run's FLOP ratio); dbrx-132b's MoE block through the global,
block-local and `shard_map` (emulated at 16 x 16) dispatches, card
against CPU at the reduced width in fp32 with the CPU's routing imposed
(within MOE_RTOL of the largest |y|), and each dispatch's ms at full
width on 1 x MOE_TOKENS tokens; `compressed_psum` on a one-rank NCCL
group made from a HashStore, equal to quantize-then-dequantize of its
input.

Then the `shard` phase (`python3 chip_smoke.py --only shard` runs it
alone after the build): the LM serving path across processes, one rank a
card, `BatchedServer(mesh=...)` under the reference's `shard_map` MoE
dispatch, each rank holding its E/tp experts and running only them, an
all_reduce a MoE layer (SHARD_CELLS). On four cards: SHARD_RANKS ranks
over NCCL serve dbrx-132b and llama4-scout whole and jamba-1.5-large at
16 of 72 layers; with fewer cards a line names the cards, the backend
and the cases not run, and the same code runs SHARD_RANKS ranks over
gloo on the cards there are, at depths whose ranks fit one card. At
those depths each model is also served by a one-rank group on one card
(tp = 1), and tp = SHARD_RANKS, fed tp = 1's tokens, must agree with it:
every step's logits within LM_LOGIT_RTOL, the greedy tokens equal where
the margins allow. Each case: exact flash_attention, mamba_scan and
all_reduce launches a `generate` on every rank, each rank's build slices
bit-equal to the plain version, each rank's peak within
SHARD_PEAK_RATIO of its program counted on `meta`, the first kernel
call of each kind on rank 0 against the plain versions; its line gives
build and generate seconds, the decode step's ms and idle share, the
all_reduce's ms a layer at the prefill and at a decode step beside its
bytes and the NVLink bound, and `nvidia-smi topo -m`. In the same spawn
of ranks the phase trains (SHARD_TRAIN_FULL, SHARD_TRAIN_CUT): the
reference's train step under its `shard_map` policy, each rank its E/tp
experts with their AdamW moments; four cards: dbrx-132b, jamba and
llama4-scout at full width and cut depth on 1 x 4096 tokens; one card:
their reduced configs on gloo ranks held bit for bit to a tp = 1 run
(losses, norms, every leaf of each rank's part), and dbrx-132b's
MoE layer at full width against the one-device emulation (SHARD_MOE_*).
Each train run: exact kernel and all_reduce launches a step, losses,
norms and a checksum of every leaf held whole equal on every rank, the
first norm against the whole model's gathered; on four cards each
rank's peak within SHARD_PEAK_RATIO of `launch.dryrun.count_train`
(counted once, in this process, for every rank). Each train run on one
card, and on four cards one more dbrx-132b run at its published widths,
checkpoints across its ranks (SHARD_CKPT_*): an asynchronous save after
step 2, then the checkpoint restored in the same processes and step 3
run again, bit-equal to the unbroken step 3 on every rank; the directory
read back without the Checkpointer, each rank's slice bit-equal to what
it saved; on one card the tp = 4 manifest equal to the tp = 1 run's.
On four cards, `compressed_psum` across the NCCL ranks on a MoE layer's
gradient-sized tensor, exact (SHARD_PSUM_SEED). A rank that fails or
outlasts SHARD_TIMEOUT_S fails the phase.

With `--profile`, one more card serve runs under `torch.profiler`: its
line gives the device's busy time by kernel and its idle share of the
wall time.

Then the kernels summary line (the encoder rows' launches sum the serve,
learn, qos, control, gen and ablate phases', and the train, learn, qos,
control and ablate phases' for the backward; the attention and scan rows
the lm, train_lm, layout, ops and shard phases' (by phase in
`launches_by_phase`; the shard phase's summed over its ranks), their
backward rows the ops, train_lm, layout and shard phases'; the threefry_normal
row the rng phase's build and the lm, train_lm, layout and shard phases'
builds, the
threefry_gumbel row the lm phase's sampled steps), the `nvidia-smi`
line, and
the result line `{"ok": true, "device": {...}}`; before them a
`phase_seconds` line (each phase's seconds, also printed to stderr as it
ends, the script's seconds from its start after the imports, and the
card's name and power limit). Any failure raises and
exits non-zero (the learn, qos, control, gen and ablate phases check
every case first and name each mismatch); without CUDA the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import multiprocessing
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.baselines import (AutoSteerOptimizer,  # noqa: E402
                                   LeroOptimizer)
from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    agent_state_from_numpy,
                                    install_agent_state,
                                    load_reference_checkpoint, params_finite,
                                    params_from_numpy)
from repro_torch.adapt.knobs import BASELINE  # noqa: E402
from repro_torch.adapt.search import LayoutReoptimizer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import (AgentConfig, AqoraAgent,  # noqa: E402
                                    _node_bucket)
from repro_torch.core.dqn import DQNAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta, encode_state  # noqa: E402
from repro_torch.core.train_loop import evaluate, train_agent  # noqa: E402
from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.experiments import main_experiment  # noqa: E402
from repro_torch.gen.world import sample_world  # noqa: E402
from repro_torch.kernels import (build, ops, ref, threefry,  # noqa: E402
                                 tree_conv, work)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.launch.mesh import (Mesh, join_host_mesh,  # noqa: E402
                                     leave, make_production_mesh,
                                     spawn_ranks)
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.train import batch_on  # noqa: E402
from repro_torch.launch.train import make_train_step as train_step_fn  # noqa: E402,E501
from repro_torch.launch.train import train as train_lm  # noqa: E402
from repro_torch.learn import (AdaptiveCurriculum, PolicyStore,  # noqa: E402
                               TrajectoryHarvester, make_online_loop)
from repro_torch.models import attention, blocks, lm, moe  # noqa: E402
from repro_torch.models.common import act_fn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.compress import (compressed_psum,  # noqa: E402
                                        dequantize_int8, quantize_int8)
from repro_torch.serve.deltas import DeltaBatch, apply_delta  # noqa: E402
from repro_torch.serve.drift import DriftController, RefreshPolicy  # noqa: E402
from repro_torch.serve.driver import (TenantTraffic,  # noqa: E402
                                      multi_tenant_stream, open_loop_stream)
from repro_torch.serve.obs import SloMonitor, Tracer  # noqa: E402
from repro_torch.serve.obs import export as obs_export  # noqa: E402
from repro_torch.serve.obs import report as obs_report  # noqa: E402
from repro_torch.serve.plans import PlanMemory, Superoptimizer  # noqa: E402
from repro_torch.serve.qos import (DegradationLadder,  # noqa: E402
                                   LatencyPredictor, QoSAdmission,
                                   TenantRegistry, TenantSpec)
from repro_torch.serve.recover import (FaultInjector,  # noqa: E402
                                       HedgePolicy, PolicyBreaker,
                                       RecoveryManager, RetryPolicy,
                                       ScriptedFaults)
from repro_torch.serve.scheduler import Arrival, LaneScheduler  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sharding import act as act_sharding  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.catalog import analyze  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.executor import AdaptiveRun  # noqa: E402
from repro_torch.sql.plans import syntactic_plan  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

CKPT = ROOT / "results" / "aqora_ckpt" / "step_00000018"
TOL = 1e-4                 # the reference's own fused-vs-jnp tolerance
HBM_BYTES_PER_S = work.HBM_BYTES_PER_S   # H100 SXM data sheet
FP32_FLOPS = work.FP32_FLOPS             # H100 SXM fp32, no tensor cores
BF16_FLOPS = work.BF16_FLOPS             # H100 SXM bf16 tensor cores, dense
SFU_PER_CLOCK = 16         # exps per clock on each SM (special-function units)
N_LANES = 8
# the backward kernel's weight grads sum over every node and tree in
# another order than the plain version's autograd
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
TRAIN_EPISODES = 32        # 4 lockstep episode-batches of 8: 4 PPO updates
TRAIN_LOSS_RTOL = 1e-4     # first update's losses, card against CPU
LEARN_QUERIES = 48         # the learn phase's stream: the serve's
LEARN_LOOP = {"update_every": 8, "sample_size": 8, "gate_every": 2,
              "seed": 5}
LEARN_LEAF_ATOL = 1e-4     # final serving state, card against CPU
QOS_QUERIES = 24           # each tenant's stream in the qos phase
QOS_PRED_RTOL = 1e-5       # each admission prediction, card against CPU
FIT_LOSS_RTOL = 1e-4       # fit_from_replay's loss, card against CPU
RUNGS = (1.0, 2.0, 4.0)    # DegradationLadder()'s severity ceilings
CONTROL_SCALE = 0.25       # the control phase's db: the serving cell's
CONTROL_GROWTH_X = 24      # movie_info grows by 24x its young rows ...
CONTROL_DRIFT_AT = 24      # ... after query 24 of the 48
CONTROL_PRED_RTOL = 1e-5   # each prediction, card against CPU
REFIT_LOSS_RTOL = 1e-4     # each refit's loss, card against CPU
# the re-ANALYZE threshold: above the score the growth delta gives
# movie_info at its own barrier (24.0 in a CPU run), so the predictor's
# refits (peak score >= 1) come first; the failed retries' regret later
# lifts the score to 43.8 and the re-ANALYZE follows. At the default 1.0
# it lands at the delta's barrier and no refit can fire after it.
CONTROL_REFRESH = 30.0
TRACE_FLOAT_KEYS = ("peak_score",)   # trace fields computed from a card float
GEN_WORLD = {"family": "person", "scale": 0.07, "n_templates": 8,
             "n_train": 24, "n_test_per_template": 1, "t_min": 3,
             "t_max": 5, "n_queries": 72}   # bench_generalize's serving world
GEN_SEED, GEN_LANES = 202, 4
# the ablation experiment's workload (experiments/ablations.py, run_all)
ABLATE_WORKLOAD = {"n_train": 120, "n_test_per_template": 2, "seed": 7}
ABLATE_EPISODES = 16       # each encoder's and run_bench's AQORA training
DQN_EPISODES = 32          # the DQN agent's serial episodes
DQN_LOSS_RTOL = 1e-5       # the first train step's loss, card against CPU
DQN_SHAPE = (64, 64, 19)   # a DQN train step's batch: B, N (MAX_NODES), F
WALL_CLOCK = ("plan_time", "total")  # run_bench fields from the host clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's top SM clock, from nvidia-smi."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def sfu_ms(exps: float) -> float:
    """The least time the card's special-function units take for `exps`
    exps."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * SFU_PER_CLOCK * sm_clock_hz()) * 1e3


def cuda_ms(fn, *, launches: int, reps: int = 5, warmup: int = 10) -> float:
    """Median over `reps` of the mean time of `launches` back-to-back
    calls, by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return float(np.median(times))


# ------------------------------------------------------------------ set-up
def deployment():
    db = datagen.make_job_like(scale=0.25, seed=0)
    wl = workloads.make_workload("job", n_train=100, n_test_per_template=1)
    return db, wl, WorkloadMeta.from_workload(wl)


def make_agent(meta, device, params):
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    agent.load_params(params)
    return agent


def serving_batch(db, wl, meta):
    """The encoder's input at one scheduler tick: the opening states of
    the six test queries with the most relations in lanes 0-5 and two
    all-zero padded lanes, trimmed to the node bucket as act_batch trims
    it (N=48 for this workload)."""
    est = Estimator(db, db.stats)
    F = meta.feat_dim
    feat = np.zeros((N_LANES, 64, F), np.float32)
    left = np.zeros((N_LANES, 64), np.int32)
    right = np.zeros((N_LANES, 64), np.int32)
    mask = np.zeros((N_LANES, 64), np.float32)
    widest = sorted(wl.test, key=lambda q: -len(q.relations))[:6]
    for i, q in enumerate(widest):
        st = AdaptiveRun(db, q, syntactic_plan(q), est,
                         max_hook_steps=3).start()
        feat[i], left[i], right[i], mask[i] = encode_state(st, meta)
    n = _node_bucket(int(mask.sum(axis=1).max()) + 1)
    return feat[:, :n], left[:, :n], right[:, :n], mask[:, :n]


def random_batch(rng, B, N, F):
    """Random trees with all-masked lanes and out-of-range children."""
    feat = rng.standard_normal((B, N, F)).astype(np.float32)
    left = rng.integers(0, N, (B, N)).astype(np.int32)
    right = rng.integers(0, N, (B, N)).astype(np.int32)
    left[:, 1::7] = N + 3                  # past the end -> null child
    right[:, 2::9] = -2                    # negative -> null child
    mask = (rng.random((B, N)) > 0.25).astype(np.float32)
    mask[:, 0] = 0.0                       # the null slot
    mask[-1] = 0.0                         # an all-masked (padded) lane
    return feat, left, right, mask


def random_params(rng, F, H):
    out = {}
    for i, name in enumerate(tree_conv.LAYERS):
        d_in = F if i == 0 else H
        s = (3 * d_in) ** -0.5
        out[name] = {w: rng.standard_normal((d_in, H)).astype(np.float32) * s
                     for w in ("wr", "wl", "wrt")}
        out[name]["b"] = rng.standard_normal(H).astype(np.float32) * 0.1
    return out


def to_cuda(tree):
    if isinstance(tree, dict):
        return {k: to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_cuda(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).cuda()


def kernel_timing(feat, left, right, mask, params, *, launches: int):
    """tree_cnn_fused's time on these inputs (raw launches, no wrapper
    checks) beside the card's bound for the same work: each input byte
    read once, the output written once, and the FMAs of the real nodes."""
    B, N, F = feat.shape
    H = params["conv1"]["wr"].shape[1]
    fn = tree_conv._library()
    ptrs = [t.data_ptr() for t in (feat, left, right, mask)]
    for lname in tree_conv.LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in tree_conv.WEIGHTS]
    out = torch.empty((B, H), device=feat.device)
    args = (*ptrs, out.data_ptr(), B, N, F, H,
            torch.cuda.current_stream().cuda_stream)
    ms = cuda_ms(lambda: fn(*args), launches=launches)
    real_nodes = float(mask.sum())
    n_bytes, flops = work.tree_cnn_fused_work(B, N, F, H, real_nodes)
    return {"shape": [B, N, F, H], "real_nodes": real_nodes, "ms": ms,
            **work.bound(n_bytes, flops, FP32_FLOPS)}


# ------------------------------------------------------------------ phases
def phase_device():
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sm_clock_max_mhz": sm_clock_hz() / 1e6,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    t0 = time.perf_counter()
    log = build.build()
    for name in log:                       # load each, so a bad .so fails here
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for k, v in log.items()}})


def phase_kernels(db, wl, meta, ckpt_tree):
    rng = np.random.default_rng(0)
    F, H = meta.feat_dim, AgentConfig().hidden
    trained = to_cuda(ckpt_tree["actor"]["enc"])
    weights = {"step18": trained, "random": to_cuda(random_params(rng, F, H))}
    cases = []
    for wname, params in weights.items():
        for B in (8, 5):
            for N in (16, 32, 48, 64):
                cases.append((f"{wname}/B{B}/N{N}", params,
                              to_cuda(random_batch(rng, B, N, F))))
    real = to_cuda(serving_batch(db, wl, meta))
    cases.append(("step18/serving", trained, real))
    # a DQN train step's shape (ablate phase): its own generator, so the
    # cases above keep their inputs
    drng = np.random.default_rng(64)
    dqn_case = (f"dqn/B{DQN_SHAPE[0]}/N{DQN_SHAPE[1]}/F{DQN_SHAPE[2]}",
                to_cuda(random_params(drng, DQN_SHAPE[2], H)),
                to_cuda(random_batch(drng, *DQN_SHAPE)))
    cases.append(dqn_case)

    worst = 0.0
    rows = []
    for name, params, (feat, left, right, mask) in cases:
        out = tree_conv.tree_cnn_fused(feat, left, right, mask, params)
        want = ref.tree_cnn_fused_ref(feat, left, right, mask, params)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        dead = mask.sum(dim=1) == 0
        if not torch.isfinite(out).all() or err > TOL or \
                bool((out[dead] != 0).any()):
            raise AssertionError(f"tree_cnn_fused disagrees on {name}: "
                                 f"max |kernel - plain| = {err}")
        worst = max(worst, err)
        rows.append({"case": name, "shape": list(feat.shape),
                     "max_abs_err": err})

    # time at the serving shape, on a real scheduler tick's input
    timing = kernel_timing(*real, trained, launches=500)
    timing["plain_ms"] = cuda_ms(lambda: ref.tree_cnn_fused_ref(
        *real, trained), launches=100)
    dqn_timing = kernel_timing(*dqn_case[2], dqn_case[1], launches=200)
    dqn_timing["plain_ms"] = cuda_ms(lambda: ref.tree_cnn_fused_ref(
        *dqn_case[2], dqn_case[1]), launches=20)
    bwd_rows, bwd_worst, bwd_timing = backward_cases(rng, weights, real,
                                                     extra=[dqn_case])
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": rows, "tree_cnn_fused": timing,
          "tree_cnn_fused_dqn": dqn_timing,
          "backward": {"atol": BWD_ATOL, "rtol": BWD_RTOL,
                       "max_abs_err": bwd_worst, "cases": bwd_rows,
                       "bitwise_repeatable": True,
                       "timing": {k: {f: v for f, v in t.items()
                                      if f != "launch"}
                                  for k, t in bwd_timing.items()}}})
    return worst, timing, bwd_worst, bwd_timing


def tied_batch(rng, B, N, F):
    """Random trees in which nodes 1 and 2 are one node twice (the same
    features and children), scaled up so that they hold channel maxima
    together."""
    feat, left, right, mask = random_batch(rng, B, N, F)
    feat[:, 1] *= 10.0
    feat[:, 2] = feat[:, 1]
    left[:, 2], right[:, 2] = left[:, 1], right[:, 1]
    mask[:-1, 1:3] = 1.0
    return feat, left, right, mask


def tied_channels(feat, left, right, mask, params) -> int:
    """(tree, channel) pairs whose max-pool has more than one maximum, by
    the plain version's layers."""
    m = mask.unsqueeze(-1)

    def layer(h, p):
        return ref.tree_layer(h, left, right, m, *(p[w] for w in
                                                   tree_conv.WEIGHTS))
    h1 = layer(feat * m, params["conv1"])
    h2 = layer(h1, params["conv2"])
    h3 = torch.where(m > 0, layer(h2, params["conv3"]) + h2, -torch.inf)
    top = h3.amax(dim=1, keepdim=True)
    return int((((h3 == top) & (m > 0)).sum(dim=1) > 1).sum())


def backward_check(name, params, batch, g):
    """The backward kernel (gfeat and gmask asked for) against its plain
    version on one case: each of the 14 outputs within BWD_ATOL +
    BWD_RTOL * |plain|."""
    gf, gm, gp = tree_conv.tree_cnn_fused_backward(*batch, params, g)
    wf, wm, wp = ref.tree_cnn_fused_bwd_ref(*batch, params, g)
    parts = [closeness("gfeat", gf, wf, BWD_ATOL, BWD_RTOL),
             closeness("gmask", gm, wm, BWD_ATOL, BWD_RTOL)]
    parts += [closeness(f"{l}.{w}", gp[l][w], wp[l][w], BWD_ATOL, BWD_RTOL)
              for l in tree_conv.LAYERS for w in tree_conv.WEIGHTS]
    dead = batch[3].sum(dim=1) == 0
    zero_dead = not (gf[dead].any() or gm[dead].any())
    return {"case": name, "shape": list(batch[0].shape),
            "ok": all(p["ok"] for p in parts) and zero_dead,
            "all_masked_trees_zero": zero_dead,
            "max_abs_err": max(p.get("max_abs_err", float("inf"))
                               for p in parts),
            "limit_share": max(p.get("limit_share", float("inf"))
                               for p in parts),
            "outside": [p["case"] for p in parts if not p["ok"]]}


def backward_cases(rng, weights, real, extra=()):
    """Every backward case (and the `extra` ones) checked, then one error
    naming each case outside its limit; then the same inputs twice, bit
    for bit; then the kernel's time at the actor's and the critic's PPO
    shapes and at each extra case's."""
    F, H = real[0].shape[2], weights["step18"]["conv1"]["wr"].shape[1]
    cases = [(f"step18/ppo-actor/B24/N48", weights["step18"],
              to_cuda(random_batch(rng, 24, 48, F))),
             (f"step18/ppo-critic/B32/N48", weights["step18"],
              to_cuda(random_batch(rng, 32, 48, F))),
             ("step18/serving", weights["step18"], real)]
    for wname, params in weights.items():
        for B in (8, 5):
            for N in (16, 32, 48, 64):
                cases.append((f"{wname}/B{B}/N{N}", params,
                              to_cuda(random_batch(rng, B, N, F))))
        cases.append((f"{wname}/tied/B8/N48", params,
                      to_cuda(tied_batch(rng, 8, 48, F))))
    cases += list(extra)
    rows = []
    for name, params, batch in cases:
        g = torch.from_numpy(rng.standard_normal(
            (batch[0].shape[0], H)).astype(np.float32)).cuda()
        row = backward_check(name, params, batch, g)
        if "tied" in name:
            row["tied_channels"] = tied_channels(*batch, params)
        rows.append(row)
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tree_cnn_fused backward disagrees: {bad}")
    if any(r["tied_channels"] == 0 for r in rows if "tied" in r["case"]):
        raise AssertionError(f"a tied case has no tied maxima: {rows}")

    name, params, batch = cases[0]
    g = torch.from_numpy(rng.standard_normal(
        (batch[0].shape[0], H)).astype(np.float32)).cuda()
    runs = [tree_conv.tree_cnn_fused_backward(*batch, params, g)
            for _ in range(2)]
    outs = [[r[0], r[1]] + [r[2][l][w] for l in tree_conv.LAYERS
                            for w in tree_conv.WEIGHTS] for r in runs]
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the backward kernel is not bitwise repeatable")
    timing = {c[0]: backward_timing(*c[2], c[1])
              for c in cases[:2] + list(extra)}
    return rows, max(r["max_abs_err"] for r in rows), timing


def backward_timing(feat, left, right, mask, params):
    """The backward kernel's time as the PPO update calls it (weight
    grads only), by CUDA events over raw launches and by torch.profiler
    (its two device kernels, in `phase_late_profiles`), beside the plain
    version's and the card's bound: each input read once, the weight
    grads written once, and the FMAs the real nodes need (the three
    layers' recompute, their weight gradients and the input gradients of
    layers 3 and 2). Beside it, the kernel's blocks a tree, blocks an SM
    and clusters resident at once (`tree_conv.backward_occupancy`)."""
    B, N, Fd = feat.shape
    H = params["conv1"]["wr"].shape[1]
    g = torch.ones((B, H), device=feat.device)
    E = sum(t.numel() for p in params.values() for t in p.values())
    partial = torch.empty((B, E), device=feat.device)
    flat = torch.empty(E, device=feat.device)
    ptrs = [t.data_ptr() for t in (feat, left, right, mask)]
    for lname in tree_conv.LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in tree_conv.WEIGHTS]
    args = (*ptrs, g.data_ptr(), partial.data_ptr(), flat.data_ptr(), 0, 0,
            B, N, Fd, H, torch.cuda.current_stream().cuda_stream)
    fn = tree_conv._bwd_library()
    kernel_ms = cuda_ms(lambda: fn(*args), launches=200)
    occupancy = tree_conv.backward_occupancy(N, Fd, H)
    plain = cuda_ms(lambda: ref.tree_cnn_fused_bwd_ref(
        feat, left, right, mask, params, g), launches=20)
    real_nodes = float(mask.sum())
    n_bytes, flops = work.tree_cnn_fused_bwd_work(B, N, Fd, H, real_nodes)
    return {"shape": [B, N, Fd, H], "real_nodes": real_nodes, "ms": kernel_ms,
            **{k: occupancy[k] for k in ("cluster", "blocks_per_sm",
                                         "max_active_clusters")},
            "plain_ms": plain, **work.bound(n_bytes, flops, FP32_FLOPS),
            # a later launch (phase_late_profiles) on raw pointers: `keep`
            # holds their tensors, whose memory, once freed,
            # torch.cuda.empty_cache could unmap before it
            "launch": lambda keep=(feat, left, right, mask, params, g,
                                   partial, flat): fn(*args)}


def phase_serve(db, wl, meta, params):
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    gpu = make_agent(meta, None, params)      # the default device: CUDA
    cpu = make_agent(meta, "cpu", params)

    call_s, batches = [], []
    inner = gpu.act_batch

    def timed_act_batch(feat, left, right, mask, *a, **k):
        t0 = time.perf_counter()
        out = inner(feat, left, right, mask, *a, **k)
        call_s.append(time.perf_counter() - t0)
        n = min(gpu._nodes, _node_bucket(int(mask.sum(axis=1).max()) + 1))
        batches.append(tuple(np.ascontiguousarray(x[:, :n])
                             for x in (feat, left, right, mask)))
        return out
    gpu.act_batch = timed_act_batch

    margins = []
    record_margins(cpu, margins)

    tree_conv.tree_cnn_fused_launches = 0
    t0 = time.perf_counter()
    comps, stats = QueryService(db, gpu, n_lanes=N_LANES,
                                policy="async").run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tree_conv.tree_cnn_fused_launches

    t0 = time.perf_counter()
    ref_comps, ref_stats = QueryService(db, cpu, n_lanes=N_LANES,
                                        policy="async").run(stream)
    cpu_wall = time.perf_counter() - t0

    if launches != len(call_s) or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {len(call_s)} "
                             "act_batch calls")
    if len(comps) != 48 or len(ref_comps) != 48:
        raise AssertionError(f"{len(comps)}/{len(ref_comps)} completions")
    bad, logp_diff = compare_completions(comps, ref_comps)
    if bad or logp_diff > TOL:
        raise AssertionError(f"card and CPU serves differ: {bad}; logps "
                             f"differ by {logp_diff}")
    # the kernel's time on each act_batch's own input, after the run
    trained = gpu.actor.enc.params()
    per_batch = [kernel_timing(*to_cuda(b), trained, launches=50)
                 for b in batches]
    buckets = {}
    for b in batches:
        buckets[b[0].shape[1]] = buckets.get(b[0].shape[1], 0) + 1
    emit({"phase": "serve", "n_completed": stats.n_completed,
          "n_failed": stats.n_failed, "ticks": stats.ticks,
          "mean_decide_batch": stats.mean_decide_batch,
          "virtual_p50_s": stats.latency_p50,
          "virtual_p99_s": stats.latency_p99, "wall_s": wall,
          "act_batch_calls": len(call_s),
          "act_batch_ms_mean": float(np.mean(call_s)) * 1e3,
          "act_batch_ms_median": float(np.median(call_s)) * 1e3,
          "act_batch_ms_first": call_s[0] * 1e3,
          "kernel_launches": launches, "launches_by_node_bucket": buckets,
          "kernel_ms_mean_over_serve_batches":
              float(np.mean([t["ms"] for t in per_batch])),
          "kernel_bound_ms_mean_over_serve_batches":
              float(np.mean([t["bound_ms"] for t in per_batch])),
          "cpu_wall_s": cpu_wall,
          "identical_to_cpu": True, "max_logp_diff": logp_diff,
          "min_top2_margin": min(margins)})
    return launches


def record_margins(agent, out):
    """Wrap `agent`'s `act_batch` and `act` so that each live decision
    appends the top-1/top-2 margin of the scores it takes its action
    from: the masked logits when greedy, and the Gumbel-perturbed logits
    `prng.categorical` draws from when exploring. Exact action equality
    between the card and the CPU only holds while no margin is a near
    tie."""
    inner_batch, inner_act = agent.act_batch, agent.act

    def note(feat, left, right, mask, amask, keys=None):
        with torch.inference_mode():
            lg = agent.actor(*(agent._tensor(x)
                               for x in (feat, left, right, mask)))
            s = lg.masked_fill(~(agent._tensor(amask) > 0), -1e9).cpu()
        if keys is not None:
            u = prng.gumbel_uniforms(prng.split(keys)[:, 1], s.shape[-1])
            s = -torch.log(-torch.log(torch.from_numpy(u))) + s
        top = s.topk(2, dim=-1).values
        live = torch.from_numpy(np.asarray(mask).sum(axis=1) > 0)
        out.extend((top[:, 0] - top[:, 1])[live].tolist())

    def act_batch(feat, left, right, mask, amask, keys, explore=True):
        note(feat, left, right, mask, amask, keys if explore else None)
        return inner_batch(feat, left, right, mask, amask, keys,
                           explore=explore)

    def act(enc, amask, explore=True):
        if not explore:
            note(*(np.asarray(x)[None] for x in enc), np.asarray(amask)[None])
        return inner_act(enc, amask, explore=explore)

    agent.act_batch, agent.act = act_batch, act


def compare_completions(comps, ref_comps):
    """Every pair of completions whose seq, actions, finish time, lane or
    failure differ (all pairs checked), and the largest logp difference;
    a non-finite logp counts as a difference."""
    bad, logp_diff = [], 0.0
    if len(comps) != len(ref_comps):
        bad.append(f"{len(comps)} vs {len(ref_comps)} completions")
    for a, b in zip(comps, ref_comps):
        if (a.seq, a.traj.actions, a.finish_t, a.lane, a.result.failed) != \
                (b.seq, b.traj.actions, b.finish_t, b.lane, b.result.failed):
            bad.append(f"seq {a.seq}: card {a.traj.actions} {a.finish_t} "
                       f"lane {a.lane} vs cpu {b.traj.actions} {b.finish_t} "
                       f"lane {b.lane}")
        if not np.all(np.isfinite(a.traj.logps)):
            bad.append(f"seq {a.seq}: non-finite logps")
        elif a.traj.logps:
            logp_diff = max(logp_diff, float(np.max(np.abs(
                np.subtract(a.traj.logps, b.traj.logps)))))
    return bad, logp_diff


def leaves_of(agent):
    return {k: v.detach().cpu().numpy() for k, v in
            flatten(agent_state(agent))}


def phase_train(db, wl, meta, ckpt_tree):
    """The training path from step 18's full state, on the card through
    the kernels and on the CPU through the plain versions."""
    # a fresh agent from a seed: drawn on the host, so the card's and the
    # CPU's are equal leaf for leaf
    fresh = [leaves_of(AqoraAgent(meta, AgentConfig(), seed=0, device=dev))
             for dev in (None, "cpu")]
    if set(fresh[0]) != set(fresh[1]) or not all(
            np.array_equal(fresh[0][k], v) for k, v in fresh[1].items()):
        raise AssertionError("a fresh seeded agent differs on the card")
    state = agent_state_from_numpy(ckpt_tree)
    agents = {}
    for dev in (None, "cpu"):                 # None: the default, CUDA
        agent = AqoraAgent(meta, AgentConfig(), seed=0, device=dev)
        install_agent_state(agent, state)
        agents["card" if dev is None else "cpu"] = agent
    gpu, cpu = agents["card"], agents["cpu"]
    epochs = gpu.cfg.ppo_epochs

    updates, act_s, last = [], [], {}
    ppo_inner, act_inner = gpu.ppo_update_batch, gpu.act_batch

    def ppo_update_batch(trajs):
        before = counts()
        b0 = tree_conv.tree_cnn_fused_bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ppo_inner(trajs)
        torch.cuda.synchronize()
        updates.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "forward_launches": counts()["tree_cnn_fused"]
            - before["tree_cnn_fused"],
            "backward_launches": tree_conv.tree_cnn_fused_bwd_launches - b0,
            "actor_states": sum(len(t.actions) for t in trajs),
            "critic_states": sum(min(len(t.states), gpu.cfg.max_steps + 1)
                                 for t in trajs), **m})
        last["trajs"] = trajs
        return m

    def act_batch(*a, **k):
        t0 = time.perf_counter()
        out = act_inner(*a, **k)
        act_s.append(time.perf_counter() - t0)
        return out
    gpu.ppo_update_batch, gpu.act_batch = ppo_update_batch, act_batch

    fa.launches = ms.launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    t0 = time.perf_counter()
    _, logs = train_agent(db, wl, episodes=TRAIN_EPISODES, batch_size=N_LANES,
                          seed=0, agent=gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(counts(),
                    tree_cnn_fused_bwd=tree_conv.tree_cnn_fused_bwd_launches)
    t0 = time.perf_counter()
    _, cpu_logs = train_agent(db, wl, episodes=TRAIN_EPISODES,
                              batch_size=N_LANES, seed=0, agent=cpu)
    cpu_wall = time.perf_counter() - t0

    first = [(l.query, l.actions, l.latency, l.failed) for l in logs[:N_LANES]]
    cpu_first = [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu_logs[:N_LANES]]
    if first != cpu_first:
        raise AssertionError(f"first batch differs: card {first} cpu "
                             f"{cpu_first}")
    loss_rel = {k: abs(getattr(logs[0], k) - getattr(cpu_logs[0], k))
                / max(abs(getattr(cpu_logs[0], k)), 1e-12)
                for k in ("actor_loss", "critic_loss")}
    if max(loss_rel.values()) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"first update's losses differ: {loss_rel}")
    bad = [u for u in updates if u["forward_launches"] != 1 + 2 * epochs
           or u["backward_launches"] != 4 * epochs]
    if bad or not updates:
        raise AssertionError(f"launches per PPO update: {updates}")
    leaves = leaves_of(gpu)
    if not all(np.isfinite(v).all() for v in leaves.values()) or \
            not params_finite(gpu):
        raise AssertionError("a leaf of the trained state is not finite")
    same_actions = sum(a.actions == b.actions for a, b in zip(logs, cpu_logs))

    # two serial episodes on the card: act(explore=True) and ppo_update
    serial = gpu.clone(seed=1)
    f0 = tree_conv.tree_cnn_fused_launches
    _, serial_logs = train_agent(db, wl, episodes=2, batch_size=1, seed=1,
                                 agent=serial)
    serial_launches = tree_conv.tree_cnn_fused_launches - f0
    if not all(np.isfinite(l.actor_loss) for l in serial_logs) or \
            serial_launches == 0 or not params_finite(serial):
        raise AssertionError(f"serial episodes: {serial_logs}")

    # a checkpoint of the card's trained state restores to equal leaves
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(TRAIN_EPISODES, agent_state(gpu),
              extra={"episodes": TRAIN_EPISODES})
    restored, step, _ = ckpt.restore(agent_state(gpu))
    back = AqoraAgent(meta, AgentConfig(), seed=0, device=None)
    install_agent_state(back, restored)
    back_leaves = leaves_of(back)
    if step != TRAIN_EPISODES or set(back_leaves) != set(leaves) or not all(
            np.array_equal(back_leaves[k], v) and back_leaves[k].dtype ==
            v.dtype for k, v in leaves.items()):
        raise AssertionError("checkpoint did not restore the trained state")

    emit({"phase": "train", "episodes": TRAIN_EPISODES,
          "batch_size": N_LANES, "ppo_updates": len(updates),
          "ppo_epochs": epochs, "wall_s": wall, "cpu_wall_s": cpu_wall,
          "ppo_update_ms": [u["ms"] for u in updates],
          "ppo_update_ms_mean": float(np.mean([u["ms"] for u in updates])),
          "updates": updates,
          "act_batch_calls": len(act_s),
          "act_batch_ms_mean": float(np.mean(act_s)) * 1e3,
          "act_batch_ms_median": float(np.median(act_s)) * 1e3,
          "launches": launched, "first_batch_equal_to_cpu": True,
          "episodes_with_equal_actions": int(same_actions),
          "first_update_loss_rel_diff": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL,
          "card_losses": [(u["actor_loss"], u["critic_loss"])
                          for u in updates],
          "cpu_losses": [(l.actor_loss, l.critic_loss)
                         for l in cpu_logs[::N_LANES]],
          "leaves_finite": True, "serial_episodes": len(serial_logs),
          "serial_forward_launches": serial_launches,
          "checkpoint_restored_equal": True,
          "fresh_seeded_agent_equal_to_cpu": True})
    return launched, gpu.clone(seed=2), last["trajs"]


def learn_serve(db, wl, meta, state, device, *, mode="gate",
                curriculum=True, learning=True, instrument=None):
    """The learn phase's exploring serve from `state` on 8 async lanes,
    with the online loop on (`make_online_loop`: harvester, learner, a
    policy store gating on the first 4 test queries) or off. `instrument`
    sees the serving agent and the learner before the run. Returns
    (completions, learner or None, serving agent, wall seconds)."""
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    hooks, learner = [], None
    if learning:
        store_dir = ROOT / "build" / "chip_smoke_store" / \
            f"{'card' if device is None else device}-{mode}"
        if store_dir.exists():
            shutil.rmtree(store_dir)
        harvester, learner = make_online_loop(
            agent, store=PolicyStore(store_dir, wl.test[:4], mode=mode),
            curriculum=AdaptiveCurriculum(window=8, min_dwell=8)
            if curriculum else None, **LEARN_LOOP)
        hooks = [harvester, learner]
    if instrument is not None:
        instrument(agent, learner)
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=LEARN_QUERIES,
                              seed=1)
    svc = QueryService(db, agent, n_lanes=N_LANES, policy="async",
                       explore=True, hooks=hooks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps, _ = svc.run(stream)
    torch.cuda.synchronize()
    return comps, learner, agent, time.perf_counter() - t0


def gate_rows(store):
    keys = ("step", "accepted", "swapped", "reason", "candidate_score",
            "incumbent_score")
    return [{k: g[k] for k in keys} for g in store.gate_log]


def phase_learn(db, wl, meta, ckpt_tree):
    """The online loop at the default deployment from step 18's full
    state: served exploring on the card and again on the CPU, then on the
    card with a shadow-mode store and no curriculum, and with learning
    off. Every check runs before any fails."""
    state = agent_state_from_numpy(ckpt_tree)
    epochs = AgentConfig().ppo_epochs
    updates, gates = [], []

    def instrument_card(agent, learner):
        inner_update = learner.agent.ppo_update_batch
        inner_gate = learner.store.evaluate_and_maybe_swap

        def ppo_update_batch(trajs):
            f0 = tree_conv.tree_cnn_fused_launches
            b0 = tree_conv.tree_cnn_fused_bwd_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = inner_update(trajs)
            torch.cuda.synchronize()
            updates.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "forward_launches": tree_conv.tree_cnn_fused_launches - f0,
                "backward_launches":
                    tree_conv.tree_cnn_fused_bwd_launches - b0, **m})
            return m

        def evaluate_and_maybe_swap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = inner_gate(*a, **k)
            torch.cuda.synchronize()
            gates.append((time.perf_counter() - t0) * 1e3)
            return rec
        learner.agent.ppo_update_batch = ppo_update_batch
        learner.store.evaluate_and_maybe_swap = evaluate_and_maybe_swap

    margins = []

    def instrument_cpu(agent, learner):
        record_margins(agent, margins)          # exploring serve, probes
        record_margins(learner.agent, margins)  # the candidate's probes

    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    comps, learner, agent, wall = learn_serve(db, wl, meta, state, None,
                                              instrument=instrument_card)
    launched = {"tree_cnn_fused": tree_conv.tree_cnn_fused_launches,
                "tree_cnn_fused_bwd": tree_conv.tree_cnn_fused_bwd_launches}
    ref_comps, ref_learner, ref_agent, cpu_wall = learn_serve(
        db, wl, meta, state, "cpu", instrument=instrument_cpu)
    shadow, shadow_learner, _, shadow_wall = learn_serve(
        db, wl, meta, state, None, mode="shadow", curriculum=False)
    off, _, _, off_wall = learn_serve(db, wl, meta, state, None,
                                      learning=False)

    bad, logp_diff = compare_completions(comps, ref_comps)
    if logp_diff > TOL:
        bad.append(f"logps differ by {logp_diff}")
    stats, ref_stats = learner.stats.as_dict(), ref_learner.stats.as_dict()
    host_s = stats.pop("host_seconds")
    ref_stats.pop("host_seconds")
    if stats != ref_stats:
        bad.append(f"learner stats: card {stats} cpu {ref_stats}")
    if not stats["updates"] or not stats["gates"]:
        bad.append(f"the learner never updated or gated: {stats}")
    if gate_rows(learner.store) != gate_rows(ref_learner.store):
        bad.append(f"gate verdicts: card {gate_rows(learner.store)} cpu "
                   f"{gate_rows(ref_learner.store)}")
    if learner.curriculum.stats() != ref_learner.curriculum.stats():
        bad.append(f"curriculum: card {learner.curriculum.stats()} cpu "
                   f"{ref_learner.curriculum.stats()}")
    leaves, ref_leaves = leaves_of(agent), leaves_of(ref_agent)
    leaf_diff = max(float(np.abs(v - ref_leaves[k]).max())
                    for k, v in leaves.items())
    if not all(np.isfinite(v).all() for v in leaves.values()) or \
            not leaf_diff <= LEARN_LEAF_ATOL:
        bad.append(f"final serving state: max |card - cpu| {leaf_diff}")
    wrong = [u for u in updates if u["forward_launches"] != 1 + 2 * epochs
             or u["backward_launches"] != 4 * epochs]
    if wrong or len(updates) != stats["updates"]:
        bad.append(f"launches per PPO update: {updates}")
    same = [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane,
             c.result.failed) for c in shadow] == \
        [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane,
          c.result.failed) for c in off]
    if not same or shadow_learner.stats.swaps or \
            not shadow_learner.stats.gates:
        bad.append(f"shadow run: identical to learning-off {same}, "
                   f"{shadow_learner.stats.as_dict()}")
    emit({"phase": "learn", "queries": LEARN_QUERIES, **LEARN_LOOP,
          "learner": stats, "curriculum": learner.curriculum.stats(),
          "gate_log": gate_rows(learner.store),
          "update_ms": [u["ms"] for u in updates],
          "update_ms_mean": float(np.mean([u["ms"] for u in updates]))
          if updates else None,
          "gate_ms": gates,
          "gate_ms_mean": float(np.mean(gates)) if gates else None,
          "updates": updates, "learner_host_s": host_s,
          "learner_host_share_of_wall": host_s / wall,
          "learner_host_s_shadow": shadow_learner.stats.host_seconds,
          "wall_s_learning_on": wall, "wall_s_shadow": shadow_wall,
          "wall_s_learning_off": off_wall, "cpu_wall_s": cpu_wall,
          "launches": launched, "harvested": len(learner.replay),
          "max_logp_diff": logp_diff, "min_top2_margin": min(margins),
          "max_leaf_diff": leaf_diff, "leaf_atol": LEARN_LEAF_ATOL,
          "shadow_identical_to_learning_off": same,
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"learn phase: {bad}")
    return launched, state, learner.replay, ref_learner.replay


def qos_run(db, wl, meta, state, device):
    """The two-tenant QoS serve: a `LatencyPredictor` warm-started from
    the step-18 critic drives `QoSAdmission` (a weighted gold tenant with
    a 40 s SLO, a rate-limited bulk tenant with 300 s; the standard
    ladder) on 8 EDF lanes."""
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    pred = LatencyPredictor(meta, agent=agent)
    reg = TenantRegistry([
        TenantSpec("gold", weight=2.0, slo=40.0, cache_bytes=8 << 20),
        TenantSpec("bulk", weight=1.0, rate=1.5, burst=2, slo=300.0)])
    adm = QoSAdmission(reg, predictor=pred, ladder=DegradationLadder())
    severities, calls = [], []
    choose, predict = adm.ladder.choose, pred.predict_enc

    def noting_choose(predicted, slack, memo_hit=False):
        severities.append(predicted / slack)
        return choose(predicted, slack, memo_hit=memo_hit)

    def timed_predict(enc):
        f0 = tree_conv.tree_cnn_fused_launches
        t0 = time.perf_counter()
        p = predict(enc)                     # ends in a device->host copy
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": tree_conv.tree_cnn_fused_launches - f0})
        return p
    adm.ladder.choose, pred.predict_enc = noting_choose, timed_predict
    stream = multi_tenant_stream([
        TenantTraffic("gold", wl.test, rate=3.0, n_queries=QOS_QUERIES,
                      seed=31),
        TenantTraffic("bulk", wl.test, rate=3.0, n_queries=QOS_QUERIES,
                      seed=32)])
    svc = QueryService(db, agent, n_lanes=N_LANES, policy="edf",
                       tenants=reg, admission=adm)
    comps, stats = svc.run(stream)
    d = stats.as_dict()
    d.pop("hook_seconds")                    # host wall time
    rows = ([(c.seq, c.tenant, c.admit_t, c.finish_t, c.hook_budget,
              c.degraded, c.lane, c.result.failed, tuple(c.traj.actions))
             for c in comps],
            [(r.seq, r.reject_t, r.reason) for r in svc.scheduler.rejections],
            {k: v for k, v in adm.stats().items() if k != "predictor"}, d)
    return {"agent": agent, "pred": pred, "rows": rows, "calls": calls,
            "severities": severities, "predictions": dict(pred._pred_memo)}


def qos_fit(pred, replay):
    """`fit_from_replay` (64 samples, batch 16, 2 epochs) from
    `default_rng(0)`; each fit step timed to a synchronise, with its
    backward kernel launches."""
    steps, inner = [], pred._fit_step

    def fit_step(batch):
        b0 = tree_conv.tree_cnn_fused_bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "backward_launches":
                          tree_conv.tree_cnn_fused_bwd_launches - b0})
        return loss
    pred._fit_step = fit_step
    sampled = [e.seq for e in replay.sample(min(64, len(replay)),
                                            np.random.default_rng(0))]
    loss = pred.fit_from_replay(replay, np.random.default_rng(0),
                                n_samples=64, batch_size=16, epochs=2)
    return loss, sampled, steps


def phase_qos(db, wl, meta, state, replay, ref_replay):
    """QoS admission driven by the warm-started predictor, on the card
    and on the CPU; then both predictors refit from their learn phase's
    replay buffer. Every check runs before any fails."""
    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    card = qos_run(db, wl, meta, state, None)
    serve_launches = tree_conv.tree_cnn_fused_launches
    cpu = qos_run(db, wl, meta, state, "cpu")
    bad = []
    for name, got, want in zip(("completions", "rejections", "admission",
                                "stats"), card["rows"], cpu["rows"]):
        if got != want:
            bad.append(f"{name}: card {got} cpu {want}")
    preds, ref_preds = card["predictions"], cpu["predictions"]
    pred_rel = max((abs(p - ref_preds[q]) / max(abs(ref_preds[q]), 1e-12)
                    for q, p in preds.items() if q in ref_preds),
                   default=float("inf"))
    if set(preds) != set(ref_preds) or not preds or \
            not pred_rel <= QOS_PRED_RTOL:
        bad.append(f"predictions: {len(preds)} vs {len(ref_preds)}, max "
                   f"relative difference {pred_rel}")
    if any(c["launches"] != 1 for c in card["calls"]) or \
            len(card["calls"]) != len(preds):
        bad.append(f"forward launches per uncached prediction: "
                   f"{card['calls']}")
    rung_distance = min((abs(s - r) / r for s in card["severities"]
                         for r in RUNGS), default=None)

    critic = {k: v.detach().cpu().clone()
              for k, v in card["agent"].critic.state_dict().items()}
    f0 = tree_conv.tree_cnn_fused_launches
    b0 = tree_conv.tree_cnn_fused_bwd_launches
    loss, sampled, steps = qos_fit(card["pred"], replay)
    fit_launches = {"tree_cnn_fused": tree_conv.tree_cnn_fused_launches - f0,
                    "tree_cnn_fused_bwd":
                        tree_conv.tree_cnn_fused_bwd_launches - b0}
    ref_loss, ref_sampled, ref_steps = qos_fit(cpu["pred"], ref_replay)
    loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-12)
    if sampled != ref_sampled:
        bad.append(f"sampled experiences: card {sampled} cpu {ref_sampled}")
    if not loss_rel <= FIT_LOSS_RTOL or not steps:
        bad.append(f"fit loss: card {loss} cpu {ref_loss}")
    if any(s["backward_launches"] != 2 for s in steps) or \
            len(steps) != len(ref_steps):
        bad.append(f"backward calls per fit step: {steps}")
    after = card["agent"].critic.state_dict()
    if not all(torch.equal(after[k].cpu(), v) for k, v in critic.items()):
        bad.append("a fit wrote the serving critic")
    launched = {"tree_cnn_fused": serve_launches
                + fit_launches["tree_cnn_fused"],
                "tree_cnn_fused_bwd": fit_launches["tree_cnn_fused_bwd"]}
    comps, rejections, admission, _ = card["rows"]
    emit({"phase": "qos", "queries_per_tenant": QOS_QUERIES,
          "completed": len(comps), "rejected": len(rejections),
          "admission": admission,
          "predictions": len(preds),
          "predict_ms": [c["ms"] for c in card["calls"]],
          "predict_ms_mean": float(np.mean([c["ms"] for c in card["calls"]]))
          if card["calls"] else None,
          "max_prediction_rel_diff": pred_rel, "prediction_rtol":
          QOS_PRED_RTOL, "min_rung_distance": rung_distance,
          "fit": {"replay": len(replay), "sampled": len(sampled),
                  "steps": len(steps), "loss": loss, "cpu_loss": ref_loss,
                  "loss_rel_diff": loss_rel, "loss_rtol": FIT_LOSS_RTOL,
                  "step_ms": [s["ms"] for s in steps],
                  "step_ms_mean": float(np.mean([s["ms"] for s in steps]))
                  if steps else None},
          "launches": launched, "identical_to_cpu": not bad,
          "mismatches": bad})
    if bad:
        raise AssertionError(f"qos phase: {bad}")
    return launched


# ------------------------------------------------------------ control
def control_world(wl):
    """The serving cell's db with a young movie_info (90% of its rows
    deleted, then ANALYZEd: bench_drift's build), and the serve's 48-query
    stream with one growth delta of CONTROL_GROWTH_X times movie_info's
    young rows after query CONTROL_DRIFT_AT. Built fresh for every run:
    the delta and the re-ANALYZE mutate the db."""
    db = datagen.make_job_like(scale=CONTROL_SCALE, seed=0)
    apply_delta(db, DeltaBatch("movie_info", delete_frac=0.9, seed=7))
    db.stats = analyze(db, rng=np.random.default_rng(0))
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    rows = CONTROL_GROWTH_X * db.table("movie_info").nrows
    stream.insert(CONTROL_DRIFT_AT, Arrival(
        stream[CONTROL_DRIFT_AT - 1].t,
        delta=DeltaBatch("movie_info", n_append=rows, seed=999)))
    return db, stream, rows


def rel_distance(value, threshold) -> float:
    return abs(value - threshold) / max(abs(threshold), 1e-12)


def control_run(wl, meta, state, device, *, obs=True):
    """The serving cell under every control plane: bench_faults' `full`
    recovery arm (seeded chaos, the retry ladder, hedges against a
    predictor warm-started from the step-18 critic, a breaker over the
    run's policy store), a tracer and an SLO watchdog (alerts unwired),
    the drift controller (threshold re-ANALYZE, refits of the same
    predictor from the harvested replay), plan memory and its
    superoptimizer reading the watchdog's plan ledger. `obs=False` drops
    the tracer and the watchdog (the superoptimizer then counts its own
    heat). Every float compared against a threshold is recorded with its
    relative distance from it."""
    db, stream, rows = control_world(wl)
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    pred = LatencyPredictor(meta, agent=agent)
    side = "card" if device is None else device
    store_dir = ROOT / "build" / "chip_smoke_control" / \
        f"{side}-{'obs' if obs else 'noobs'}"
    if store_dir.exists():
        shutil.rmtree(store_dir)
    store = PolicyStore(store_dir, wl.test[:4], mode="gate")
    store.commit(agent, 18)
    harvester = TrajectoryHarvester()
    hedge = HedgePolicy(factor=4.0, predictor=pred)
    mgr = RecoveryManager(
        injector=FaultInjector(seed=23, p_crash=0.01, p_transient=0.03,
                               p_slow=0.06, p_corrupt=0.03,
                               slow_factor=(8, 48)),
        retry=RetryPolicy(max_attempts=3, backoff=0.5), hedge=hedge,
        breaker=PolicyBreaker(store, agent))
    tracer = Tracer() if obs else None
    monitor = SloMonitor(store=store) if obs else None
    ctl = DriftController(policy=RefreshPolicy("threshold",
                                               threshold=CONTROL_REFRESH),
                          replay=harvester.replay, predictor=pred,
                          store=store)
    memory = PlanMemory()
    superopt = Superoptimizer(memory, ledger=None if monitor is None
                              else monitor.ledger)
    rec = {"predictions": [], "refits": [], "fit_steps": [], "acts": [],
           "hedge_distances": [], "refit_distances": [],
           "refresh_distances": [], "margins": []}

    def forwards():
        return tree_conv.tree_cnn_fused_launches

    def backwards():
        return tree_conv.tree_cnn_fused_bwd_launches

    predict_enc, refit, fit_step = (pred.predict_enc, pred.refit_on_drift,
                                    pred._fit_step)

    def timed_predict(enc):
        f0, t0 = forwards(), time.perf_counter()
        p = predict_enc(enc)                 # ends in a device->host copy
        rec["predictions"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                   "launches": forwards() - f0, "value": p})
        return p

    def timed_refit(*a, **k):
        f0, b0, n0 = forwards(), backwards(), len(rec["fit_steps"])
        sync(device)
        t0 = time.perf_counter()
        loss = refit(*a, **k)
        sync(device)
        rec["refits"].append({"ms": (time.perf_counter() - t0) * 1e3,
                              "loss": float(loss),
                              "fit_steps": len(rec["fit_steps"]) - n0,
                              "forward_launches": forwards() - f0,
                              "backward_launches": backwards() - b0,
                              "generation": pred.generation})
        return loss

    def counted_fit_step(batch):
        b0 = backwards()
        loss = fit_step(batch)
        rec["fit_steps"].append(backwards() - b0)
        return loss
    pred.predict_enc, pred.refit_on_drift = timed_predict, timed_refit
    pred._fit_step = counted_fit_step

    should_hedge = hedge.should_hedge

    def noting_hedge(lane, n_launched):
        p = hedge.predicted(lane)
        if p is not None:
            rec["hedge_distances"].append(rel_distance(
                lane.state.elapsed, hedge.factor * p))
        return should_hedge(lane, n_launched)
    hedge.should_hedge = noting_hedge

    score = ctl.detector.score

    def noting_score(db_):
        drifts = score(db_)
        peak = max((d.score for d in drifts.values()), default=0.0)
        rec["refit_distances"].append(rel_distance(peak,
                                                   ctl.refit_threshold))
        rec["refresh_distances"].extend(
            rel_distance(d.score, ctl.policy.threshold)
            for d in drifts.values() if d.version_lag > 0)
        return drifts
    ctl.detector.score = noting_score

    if device == "cpu":
        record_margins(agent, rec["margins"])
    act_batch = agent.act_batch

    def counted_act_batch(*a, **k):
        f0 = forwards()
        out = act_batch(*a, **k)
        rec["acts"].append(forwards() - f0)
        return out
    agent.act_batch = counted_act_batch

    svc = QueryService(db, agent, n_lanes=N_LANES, policy="async",
                       recovery=mgr, obs=tracer, monitor=monitor,
                       plan_memory=memory,
                       hooks=[harvester, ctl, superopt])
    f0, b0 = forwards(), backwards()
    sync(device)
    t0 = time.perf_counter()
    comps, stats = svc.run(stream)
    sync(device)
    wall = time.perf_counter() - t0
    trace = []
    if tracer is not None:
        path = store_dir / "trace.jsonl"
        obs_export.write_trace_jsonl(tracer, str(path))
        trace = [json.loads(line) for line in path.read_text().splitlines()]
    drift = ctl.summary()
    host = {"analyze_wall_s": drift.pop("analyze_wall_s"),
            "drift_host_s": drift.pop("host_seconds")}
    so_stats = superopt.stats.as_dict()
    host["superopt_host_s"] = so_stats.pop("host_seconds")
    serve_stats = stats.as_dict()
    serve_stats.pop("hook_seconds")          # host wall time
    refit_log = [{k: v for k, v in r.items() if k != "loss"}
                 for r in pred.refit_log]
    return {
        "comps": comps, "wall": wall, "host": host, "trace": trace,
        "rows_appended": rows, "launches": {"tree_cnn_fused": forwards() - f0,
                                            "tree_cnn_fused_bwd":
                                                backwards() - b0},
        "same": {"recovery": mgr.stats.as_dict(), "drift": drift,
                 "refresh_log": ctl.refresh_log, "refit_log": refit_log,
                 "task_log": svc.scheduler.task_log,
                 "plan_memory": memory.stats(),
                 "promotions": superopt.promote_log, "superopt": so_stats,
                 "incidents": [i.as_dict() for i in monitor.incidents]
                 if monitor is not None else None,
                 "breaker_trips": mgr.breaker.trips, "service": serve_stats,
                 "versions": dict(db.versions)},
        **rec}


def sync(device) -> None:
    if device is None:
        torch.cuda.synchronize()


def completion_rows(comps):
    """What a completion decides: actions, finish time, failure kind,
    attempts, hedged, memoized, lane (and the rest of the outcome)."""
    return [(c.seq, c.query.name, tuple(c.traj.actions), c.admit_t,
             c.finish_t, c.lane, c.result.failed, c.result.failure_kind,
             c.failure_kind, c.attempts, c.recovered, c.hedged, c.memoized,
             c.first_admit_t) for c in comps]


def trace_mismatches(got, want, rtol=CONTROL_PRED_RTOL, path="trace"):
    """Where two trace exports differ: every field equal, but those in
    TRACE_FLOAT_KEYS (computed from a card float), which agree within
    `rtol` relative."""
    if isinstance(got, dict) and isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(got)} vs {sorted(want)}"]
        out = []
        for k in got:
            if k in TRACE_FLOAT_KEYS and isinstance(got[k], float):
                if not rel_distance(got[k], want[k]) <= rtol:
                    out.append(f"{path}.{k}: {got[k]} vs {want[k]}")
            else:
                out += trace_mismatches(got[k], want[k], rtol, f"{path}.{k}")
        return out
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return [f"{path}: {len(got)} vs {len(want)} items"]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in trace_mismatches(a, b, rtol, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r} vs {want!r}"]


def breaker_rollback(wl, meta, state, device=None):
    """The breaker's rollback on the card: the step-18 agent committed as
    step 18, every parameter moved (+1e-3) and committed as step 19
    after the eighth completion, then every query admitted after the
    swap fails on every stage: the breaker trips, the store reinstalls
    step 18, and every tensor the kernels read must equal the committed
    one bit for bit; the restored agent's next act_batch launches the
    encoder and takes the committed agent's actions."""
    db = datagen.make_job_like(scale=CONTROL_SCALE, seed=0)
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    committed = {k: v.detach().clone() for k, v in
                 flatten(agent_state(agent)) if isinstance(v, torch.Tensor)}
    store_dir = ROOT / "build" / "chip_smoke_control" / "breaker"
    if store_dir.exists():
        shutil.rmtree(store_dir)
    store = PolicyStore(store_dir, [], mode="gate")
    store.commit(agent, 18)
    n = 16
    faults = ScriptedFaults(stage={(s, 1, k): "transient"
                                   for s in range(8, n) for k in range(8)})
    brk = PolicyBreaker(store, agent, window=8, min_post=4, cooldown=5)
    sched = LaneScheduler(db, Estimator(db, db.stats), agent, n_lanes=1,
                          recovery=RecoveryManager(injector=faults,
                                                   breaker=brk))

    def swapper(comp):
        if comp.seq == 7 and store.serving_step == 18:
            with torch.no_grad():
                for p in list(agent.actor.parameters()) + \
                        list(agent.critic.parameters()):
                    p.add_(1e-3)
            store.commit(agent, 19)
    sched.on_complete.insert(0, swapper)
    comps = sched.run([Arrival(0.3 * i, query=wl.test[i % len(wl.test)],
                               seed=i + 1) for i in range(n)])
    restored = {k: v for k, v in flatten(agent_state(agent))
                if isinstance(v, torch.Tensor)}
    bad = []
    if len(brk.trips) != 1 or store.serving_step != 18:
        bad.append(f"breaker trips {brk.trips}, serving step "
                   f"{store.serving_step}")
    differ = [k for k, v in committed.items()
              if k not in restored or not torch.equal(restored[k], v)]
    on_card = all(v.device.type == agent.device.type
                  for k, v in restored.items()
                  if k.startswith(("actor", "critic")))
    if differ or not on_card:
        bad.append(f"rollback: {len(differ)} tensors differ from the "
                   f"committed state ({differ[:4]}), parameters on the "
                   f"card: {on_card}")
    batch = serving_batch(db, wl, meta)
    ref_agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(ref_agent, state)
    f0 = tree_conv.tree_cnn_fused_launches
    amask = np.ones((N_LANES, agent.space.d), np.float32)
    keys = np.zeros((N_LANES, 2), np.uint32)
    acts = agent.act_batch(*batch, amask, keys, explore=False)[0]
    launched = tree_conv.tree_cnn_fused_launches - f0
    want = ref_agent.act_batch(*batch, amask, keys, explore=False)[0]
    if launched != (device is None) or not np.array_equal(acts, want):
        bad.append(f"restored act_batch: {launched} launches, actions "
                   f"{acts.tolist()} vs committed {want.tolist()}")
    return {"completions": len(comps), "trips": brk.trips,
            "tensors_checked": len(committed),
            "restored_bit_equal": not differ}, bad


def phase_control(wl, meta, state, card=None):
    """The control planes at the serving cell, served on the card and on
    the CPU, then on the card without the observability plane; the
    breaker's rollback on the card; both observability selftests on the
    card. Every check runs before any fails."""
    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    got = control_run(wl, meta, state, card)
    launched = dict(got["launches"])
    want = control_run(wl, meta, state, "cpu")
    off = control_run(wl, meta, state, card, obs=False)
    bad = []
    if completion_rows(got["comps"]) != completion_rows(want["comps"]):
        bad.append("completions differ: " + "; ".join(
            f"card {a} cpu {b}" for a, b in zip(
                completion_rows(got["comps"]),
                completion_rows(want["comps"])) if a != b))
    _, logp_diff = compare_completions(got["comps"], want["comps"])
    if not logp_diff <= TOL:
        bad.append(f"logps differ by {logp_diff}")
    for name, value in got["same"].items():
        if value != want["same"][name]:
            bad.append(f"{name}: card {value} cpu {want['same'][name]}")
    bad += trace_mismatches(got["trace"], want["trace"])[:20]
    values = [p["value"] for p in got["predictions"]]
    ref_values = [p["value"] for p in want["predictions"]]
    pred_rel = max((rel_distance(a, b) for a, b in zip(values, ref_values)),
                   default=0.0)
    if len(values) != len(ref_values) or not values or \
            not pred_rel <= CONTROL_PRED_RTOL:
        bad.append(f"predictions: {len(values)} vs {len(ref_values)}, max "
                   f"relative difference {pred_rel}")
    losses = [r["loss"] for r in got["refits"]]
    ref_losses = [r["loss"] for r in want["refits"]]
    loss_rel = max((rel_distance(a, b) for a, b in zip(losses, ref_losses)),
                   default=0.0)
    if len(losses) != len(ref_losses) or not losses or \
            not loss_rel <= REFIT_LOSS_RTOL:
        bad.append(f"refits: {len(losses)} vs {len(ref_losses)}, losses "
                   f"{losses} vs {ref_losses}")
    steps = sum(r["fit_steps"] for r in got["refits"])
    if any(p["launches"] != 1 for p in got["predictions"]) or \
            any(n != 1 for n in got["acts"]) or \
            any(n != 2 for n in got["fit_steps"]) or \
            any(r["forward_launches"] != r["fit_steps"]
                for r in got["refits"]) or \
            launched["tree_cnn_fused"] != len(got["acts"]) + \
            len(values) + steps or \
            launched["tree_cnn_fused_bwd"] != 2 * steps:
        bad.append(f"launches {launched}: act_batch {got['acts']}, "
                   f"predictions {[p['launches'] for p in got['predictions']]}"
                   f", fit steps {got['fit_steps']}")
    # a replayed plan records no action masks and no log-probabilities:
    # the policy was never asked
    memoized = [c for c in got["comps"] if c.memoized]
    if not memoized or any(c.traj.masks or any(c.traj.logps)
                           for c in memoized):
        bad.append(f"{len(memoized)} memoized completions, some decided "
                   "by the policy")
    same_off = [(r, tuple(c.traj.logps)) for r, c in zip(
        completion_rows(off["comps"]), off["comps"])] == \
        [(r, tuple(c.traj.logps)) for r, c in zip(
            completion_rows(got["comps"]), got["comps"])]
    if not same_off:
        bad.append("the card's completions with obs off differ from obs on")
    breaker, breaker_bad = breaker_rollback(wl, meta, state, card)
    bad += breaker_bad
    selftests = {}
    for name, mod in (("export", obs_export), ("report", obs_report)):
        path = ROOT / "build" / "chip_smoke_control" / f"{name}.jsonl"
        f0 = tree_conv.tree_cnn_fused_launches
        rc = mod._selftest(str(path))
        selftests[name] = {"rc": rc, "launches":
                           tree_conv.tree_cnn_fused_launches - f0}
        if rc != 0 or (card is None and selftests[name]["launches"] == 0):
            bad.append(f"obs {name} selftest: {selftests[name]}")
    walls = {"card_obs_on": got["wall"], "card_obs_off": off["wall"],
             "cpu": want["wall"]}
    mean = lambda xs: float(np.mean(xs)) if xs else None  # noqa: E731
    emit({"phase": "control", "queries": 48,
          "growth_rows_appended": got["rows_appended"],
          "completed": len(got["comps"]),
          "failed": sum(c.result.failed for c in got["comps"]),
          "memoized": len(memoized),
          "hedged": sum(c.hedged for c in got["comps"]),
          "recovery": got["same"]["recovery"],
          "drift": got["same"]["drift"], "refit_log": got["same"]["refit_log"],
          "plan_memory": got["same"]["plan_memory"],
          "superopt": got["same"]["superopt"],
          "incidents": len(got["same"]["incidents"] or []),
          "breaker_trips": len(got["same"]["breaker_trips"]),
          "trace_records": len(got["trace"]),
          "wall_s": walls, "cpu_wall_s": want["wall"],
          "tracer_host_cost_s": got["wall"] - off["wall"],
          "host_clock": got["host"],
          "superopt_host_s": got["host"]["superopt_host_s"],
          "predictions": len(values),
          "predict_ms_mean": mean([p["ms"] for p in got["predictions"]]),
          "refits": len(losses),
          "refit_ms": [r["ms"] for r in got["refits"]],
          "refit_ms_mean": mean([r["ms"] for r in got["refits"]]),
          "refit_fit_steps": [r["fit_steps"] for r in got["refits"]],
          "act_batch_calls": len(got["acts"]),
          "max_prediction_rel_diff": pred_rel,
          "prediction_rtol": CONTROL_PRED_RTOL,
          "refit_losses": losses, "cpu_refit_losses": ref_losses,
          "max_refit_loss_rel_diff": loss_rel,
          "refit_loss_rtol": REFIT_LOSS_RTOL,
          "max_logp_diff": logp_diff,
          "min_top2_margin": min(want["margins"], default=None),
          "min_distance": {
              "hedge_overrun": min(got["hedge_distances"], default=None),
              "refit_threshold": min(got["refit_distances"], default=None),
              "refresh_threshold": min(got["refresh_distances"],
                                       default=None)},
          "launches": launched, "obs_off_identical": same_off,
          "breaker_rollback": breaker, "selftests": selftests,
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"control phase: {bad}")
    return launched


# ---------------------------------------------------------------- gen
def gen_run(device, explore):
    """bench_generalize's serving world, freshly sampled (its deltas
    mutate the db), served by a fresh seeded agent (hidden 96, the
    reference's weights) on GEN_LANES lanes under the world's own chaos
    and a retry ladder."""
    w = sample_world(GEN_SEED, **GEN_WORLD)
    agent = AqoraAgent(w.meta, AgentConfig(), seed=0, device=device)
    margins, acts = [], []
    if device == "cpu":
        record_margins(agent, margins)
    inner = agent.act_batch

    def counted(*a, **k):
        f0 = tree_conv.tree_cnn_fused_launches
        out = inner(*a, **k)
        acts.append(tree_conv.tree_cnn_fused_launches - f0)
        return out
    agent.act_batch = counted
    mgr = RecoveryManager(injector=w.fault_injector(),
                          retry=RetryPolicy(max_attempts=3, backoff=0.5))
    svc = QueryService(w.db, agent, n_lanes=GEN_LANES, policy="async",
                       explore=explore, recovery=mgr)
    sync(device)
    t0 = time.perf_counter()
    comps, _ = svc.run(w.stream)
    sync(device)
    return {"comps": comps, "wall": time.perf_counter() - t0,
            "versions": dict(w.db.versions), "acts": acts,
            "margins": margins, "recovery": mgr.stats.as_dict(),
            "feat_dim": w.meta.feat_dim}


def phase_gen(card=None):
    """A sampled world served greedy and then exploring, on the card and
    on the CPU: completions identical, table versions equal,
    log-probabilities within TOL, one encoder launch per act_batch."""
    tree_conv.tree_cnn_fused_launches = 0
    bad, rows = [], {}
    launches = 0
    for explore in (False, True):
        f0 = tree_conv.tree_cnn_fused_launches
        got = gen_run(card, explore)
        launches += tree_conv.tree_cnn_fused_launches - f0
        want = gen_run("cpu", explore)
        mode = "explore" if explore else "greedy"
        if completion_rows(got["comps"]) != completion_rows(want["comps"]):
            bad.append(f"{mode}: completions differ")
        _, logp_diff = compare_completions(got["comps"], want["comps"])
        if not logp_diff <= TOL:
            bad.append(f"{mode}: logps differ by {logp_diff}")
        if got["versions"] != want["versions"] or \
                got["recovery"] != want["recovery"]:
            bad.append(f"{mode}: versions {got['versions']} vs "
                       f"{want['versions']}, recovery {got['recovery']} vs "
                       f"{want['recovery']}")
        if not got["acts"] or any(n != 1 for n in got["acts"]):
            bad.append(f"{mode}: forward launches per act_batch "
                       f"{got['acts']}")
        rows[mode] = {"completed": len(got["comps"]),
                      "failed": sum(c.result.failed for c in got["comps"]),
                      "deltas": sum(got["versions"].values()),
                      "recovery": got["recovery"], "wall_s": got["wall"],
                      "cpu_wall_s": want["wall"],
                      "act_batch_calls": len(got["acts"]),
                      "max_logp_diff": logp_diff,
                      "min_top2_margin": min(want["margins"], default=None)}
    emit({"phase": "gen", "world_seed": GEN_SEED, **GEN_WORLD,
          "lanes": GEN_LANES, "feat_dim": got["feat_dim"], "runs": rows,
          "launches": {"tree_cnn_fused": launches},
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"gen phase: {bad}")
    return {"tree_cnn_fused": launches}


# ---------------------------------------------------------------- ablate
def ablate_deployment():
    """The ablation experiment's deployment (`experiments/ablations.py`,
    `run_all`): the ExtJOB-like db at main_experiment's SCALE (0.4) and
    `make_workload("extjob", n_train=120, n_test_per_template=2,
    seed=7)`: F = 19, 10 tables, 24 test queries."""
    db = main_experiment.make_db("extjob", 0)
    wl = workloads.make_workload("extjob", **ABLATE_WORKLOAD)
    return db, wl, WorkloadMeta.from_workload(wl)


def ablate_encoder(db, wl, meta, net):
    """One encoder of the ablation: a fresh seeded agent on the card and
    on the CPU (equal leaf for leaf), `train_agent` on each, the CPU's
    trained state installed on the card, greedy `evaluate` on each."""
    bad = []
    cfg = AgentConfig(net=net)
    agents = {dev: AqoraAgent(meta, cfg, seed=0, device=dev)
              for dev in (None, "cpu")}
    gpu, cpu = agents[None], agents["cpu"]
    a, b = leaves_of(gpu), leaves_of(cpu)
    if set(a) != set(b) or not all(np.array_equal(a[k], v)
                                   for k, v in b.items()):
        bad.append(f"{net}: a fresh seeded agent differs on the card")

    act_s, update_ms, batches = [], [], []
    act_inner, ppo_inner = gpu.act_batch, gpu.ppo_update_batch

    def act_batch(feat, left, right, mask, amask, keys, explore=True):
        t0 = time.perf_counter()
        out = act_inner(feat, left, right, mask, amask, keys,
                        explore=explore)
        act_s.append(time.perf_counter() - t0)
        if not batches:
            batches.append(tuple(np.copy(x) for x in
                                 (feat, left, right, mask, amask, keys)))
        return out

    def ppo_update_batch(trajs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ppo_inner(trajs)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return m
    gpu.act_batch, gpu.ppo_update_batch = act_batch, ppo_update_batch

    est = Estimator(db, db.stats)
    t0 = time.perf_counter()
    _, logs = train_agent(db, wl, episodes=ABLATE_EPISODES,
                          batch_size=N_LANES, seed=0, est=est, agent=gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cpu_logs = train_agent(db, wl, episodes=ABLATE_EPISODES,
                              batch_size=N_LANES, seed=0, est=est, agent=cpu)
    cpu_wall = time.perf_counter() - t0
    first = [(l.query, l.actions, l.latency, l.failed)
             for l in logs[:N_LANES]]
    if first != [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu_logs[:N_LANES]]:
        bad.append(f"{net}: first episode-batch differs")
    loss_rel = {k: abs(getattr(logs[0], k) - getattr(cpu_logs[0], k))
                / max(abs(getattr(cpu_logs[0], k)), 1e-12)
                for k in ("actor_loss", "critic_loss")}
    if not max(loss_rel.values()) <= TRAIN_LOSS_RTOL:
        bad.append(f"{net}: first update's losses differ by {loss_rel}")
    if not params_finite(gpu) or not all(
            np.isfinite(v).all() for v in leaves_of(gpu).values()):
        bad.append(f"{net}: a trained leaf is not finite")

    # greedy evaluation from one state: the CPU's, installed on the card
    gpu.act_batch, gpu.ppo_update_batch = act_inner, ppo_inner
    install_agent_state(gpu, agent_state(cpu))
    margins = []
    record_margins(cpu, margins)
    sync(None)
    t0 = time.perf_counter()
    rows = evaluate(db, wl.test, gpu, est=est)
    sync(None)
    eval_wall = time.perf_counter() - t0
    cpu_rows = evaluate(db, wl.test, cpu, est=est)
    keys = ("query", "actions", "latency", "failed", "shuffles", "bushy")
    if [[r[k] for k in keys] for r in rows] != \
            [[r[k] for k in keys] for r in cpu_rows]:
        bad.append(f"{net}: greedy evaluation differs")
    row = {"train_wall_s": wall, "cpu_train_wall_s": cpu_wall,
           "act_batch_calls": len(act_s),
           "act_batch_ms_mean": float(np.mean(act_s)) * 1e3,
           "act_batch_ms_median": float(np.median(act_s)) * 1e3,
           "act_batch_node_dim": gpu._trim(batches[0][3].sum(axis=1)),
           "ppo_updates": len(update_ms), "ppo_update_ms": update_ms,
           "first_update_loss_rel_diff": loss_rel,
           "eval_wall_s": eval_wall,
           "eval_failed": sum(r["failed"] for r in rows),
           "eval_latency_sum": float(sum(r["latency"] for r in rows)),
           "min_top2_margin": min(margins)}
    return row, bad, (gpu, batches[0])


def ablate_dqn(db, wl, meta):
    """`DQNAgent` through `train_agent(agent=dqn)`, serial, on the card
    and on the CPU: the episodes before the first train step identical,
    the first train step's loss within DQN_LOSS_RTOL; each greedy `act`
    on the card one forward launch, each train step two forward launches
    (q-net and target, B = 64, N = 64) and one backward call."""
    bad, runs = [], {}
    for dev in (None, "cpu"):
        dqn = DQNAgent(meta, AgentConfig(), seed=0, device=dev)
        rec = {"losses": [], "steps": [], "acts": [], "margins": [],
               "step_ms": []}
        q_inner, step_inner, act_inner = dqn._q, dqn.train_step, dqn.act
        q_calls = []

        def q(enc, q_inner=q_inner, q_calls=q_calls):
            out = q_inner(enc)
            q_calls.append(out)
            return out

        def act(enc, amask, explore=True, rec=rec, act_inner=act_inner,
                q_calls=q_calls):
            f0 = tree_conv.tree_cnn_fused_launches
            n0 = len(q_calls)
            out = act_inner(enc, amask, explore=explore)
            if len(q_calls) > n0:          # the greedy branch ran the net
                s = np.where(np.asarray(amask) > 0, q_calls[-1], -np.inf)
                top = np.sort(s)[-2:]
                rec["margins"].append(float(top[1] - top[0]))
            rec["acts"].append((len(q_calls) - n0,
                                tree_conv.tree_cnn_fused_launches - f0))
            return out

        def train_step(rec=rec, step_inner=step_inner, dev=dev):
            f0 = tree_conv.tree_cnn_fused_launches
            b0 = tree_conv.tree_cnn_fused_bwd_launches
            sync(dev)
            t0 = time.perf_counter()
            loss = step_inner()
            sync(dev)
            if loss != 0.0:
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss)
            rec["steps"].append((loss != 0.0,
                                 tree_conv.tree_cnn_fused_launches - f0,
                                 tree_conv.tree_cnn_fused_bwd_launches - b0))
            return loss
        dqn._q, dqn.act, dqn.train_step = q, act, train_step
        sync(dev)
        t0 = time.perf_counter()
        _, logs = train_agent(db, wl, episodes=DQN_EPISODES, seed=0,
                              est=Estimator(db, db.stats), agent=dqn)
        sync(dev)
        rec["wall"] = time.perf_counter() - t0
        rec["logs"] = logs
        rec["buffer"] = len(dqn.buffer)
        runs["card" if dev is None else "cpu"] = rec
    card, cpu = runs["card"], runs["cpu"]
    firsts = [next((i for i, l in enumerate(r["losses"]) if l != 0.0), None)
              for r in (card, cpu)]
    if firsts[0] is None or firsts[0] != firsts[1]:
        bad.append(f"dqn: first train steps {firsts}")
        first = None
    else:
        first = firsts[0]
        before = first // 4 + 1             # 4 train steps an episode
        if [(l.query, l.actions, l.latency, l.failed)
                for l in card["logs"][:before]] != \
                [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu["logs"][:before]]:
            bad.append("dqn: the episodes before the first train step "
                       "differ")
        rel = abs(card["losses"][first] - cpu["losses"][first]) / \
            max(abs(cpu["losses"][first]), 1e-12)
        if not rel <= DQN_LOSS_RTOL:
            bad.append(f"dqn: first train step's loss differs by {rel}")
    if any(n != q for q, n in card["acts"]) or not any(q for q, _ in
                                                       card["acts"]):
        bad.append(f"dqn: forward launches per act {card['acts']}")
    if any((f, b) != ((2, 2) if ran else (0, 0))
           for ran, f, b in card["steps"]):
        bad.append(f"dqn: launches per train step {card['steps']}")
    row = {"episodes": DQN_EPISODES, "wall_s": card["wall"],
           "cpu_wall_s": cpu["wall"], "buffer": card["buffer"],
           "first_train_step": first,
           "first_loss": None if first is None else card["losses"][first],
           "first_loss_rel_diff": None if first is None else rel,
           "train_steps_run": len(card["step_ms"]),
           "train_step_ms_mean": float(np.mean(card["step_ms"]))
           if card["step_ms"] else None,
           "greedy_acts": sum(q for q, _ in card["acts"]),
           "acts": len(card["acts"]),
           "episodes_with_equal_actions": sum(
               a.actions == b.actions
               for a, b in zip(card["logs"], cpu["logs"])),
           "min_q_margin": min(cpu["margins"], default=None)}
    return row, bad


def score_margins(cls, margins):
    """Wrap `cls.choose` (a baseline's) so that each call appends the
    smallest gap its decision rests on: for Lero's argmin, the best score
    against the best of the candidates whose features differ from its
    own (equal features score equal on any device); for AutoSteer's
    greedy search, each prediction against the best so far. Returns the
    undo."""
    inner, score_inner = cls.choose, cls._score

    def choose(self, query):
        seen = []

        def score(x):
            seen.append((np.asarray(x).tobytes(), score_inner(self, x)))
            return seen[-1][1]
        self._score = score
        try:
            out = inner(self, query)
        finally:
            del self._score
        if cls is LeroOptimizer:
            best = min(seen, key=lambda fs: fs[1])
            rest = [s for f, s in seen if f != best[0]]
            if rest:
                margins.append(min(rest) - best[1])
        else:
            best = seen[0][1]
            for _, p in seen[1:]:
                margins.append(abs(p - best))
                best = min(best, p)
        return out
    cls.choose = choose
    return lambda: setattr(cls, "choose", inner)


def ablate_bench():
    """`main_experiment.run_bench("extjob", episodes=ABLATE_EPISODES,
    batch_size=8)` on the card (the default device) and on the CPU, its
    results under build/: Spark, Lero and AutoSteer rows identical but
    for their wall-clock fields, AQORA's first episode-batch identical."""
    bad, outs, walls = [], {}, {}
    margins = {"lero": [], "autosteer": []}
    for dev in (None, "cpu"):
        side = "card" if dev is None else "cpu"
        main_experiment.RESULTS = ROOT / "build" / "chip_smoke_results" / side
        undo = []
        if dev == "cpu":
            undo = [score_margins(LeroOptimizer, margins["lero"]),
                    score_margins(AutoSteerOptimizer, margins["autosteer"])]
        t0 = time.perf_counter()
        try:
            outs[side] = main_experiment.run_bench(
                "extjob", episodes=ABLATE_EPISODES, batch_size=N_LANES,
                quiet=True, device=dev)
        finally:
            for u in undo:
                u()
        sync(dev)
        walls[side] = time.perf_counter() - t0
    card, cpu = outs["card"], outs["cpu"]
    if card["spark"] != cpu["spark"]:
        bad.append("bench: Spark rows differ")
    for system in ("lero", "autosteer"):
        strip = [[{k: v for k, v in r.items() if k not in WALL_CLOCK}
                  for r in o[system]] for o in (card, cpu)]
        if strip[0] != strip[1] or not strip[0]:
            bad.append(f"bench: {system} rows differ")
    if card["aqora_training"][:N_LANES] != cpu["aqora_training"][:N_LANES]:
        bad.append("bench: AQORA's first episode-batch differs")
    if not (ROOT / "build" / "chip_smoke_results" / "card" /
            "extjob.json").exists():
        bad.append("bench: no results file")

    def total(rows, key="latency"):
        return float(sum(r[key] for r in rows))
    row = {"episodes": ABLATE_EPISODES,
           "baseline_episodes": main_experiment.BASELINE_EPISODES,
           "wall_s": walls["card"], "cpu_wall_s": walls["cpu"],
           "test_queries": len(card["spark"]),
           "latency_sum": {s: total(card[s]) for s in
                           ("spark", "lero", "autosteer", "aqora")},
           "failed": {s: sum(r["failed"] for r in card[s]) for s in
                      ("spark", "lero", "autosteer", "aqora")},
           "aqora_equal_to_cpu": [a["actions"] == b["actions"]
                                  for a, b in zip(card["aqora"],
                                                  cpu["aqora"])].count(True),
           "min_lero_margin": min(margins["lero"], default=None),
           "min_autosteer_margin": min(margins["autosteer"], default=None)}
    return row, bad


def phase_ablate():
    """The paper's comparison surface (Fig. 7, Fig. 9, Fig. 11, Tab. III)
    at the ablation experiment's deployment, nothing cut in width: (a)
    the LSTM, FCNN and QueryFormer agents trained (ABLATE_EPISODES
    episodes in batches of 8) and evaluated greedily on the card and the
    CPU; (b) the DQN agent through DQN_EPISODES serial episodes on each;
    (c) `main_experiment.run_bench` on each. Episode counts are cut
    (ablations.py trains 300 episodes, main_experiment 400 for ExtJOB and
    60 baseline episodes, which run_bench keeps); widths are not. Every
    case is checked before any fails. Returns the phase's kernel
    launches (every count set to 0 at its start)."""
    fa.launches = ms.launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    db, wl, meta = ablate_deployment()
    bad, rows, profiled = [], {}, {}
    for net in ("lstm", "fcnn", "queryformer"):
        rows[net], b, profiled[net] = ablate_encoder(db, wl, meta, net)
        bad += b
    rows["dqn"], b = ablate_dqn(db, wl, meta)
    bad += b
    rows["bench"], b = ablate_bench()
    bad += b
    launched = dict(counts(),
                    tree_cnn_fused_bwd=tree_conv.tree_cnn_fused_bwd_launches)
    for k in ("tree_cnn_fused", "tree_cnn_fused_bwd"):
        if not launched[k]:
            bad.append(f"{k} never launched in the ablate phase")
    emit({"phase": "ablate", "feat_dim": meta.feat_dim,
          "tables": meta.n_tables_max, **ABLATE_WORKLOAD,
          "scale": main_experiment.SCALE, "runs": rows,
          "launches": launched, "identical_to_cpu": not bad,
          "mismatches": bad})
    if bad:
        raise AssertionError(f"ablate phase: {bad}")
    return launched, profiled


def ablate_profile(profiled):
    """Device kernels and device ms of one greedy `act_batch` of each
    encoder on its first training batch, by torch.profiler (taken after
    the ops phase, whose own profiler readings come first)."""
    out = {}
    for net, (agent, (feat, left, right, mask, amask, keys)) in \
            profiled.items():
        def call():
            agent.act_batch(feat, left, right, mask, amask, keys,
                            explore=False)
        call()
        kernels = device_kernels(call, calls=5)
        out[net] = {"device_kernels_per_act_batch": len(kernels) / 5,
                    "device_ms_per_act_batch":
                        sum(t for _, t in kernels) / 5,
                    "node_dim": agent._trim(mask.sum(axis=1))}
    return out


def phase_late_profiles(bwd_timing, agent, trajs, ablate_profiled):
    """The torch.profiler readings of the training path, taken after the
    ops phase (whose own profiler readings come first in the process):
    the backward kernel's device time at the PPO and DQN shapes, one PPO
    update's device busy time and idle share; then the `ablate_profile`
    line, each ablation encoder's device kernels an `act_batch`."""
    bwd = {}
    for case, t in bwd_timing.items():
        calls = 20
        kernels = device_kernels(t["launch"], calls)
        bwd[case] = {"device_ms": sum(ms for _, ms in kernels) / calls,
                     "device_kernels_per_call": len(kernels) / calls,
                     **{k: t[k] for k in ("ms", "bound_ms", "cluster",
                                          "blocks_per_sm",
                                          "max_active_clusters")}}
    emit({"phase": "train_profile", "backward_kernel": bwd,
          "ppo_update": profile_update(agent, trajs)})
    emit({"phase": "ablate_profile", "act_batch": ablate_profile(
        ablate_profiled)})


def profile_update(agent, trajs):
    """One PPO update under torch.profiler: the device's busy time by
    kernel and its idle share of the update's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    agent.ppo_update_batch(trajs)              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.ppo_update_batch(trajs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    durs = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            durs.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(((k, sum(v) / 1e3, len(v)) for k, v in durs.items()),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_kernels": sum(r[2] for r in rows),
            "by_kernel": [{"name": k[:80], "ms": t, "count": n}
                          for k, t, n in rows[:10]]}


def phase_profile(db, wl, meta, params):
    from torch.profiler import ProfilerActivity, profile
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    agent = make_agent(meta, None, params)
    agent.act_batch(*serving_batch(db, wl, meta),             # warm-up
                    np.ones((N_LANES, agent.space.d), np.float32),
                    np.zeros((N_LANES, 2), np.uint32), explore=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        QueryService(db, agent, n_lanes=N_LANES, policy="async").run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    durs = {}                                 # device-side events only
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            durs.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(((k, sum(v) / 1e3, len(v), float(np.median(v)))
                   for k, v in durs.items()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "wall_s": wall, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "by_kernel": [{"name": k[:80], "ms": ms, "count": n,
                         "median_us": med} for k, ms, n, med in rows[:12]]})


# -------------------------------------------------------------- rng phase
# The seeded build through the threefry kernel (kernels/threefry.py):
# qwen3-8b at full width and depth from prng_key(0), the reference's
# `init_params(PRNGKey(0))`. Each leaf the build draws is held to the
# kernel's plain version (`ref.random_normal_ref`, on the CPU) on three
# RNG_SLICE-element slices (the first key's first, the middle key's
# middle, the last key's last), bit for bit: 0 mismatched words allowed.
# Two planted faults must be refused by the same check: one element an
# ulp off, and the plain version with one Threefry rotation constant
# wrong. Then the full draw's time: the kernel relaunched into the
# build's own leaves (CUDA events over every leaf's launch), the plain
# version on the card in RNG_PLAIN_CHUNK-element slices, and
# `torch.Tensor.normal_` (which draws other numbers: Philox) on the same
# leaves. Each bound is the larger of the output's bytes at 3.35 TB/s and
# instructions a draw issued at one warp instruction a clock on each of
# an SM's 4 schedulers at the card's top SM clock: the function's
# operations (`work.THREEFRY_DRAW`, an FMA as one; the kernels line's
# bound) or the compiled kernel's (`cuobjdump -sass`, the common path).
# Then the Gumbel kernel at a sampled decode step's (B, V) =
# (LM_REQUESTS, qwen3-8b's vocabulary), key split(prng_key(LM_SAMPLE_SEED))
# [1]: bit for bit against the plain version on the CPU, timed beside the
# plain version on the card and the same two bounds.
RNG_ARCH = "qwen3-8b"
RNG_SLICE = 1 << 16
RNG_PLAIN_CHUNK = 1 << 25
RNG_BAD_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 25))   # 24 -> 25
SCHEDULERS_PER_SM, WARP = 4, 32
SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass_path_instructions(library, function) -> dict:
    """The instructions of the kernel whose mangled name holds
    `function`, from `cuobjdump -sass` of its library: on its common path
    (from the entry to the first unpredicated EXIT; a rare branch such as
    a division's slow path is a predicated CALL there, its body past the
    EXIT), and in all, NOPs left out of both."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = pathlib.Path(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if function not in name:
            continue
        ops = [m.group(1) for m in map(SASS_LINE.match, body.splitlines())
               if m and not m.group(1).startswith("NOP")]
        path = next(i for i, op in enumerate(ops) if op == "EXIT") + 1
        return {"function": name.strip(), "path": path, "all": len(ops)}
    raise AssertionError(f"no {function} in {library}")


def issue_ms(instructions, draws) -> float:
    """`draws` threads of `instructions` each, issued one warp
    instruction a clock on each of the card's schedulers at its top SM
    clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions * draws / WARP / (
        sms * SCHEDULERS_PER_SM * sm_clock_hz()) * 1e3


def draw_bounds(kind, draws, itemsize, kernel) -> dict:
    """The bounds of `draws` draws of the threefry kernel `kind`: bytes,
    the function's operations and the compiled kernel's instructions."""
    sass = sass_path_instructions(build.library_path("threefry"), kernel)
    byte_ms = itemsize * draws / HBM_BYTES_PER_S * 1e3
    fn_ms = issue_ms(work.THREEFRY_DRAW[kind][0], draws)
    sass_ms = issue_ms(sass["path"], draws)
    return {"bound_ms": max(fn_ms, byte_ms),
            "bound_by": "operations" if fn_ms >= byte_ms else "bytes",
            "bytes_bound_ms": byte_ms, "issue_bound_ms": fn_ms,
            "function_ops": work.THREEFRY_DRAW[kind][0],
            "sass_bound_ms": max(sass_ms, byte_ms), "sass_issue_ms": sass_ms,
            "sass": sass}


class DrawTap:
    """Stands in for one function of a module while the main path runs:
    calls it and keeps (keys, n, keyword arguments but the device, result)
    of each call. The calls launch what they launched before."""

    def __init__(self, module, name, clone=False):
        self.module, self.name, self.clone = module, name, clone
        self.fn, self.calls = getattr(module, name), []

    def __enter__(self):
        def record(keys, n, **kw):
            out = self.fn(keys, n, **kw)
            self.calls.append((np.array(keys), n,
                               {k: v for k, v in kw.items() if k != "device"},
                               out.clone() if self.clone else out))
            return out
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def words(t):
    t = t.detach().cpu()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def rng_slices(L, n):
    """(key row, offset, length) of a leaf's three checked slices."""
    m = min(RNG_SLICE, n)
    return [(0, 0, m), (L // 2, (n - m) // 2, m), (L - 1, n - m, m)]


RNG_BATCH = 32             # plain-version slices drawn in one call


def rng_leaf_slices(calls):
    """Every drawn leaf's three slices, read from the card now. Returns a
    function that draws each slice with the plain version on the CPU,
    RNG_BATCH slices a call (each key's own offset and stddev: fewer,
    larger ops), and compares them: rows of mismatched words a leaf (0
    allowed). The function touches only CPU tensors, so it may run in a
    thread beside the card's work."""
    jobs = []
    for keys, n, kw, out in calls:
        flat = keys.reshape(-1, 2)
        leaf = out.view(len(flat), n)
        for row, at, m in rng_slices(len(flat), n):
            jobs.append((len(jobs) // 3, flat[row].astype(np.int64),
                         kw.get("offset", 0) + at, m,
                         float(np.float32(kw.get("stddev", 1.0))),
                         leaf[row, at:at + m].cpu()))

    def compare():
        mism = [0] * len(calls)
        err = [0.0] * len(calls)
        by_len = {}
        for job in jobs:
            by_len.setdefault(job[3], []).append(job)
        for m, group in by_len.items():
            for a in range(0, len(group), RNG_BATCH):
                part = group[a:a + RNG_BATCH]
                want = ref.random_normal_ref(
                    torch.from_numpy(np.stack([j[1] for j in part])), m,
                    offset=torch.tensor([j[2] for j in part]),
                    stddev=torch.tensor([j[4] for j in part],
                                        dtype=torch.float32))
                for j, w in zip(part, want):
                    got = j[5]
                    w = w.to(got.dtype)
                    mism[j[0]] += int((words(got) != words(w)).sum())
                    err[j[0]] = max(err[j[0]], float(
                        (got.float() - w.float()).abs().max()))
        return [{"shape": list(out.shape),
                 "dtype": str(out.dtype).replace("torch.", ""),
                 "stddev": kw.get("stddev", 1.0), "draws": out.numel(),
                 "checked": 3 * min(RNG_SLICE, n), "mismatches": mism[i],
                 "max_abs_err": err[i]}
                for i, (keys, n, kw, out) in enumerate(calls)]
    return compare


def rng_leaf_checks(calls):
    """Every drawn leaf's three slices against the plain version on the
    CPU (`rng_leaf_slices`), then the two planted faults on the first
    leaf's first slice."""
    rows = rng_leaf_slices(calls)()
    keys, n, kw, out = calls[0]
    m = min(RNG_SLICE, n)
    got0 = words(out.view(-1, n)[0, :m].cpu())
    plain0 = words(threefry.normal(keys.reshape(-1, 2)[0], m, device="cpu",
                                   **kw))
    off_by_ulp = got0.clone()
    off_by_ulp[len(off_by_ulp) // 3] += 1
    saved = prng._ROTATIONS
    prng._ROTATIONS = RNG_BAD_ROTATIONS
    try:
        bad_rotation = words(threefry.normal(
            keys.reshape(-1, 2)[0], m, device="cpu", **kw))
    finally:
        prng._ROTATIONS = saved
    planted = {"off_by_one_ulp": int((off_by_ulp != plain0).sum()),
               "rotation_24_to_25": int((got0 != bad_rotation).sum())}
    return rows, planted


def rng_times(calls):
    """The full draw's ms by CUDA events: the kernel relaunched into the
    build's leaves (no wrapper: no count), the plain version on the card
    and `normal_` on the same leaves (overwriting them)."""
    fn = threefry._library("threefry_normal")
    stream = torch.cuda.current_stream().cuda_stream
    launches = []
    for keys, n, kw, out in calls:
        dk = threefry._device_keys(keys, "cuda")
        launches.append((dk, n, float(np.float32(kw.get("stddev", 1.0))),
                         out, int(out.dtype == torch.bfloat16)))

    def kernel():
        for dk, n, stddev, out, bf16 in launches:
            err = fn(dk.data_ptr(), dk.shape[0], n, 0, stddev,
                     out.data_ptr(), bf16, stream)
            if err:
                raise RuntimeError(f"threefry_normal: CUDA error {err}")

    def plain():
        for dk, n, stddev, out, _ in launches:
            for row in dk.long() & 0xFFFFFFFF:     # the uint32 words
                for at in range(0, n, RNG_PLAIN_CHUNK):
                    ref.random_normal_ref(row, min(RNG_PLAIN_CHUNK, n - at),
                                          at, stddev)

    def library():
        for _, _, stddev, out, _ in launches:
            out.normal_(0.0, stddev)
    ms_kernel = cuda_ms(kernel, launches=1, reps=3, warmup=1)
    ms_plain = cuda_ms(plain, launches=1, reps=1, warmup=0)
    ms_library = cuda_ms(library, launches=1, reps=3, warmup=1)
    return ms_kernel, ms_plain, ms_library


def phase_rng():
    """The seeded full-width build through the threefry kernel (the
    section's comment). Every check runs before any fails. Returns the
    phase's launches, its kernels-line row and the lm phase's build
    reading."""
    bad = []
    cfg = registry.get_config(RNG_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    threefry.normal_launches = threefry.gumbel_launches = 0
    with DrawTap(threefry, "normal") as tap:
        params = lm.init_params(prng.prng_key(0), cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launched = threefry.normal_launches
    if launched != len(tap.calls) or launched == 0:
        bad.append(f"the build launched {launched} for {len(tap.calls)} "
                   f"leaves")
    draws = sum(out.numel() for _, _, _, out in tap.calls)
    if draws + sum(t.numel() for k, t in flatten(params)
                   if k.endswith(("scale", "bias"))) != cfg.param_count():
        bad.append(f"drew {draws} of {cfg.param_count()} parameters")
    t0 = time.perf_counter()
    leaves, planted = rng_leaf_checks(tap.calls)
    check_s = time.perf_counter() - t0
    bad += [f"leaf {r}" for r in leaves if r["mismatches"]]
    bad += [f"planted fault {k} not refused"
            for k, v in planted.items() if v == 0]
    finite = all(bool(torch.isfinite(out).all()) for *_, out in tap.calls)
    if not finite:
        bad.append("a drawn leaf is not finite")
    ms_kernel, ms_plain, ms_library = rng_times(tap.calls)
    bounds = draw_bounds("normal", draws, 4, "normal_kernelIf")
    source = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/threefry.cu"}
    normal_row = {
        "name": "threefry_normal", **source,
        "replaces": "none: jax.random.normal in src/repro/models/common.py:14",
        "launches": launched,
        "max_abs_err": max(r["max_abs_err"] for r in leaves),
        "ms": ms_kernel, "plain_ms": ms_plain,
        **{k: bounds[k] for k in ("bound_ms", "bound_by")},
        "library_ms": ms_library, "case": f"{RNG_ARCH}/full-draw"}
    del params, tap
    torch.cuda.empty_cache()
    gumbel_row, gumbel = gumbel_step(cfg, bad)
    emit({"phase": "rng", "arch": RNG_ARCH, "params": cfg.param_count(),
          "draws": draws, "leaves_drawn": len(leaves),
          "build_s": build_s, "launches": {"threefry_normal": launched},
          "ms": ms_kernel, "plain_ms": ms_plain,
          "library_ms": ms_library,
          "library_note": "torch.Tensor.normal_(0, stddev) on each leaf: "
                          "Philox, other numbers",
          **bounds, "sm_clock_max_mhz": sm_clock_hz() / 1e6,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "kernel_over_bound": ms_kernel / bounds["bound_ms"],
          "kernel_over_sass_bound": ms_kernel / bounds["sass_bound_ms"],
          "draws_per_ns": draws / ms_kernel / 1e6,
          "leaf_checks": leaves, "check_s": check_s,
          "planted_mismatches": planted, "finite": finite,
          "gumbel": gumbel,
          "nvidia_smi": nvidia_smi(), "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"rng phase: {bad}")
    return {"threefry_normal": launched}, [normal_row, {
        "name": "threefry_gumbel", **source,
        "replaces": "none: jax.random.categorical in "
                    "src/repro/launch/serve.py:61", **gumbel_row}]


def gumbel_step(cfg, bad):
    """The Gumbel kernel at a sampled decode step's (B, V): its noise
    against the plain version on the CPU (0 mismatched words), its time
    (the kernel relaunched, no wrapper: no count), the plain version's on
    the card and the bounds. Returns the kernels-line fields and the
    phase line's reading."""
    B, V = LM_REQUESTS, cfg.vocab_size
    n = B * V
    key = prng.split(prng.prng_key(LM_SAMPLE_SEED))[1]
    dk = threefry._device_keys(key, "cuda")
    out = torch.empty(n, dtype=torch.float32, device="cuda")
    fn = threefry._library("threefry_gumbel")
    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        err = fn(dk.data_ptr(), 1, n, 0, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"threefry_gumbel: CUDA error {err}")
    kernel()
    got = out.cpu()
    want = threefry.gumbel(key, n, device="cpu")
    mism = int((words(got) != words(want)).sum())
    err = float((got - want).abs().max())
    if mism:
        bad.append(f"gumbel at ({B}, {V}): {mism} mismatched words")
    row = dk.long() & 0xFFFFFFFF                  # the uint32 words
    ms_kernel = cuda_ms(kernel, launches=20, warmup=3)
    ms_plain = cuda_ms(lambda: ref.random_gumbel_ref(row, n),
                       launches=1, reps=3, warmup=1)
    bounds = draw_bounds("gumbel", n, 4, "gumbel_kernel")
    fields = {"max_abs_err": err, "ms": ms_kernel, "plain_ms": ms_plain,
              **{k: bounds[k] for k in ("bound_ms", "bound_by")},
              "library_ms": None,
              "library_note": "none: no one PyTorch call draws Gumbel noise",
              "case": f"{cfg.name}/sampled-step/B{B}"}
    return fields, {"shape": [B, V], "mismatched_words": mism,
                    "max_abs_err": err, "ms": ms_kernel,
                    "plain_ms": ms_plain, **bounds,
                    "kernel_over_bound": ms_kernel / bounds["bound_ms"],
                    "kernel_over_sass_bound":
                        ms_kernel / bounds["sass_bound_ms"]}


# --------------------------------------------------------------- lm phase
# The LM serving path (`launch.serve.BatchedServer`) at the published
# configs (src/repro_torch/configs), weights from prng_key(0) through the
# threefry kernel, drawn as the server's bf16 serving copy: LM_REQUESTS
# prompts of LM_PROMPT tokens from default_rng(0) in [2, vocab), then
# LM_GEN greedy tokens. (arch, layers kept, None for the published depth):
# the depth cut only where the bf16 weights would not leave the phase's
# transients room on the card's 80 GB: llama-3.2-vision-90b's 100 layers
# (87.67 B parameters) to 30, six superblocks (27.8 B, 55.6 GB),
# llama4-scout's 48 (107.77 B) to 12, three superblocks (28.5 B, 57.0 GB),
# and dbrx-132b's 40 (3.26 B a layer, 1.23 B outside the stack) to 8
# (27.3 B, 54.6 GB; its MoE dispatch at 8 x 128 tokens, 16 experts top-4:
# a 63 MB capacity buffer and ~0.45 GB of expert activations a layer).
# minicpm3-4b (4.07 B, 8.1 GB; MLA, whose v head width differs from its
# q/k width, takes the models' torch attention: no kernel launch) and
# qwen1.5-4b (3.95 B, 7.9 GB; MHA with QKV bias) whole. jamba-1.5-large
# is not served: one superblock of its pattern is 44.16 B parameters,
# 88.3 GB.
LM_CELLS = (("qwen3-8b", None), ("falcon-mamba-7b", None),
            ("gemma2-27b", None), ("whisper-tiny", None),
            ("llama-3.2-vision-90b", 30), ("llama4-scout-17b-a16e", 12),
            ("minicpm3-4b", None), ("qwen1.5-4b", None), ("dbrx-132b", 8))
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 128, 32
# the attention calls held to the plain version: of each kind (causal,
# window, bidirectional) the first at the prefill and at the decode steps
# that read 129 and 160 keys (layer 0's; the local and the global layer's
# at gemma2), and the first bidirectional call of each (Sq, Sk): whisper's
# encoder over its 1500 frames, the cross layers at the prefill and at a
# decode step over 1500 (whisper) or 1600 (llama-vision) memory tokens.
# The server feeds llama-vision zero patch embeddings, whose k and v are
# 0: its cross layers' calls are recorded from one more prefill and
# decode step of the served model over a memory from LM_MEMORY_SEED.
LM_ATTN_SK = (LM_PROMPT, LM_PROMPT + 1, LM_PROMPT + LM_GEN)
LM_MEMORY_SEED = 2
# Each call at the ops phase's limits (ATTN_BF16) by the keys its rows
# see: the decode limit is stated for rows that see 4093 to 4096 keys
# (the ops phase's decode cases), over which the kernel's bf16 rounding of
# P for the P.V product averages out; a row that sees fewer keys, as
# every prefill row and the decode rows at LM_PROMPT + 1 to LM_PROMPT +
# LM_GEN or over the cross layers' memory do, takes the limit stated for
# rows with few keys, the prefill's. (At gemma2-27b's and
# llama-vision's decode over 129 and 160 keys, where layer 0's
# attention falls on a few keys, the kernel needed 1.1e-3 to 1.5e-3 of
# v's std: above the decode atol, within the prefill's.)
ATTN_DECODE_KEYS = 4093
# gemma2-27b's window (4096) cuts no key at LM_PROMPT + LM_GEN: one more
# greedy generate of (requests, prompt, gen) tokens, in which the window
# cuts keys at the prefill and at every decode step. Its local and global
# calls at the prefill and the first and last decode steps are held to
# the plain version on their last LM_CHECK_ROWS query rows (right-aligned:
# each sees the window cut), the plain version's scores a few GB beside
# 54.5 GB of weights.
LM_LONG = {"gemma2-27b": (2, 6144, 8)}
LM_CHECK_ROWS = 1024
# a call over more keys than LM_LONG_SK: its rows read thousands of keys,
# where one key is lost in the rounding; its planted faults drop a whole
# 128-key tile of the wgmma kernel (the most recent keys, or the first,
# or, past the window, the window itself)
LM_LONG_SK = 1024
LM_FAULT_TILE = 128
# card against CPU: the first superblocks of the same weights, at least
# LM_CPU_LAYERS layers (a whole superblock: 4 at llama4, 5 at
# llama-vision), LM_CPU_REQUESTS prompts cut to LM_CPU_PROMPT tokens,
# LM_CPU_STEPS decode steps fed the CPU's sampled tokens. Both sides
# compute in the config's bf16 and round it at other places (cuBLAS
# against the CPU's GEMMs, the kernel's P rounded to bf16 for P.V
# against the plain version's fp32 softmax): every logit within
# LM_LOGIT_RTOL of the CPU's largest |logit|, the bf16 limit the CPU
# tests hold the port to against the reference (tests/torch_lm_cases.py);
# greedy tokens equal wherever the CPU's top-2 margin exceeds twice that.
# The cross-attention's memory (whisper: its frames, through the encoder)
# comes from LM_MEMORY_SEED, and llama-vision's every `xgate` is
# LM_CPU_XGATE in both copies: with the server's zero memory and zero
# gates the cross layers would not reach the logits. An MoE layer on the
# card takes the experts the CPU chose, with its own gates (a token near
# a tie of router probabilities would go to another expert where bf16
# rounds the other way); the smallest router top-2 margin is printed.
LM_CPU_LAYERS, LM_CPU_REQUESTS, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 2, 32, 4
LM_CPU_XGATE = 0.5
LM_LOGIT_RTOL = 3e-2
# the serving build holds nothing beside the serving copy: its peak
# within LM_BUILD_SLACK_GB of what the server keeps
LM_BUILD_SLACK_GB = 1.0
# sampled decoding (`generate(greedy=False, seed=LM_SAMPLE_SEED)`): the
# Gumbel noise the kernel draws at a generate's first and last decode
# steps equal to the plain version's bit for bit; in the card-vs-CPU
# comparison each step's sampled token argmax(logits + noise), the same
# keys on both sides, equal wherever the CPU's top-2 margin of logits plus
# noise exceeds twice the largest card-vs-CPU logit error
LM_SAMPLE_SEED = 1
LM_PROFILED = 4            # the last decode steps, under torch.profiler


class Recorder:
    """Stands in for one `kernels.ops` function while the main path runs:
    calls it and keeps the arguments and result of the calls `keep`
    picks. The calls launch what they launched before."""

    def __init__(self, name, keep):
        self.name, self.keep, self.calls = name, keep, {}
        self.fn = getattr(ops, name)

    def __enter__(self):
        def record(*args, **kw):
            out = self.fn(*args, **kw)
            key = self.keep(*args, **kw)
            if key is not None and key not in self.calls:
                self.calls[key] = (tuple(a.clone() if torch.is_tensor(a)
                                         else a for a in args),
                                   {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in kw.items()},
                                   out)
            return out
        setattr(ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.fn)


def attention_kind(kw) -> str:
    """An `ops.mha_flash` call's mask: "causal", "window" or "bidir"."""
    if not kw.get("causal", True):
        return "bidir"
    return "window" if kw.get("window") else "causal"


def attention_keep(sks, bidir=True):
    """A Recorder's pick: (kind, Sq, Sk) of a call whose Sk is in `sks`,
    or of any bidirectional call with `bidir`."""
    def keep(q, k, v, **kw):
        kind = attention_kind(kw)
        if k.shape[1] in sks or (bidir and kind == "bidir"):
            return kind, q.shape[1], k.shape[1]
        return None
    return keep


def planted_faults(qf, kf, vf, kw):
    """Two wrong kernels at a call's own inputs, made of the plain version
    on cut inputs. Causal and window calls: "last_key" a mask one key
    short (right-aligned, k and v without their last key) and
    "first_tile" rows past the first 64-key tile that do not read it
    (the rows in it, and their keys, on their own; then the rest without
    it); over more than LM_LONG_SK keys "last_tile", the last
    LM_FAULT_TILE keys left out (right-aligned: each row loses its most
    recent ones), and "first_tile" the first LM_FAULT_TILE left out, or,
    where the window cuts keys, "no_window", the window ignored.
    Bidirectional calls: "first_tile", the first 64 keys left out, and
    "last_tile", the ragged last tile's (Sk mod 64, or 64)."""
    kind = attention_kind(kw)
    Sq, Sk = qf.shape[1], kf.shape[1]
    if kind == "bidir":
        tail = Sk % 64 or 64
        return {"first_tile": attention_plain(qf, kf[:, 64:], vf[:, 64:],
                                              **kw),
                "last_tile": attention_plain(qf, kf[:, :-tail],
                                             vf[:, :-tail], **kw)}
    if Sk > LM_LONG_SK:
        t = LM_FAULT_TILE
        faults = {"last_tile": attention_plain(qf, kf[:, :-t], vf[:, :-t],
                                               **kw)}
        if kind == "window" and Sk > kw["window"]:
            faults["no_window"] = attention_plain(qf, kf, vf,
                                                  **{**kw, "window": 0})
        else:
            faults["first_tile"] = attention_plain(qf, kf[:, t:], vf[:, t:],
                                                   **kw)
        return faults
    last_key = attention_plain(qf, kf[:, :-1], vf[:, :-1], **kw)
    T = 64 - (Sk - Sq)                 # the query rows within the tile
    rest = attention_plain(qf[:, max(T, 0):], kf[:, 64:], vf[:, 64:], **kw)
    first_tile = rest if T <= 0 else torch.cat(
        (attention_plain(qf[:, :T], kf[:, :64], vf[:, :64], **kw), rest), 1)
    return {"last_key": last_key, "first_tile": first_tile}


def lm_attention_checks(calls, rows=None):
    """The recorded attention calls against the plain version on the
    card, in the kernel's layout (with `rows`, a prefill's last `rows`
    query rows); each with the share of the same limit that the two
    planted faults take, which must exceed 1."""
    out = []
    for (kind, Sq, Sk), ((q, k, v), kw, o) in sorted(calls.items()):
        phase = "prefill" if Sq > 1 else "decode"
        qf, kf, vf, of = flat_attention({"args": (q, k, v), "out": o})
        if rows is not None and Sq > rows:
            qf, of = qf[:, -rows:], of[:, -rows:]
        seen = min(Sk, kw["window"]) if kind == "window" else Sk
        atol, rtol = ATTN_BF16["decode" if Sq == 1
                               and seen >= ATTN_DECODE_KEYS else "prefill"]
        row = attention_closeness(f"{kind}/{phase}/Sq{Sq}/Sk{Sk}", qf, kf,
                                  vf, of, kw, atol, rtol)
        row["rows_checked"] = qf.shape[1]
        want = attention_plain(qf, kf, vf, **kw)
        row["planted_limit_share"] = {
            name: closeness(name, bad, want, row["atol"],
                            rtol)["limit_share"]
            for name, bad in planted_faults(qf, kf, vf, kw).items()}
        row["ok"] = row["ok"] and min(row["planted_limit_share"].values()) > 1
        row["path"] = fa.kernel_path(qf.shape[0], kf.shape[0], Sq, Sk,
                                     qf.shape[2], qf.dtype)
        out.append(row)
    return out


def lm_scan_checks(calls):
    rows = []
    for key, ((x, dt, A, Bs, Cs, D), kw, (y, h)) in calls.items():
        y_want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs, kw.get("h0"))
        rows.append(closeness("prefill/y", y, y_want + x * D, 1e-4, 1e-4))
        rows.append(closeness("prefill/h_last", h, h_want, 1e-4, 1e-4))
    return rows


def on_kernel_route(cfg, spec) -> bool:
    """Whether a layer of the block pattern goes through the attention
    kernel: not under MLA (`blocks.apply_layer` hands every layer but a
    cross layer to `apply_mla`, whose v head width differs from its q/k
    width), not a Mamba layer."""
    return spec.mixer != "mamba" \
        and (cfg.mla is None or spec.mixer == "cross_attn") \
        and attention.kernel_route(attention.MIXER_KIND[spec.mixer],
                                   cfg.hd, cfg.hd)


def kernel_kinds(cfg):
    """The mask kind of each layer of the block pattern on the attention
    kernel's route."""
    return [attention.MIXER_KIND[s.mixer] for s in cfg.block_pattern
            if on_kernel_route(cfg, s)]


def kernel_layers(cfg):
    """(attention layers on the kernel's route, Mamba layers) of a
    stack (the decoder's, for an enc-dec config)."""
    return cfg.n_superblocks * len(kernel_kinds(cfg)), \
        cfg.n_superblocks * sum(s.mixer == "mamba" for s in cfg.block_pattern)


def encoder_layers(cfg) -> int:
    """The encoder's attention layers on the kernel's route (whisper's 4
    bidirectional layers), 0 without an encoder."""
    return 0 if cfg.encoder is None else kernel_layers(cfg.encoder_cfg())[0]


def decode_weight_bytes(serving, cfg, B) -> int:
    """Bytes of weights one decode step reads: every leaf of the serving
    copy but the encoder's, for an untied embedding and learned positions
    only the B rows gathered (every expert of an MoE layer counted)."""
    total = 0
    for path, t in flatten(serving):
        if path.startswith("encoder/"):
            continue
        if (path == "embed" and not cfg.tie_embeddings) \
                or path == "pos_embed":
            total += B * t.shape[1] * t.element_size()
        else:
            total += t.numel() * t.element_size()
    return total


def decode_steps(server, prompts):
    """The decode steps after a prefill of `prompts`: the median host ms
    of a step, each to a synchronize, over the first LM_GEN -
    LM_PROFILED; then the last LM_PROFILED under torch.profiler (after
    every other profiler reading of the script): device busy ms a step,
    its idle share of the steps' wall, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg, p = server.cfg, server.serving
    toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
    times = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with torch.inference_mode():
        logits, cache = lm.prefill(p, toks, cfg, LM_PROMPT + LM_GEN,
                                   memory=server.memory(len(prompts)))
        tok = logits.argmax(-1)[:, None]
        for t in range(LM_GEN):
            if t == LM_GEN - LM_PROFILED:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(p, tok, cache, cfg, LM_PROMPT + t)
            tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof.stop()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / LM_PROFILED
    wall = float(np.mean(times[-LM_PROFILED:]))
    row = {"steps": LM_PROFILED, "wall_ms": wall, "device_busy_ms": None,
           "device_idle_share": None, "by_kernel_ms": []}
    if by_kernel:          # else not measured: the profiler lost the events
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        row.update(device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
                   by_kernel_ms=[{"name": k[:80], "ms": v} for k, v in top])
    return float(np.median(times[:-LM_PROFILED])), row


def cache_copy_ms(cfg, attn_layers):
    """Device ms a decode step spends in `ops.mha_flash`'s copies of k and
    v from the cache slice into the kernel's layout, at the last step's
    LM_PROMPT + LM_GEN keys: the two copies of one layer by torch.profiler
    (the kernels' own time: CUDA events over such short launches would
    time the host), times the attention layers."""
    if not attn_layers:
        return 0.0
    K, hd = cfg.n_kv_heads, cfg.hd
    cache = torch.zeros((LM_REQUESTS, LM_PROMPT + LM_GEN, K, hd),
                        dtype=cfg.cdtype, device="cuda")

    def copies():
        for t in (cache, cache):
            t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
    copies()
    calls = 20
    kernels = device_kernels(copies, calls)
    if not kernels:        # not measured: the profiler lost the events
        return None
    return sum(t for _, t in kernels) / calls * attn_layers


def seeded_source(cfg, B, device):
    """The cross-attention's input from LM_MEMORY_SEED, unit normal: the
    memory (B, vision_tokens, d_model) in cfg.cdtype (vlm) or the frames
    (B, n_frames, d_model) fp32 its encoder reads (enc-dec); else None."""
    if cfg.family == "vlm":
        M = cfg.vision_tokens
    elif cfg.encoder is not None:
        M = cfg.encoder.n_frames
    else:
        return None
    src = torch.from_numpy(np.random.default_rng(LM_MEMORY_SEED)
                           .standard_normal((B, M, cfg.d_model))
                           .astype(np.float32)).to(device)
    return src.to(cfg.cdtype) if cfg.family == "vlm" else src


def seeded_batch(batch_np, cfg, device):
    """`launch.train.batch_on`'s batch with the cross-attention's input
    from `seeded_source` in place of the driver's zeros: rows that
    differ, so that a kernel call that read one row's keys for another's
    would show."""
    batch = batch_on(batch_np, cfg, device)
    src = seeded_source(cfg, batch["tokens"].shape[0], device)
    if src is not None:
        batch["memory" if cfg.family == "vlm" else "frames"] = src
    return batch


class RouteTap:
    """Stands in for `moe.route`: records each call's experts (and the
    smallest top-2 router margin) where `impose` is off, and hands the
    recorded experts back, in order, with the caller's own gates, where
    it is on."""

    def __init__(self):
        self.routes, self.impose, self.margin = [], False, None
        self.fn = moe.route

    def __enter__(self):
        def route(probs, K):
            if not self.impose:
                gate, eidx = self.fn(probs, K)
                top2 = probs.float().topk(2, dim=-1).values
                m = float((top2[:, 0] - top2[:, 1]).min())
                self.margin = m if self.margin is None else \
                    min(self.margin, m)
                self.routes.append(eidx)
                return gate, eidx
            eidx = self.routes.pop(0).to(probs.device)
            gate = probs.gather(-1, eidx)
            return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.fn


def lm_card_vs_cpu(server, prompts):
    """The first superblocks (at least LM_CPU_LAYERS layers) of the
    server's serving copy on the card and, copied, on the CPU: prefill
    logits, then LM_CPU_STEPS decode steps fed the CPU's sampled tokens.
    Each step (the prefill's too) samples as a generate does: key, k =
    split(key) from prng_key(LM_SAMPLE_SEED), the token argmax(logits +
    gumbel(k)), the noise from the kernel on the card and the plain
    version on the CPU. The memory from `seeded_source`, llama-vision's
    gates at LM_CPU_XGATE; an MoE layer on the card takes the CPU's
    experts. Returns the comparison's row."""
    pattern = len(server.cfg.block_pattern)
    layers = pattern * -(-LM_CPU_LAYERS // pattern)
    cfg = dataclasses.replace(server.cfg, n_layers=layers)
    card = dict(server.serving,
                stack=tree_map(lambda t: t[:cfg.n_superblocks],
                               server.serving["stack"]))
    card = unflatten(card, {path: torch.full_like(t, LM_CPU_XGATE)
                            if path.endswith("xgate") else t
                            for path, t in flatten(card)})
    cpu = tree_map(lambda t: t.cpu(), card)
    toks = prompts[:LM_CPU_REQUESTS, :LM_CPU_PROMPT].astype(np.int64)
    source = seeded_source(cfg, LM_CPU_REQUESTS, "cpu")
    runs, noises, fed = {}, {}, []
    t0 = time.perf_counter()
    with RouteTap() as routes, torch.inference_mode():
        for side, p in (("cpu", cpu), ("cuda", card)):
            routes.impose = side == "cuda"
            key = prng.prng_key(LM_SAMPLE_SEED)
            memory = None if source is None else source.to(side)
            if cfg.encoder is not None:
                memory = lm.encode(p, memory, cfg)
            out, noise = [], []
            logits, cache = lm.prefill(p, torch.as_tensor(toks, device=side),
                                       cfg, LM_CPU_PROMPT + LM_CPU_STEPS,
                                       memory=memory)
            for s in range(LM_CPU_STEPS + 1):
                key, k = prng.split(key)
                g = threefry.gumbel(k, logits.numel(), device=side)
                out.append(logits.float().cpu())
                noise.append(g.view(logits.shape).cpu())
                if s == LM_CPU_STEPS:
                    break
                if side == "cpu":
                    fed.append((out[-1] + noise[-1]).argmax(-1)[:, None])
                logits, cache = lm.decode_step(p, fed[s].to(side), cache,
                                               cfg, LM_CPU_PROMPT + s)
            runs[side], noises[side] = out, noise
            del cache, memory
        routes_left = len(routes.routes)
    limit = LM_LOGIT_RTOL * float(max(t.abs().max() for t in runs["cpu"]))
    err = max(float((got - want).abs().max())
              for want, got in zip(runs["cpu"], runs["cuda"]))
    noise_mismatches = sum(int((words(a) != words(b)).sum())
                           for a, b in zip(noises["cpu"], noises["cuda"]))
    margins, flips, z_margins, z_flips = [], 0, [], 0
    for want, got, g in zip(runs["cpu"], runs["cuda"], noises["cuda"]):
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > 2 * limit
        margins += margin[sure].tolist()
        flips += int((got.argmax(-1) != want.argmax(-1))[sure].sum())
        z_want, z_got = want + g, got + g
        top2 = z_want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > 2 * err
        z_margins += margin.tolist()
        z_flips += int((z_got.argmax(-1) != z_want.argmax(-1))[sure].sum())
    compared = [m for m in z_margins if m > 2 * err]
    return {"layers": layers, "requests": LM_CPU_REQUESTS,
            "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS,
            "memory": None if source is None else
            {"seed": LM_MEMORY_SEED, "shape": list(source.shape),
             "xgate": LM_CPU_XGATE if cfg.family == "vlm" else None},
            "moe_min_router_margin": routes.margin,
            "max_abs_err": err, "limit": limit, "rtol": LM_LOGIT_RTOL,
            "ok": (err <= limit and flips == 0 and z_flips == 0
                   and noise_mismatches == 0 and routes_left == 0),
            "tokens_compared": len(margins), "token_flips": flips,
            "min_compared_margin": min(margins, default=None),
            "sampled": {"seed": LM_SAMPLE_SEED,
                        "noise_mismatched_words": noise_mismatches,
                        "margins": z_margins, "compare_above": 2 * err,
                        "tokens_compared": len(compared),
                        "token_flips": z_flips,
                        "min_compared_margin": min(compared, default=None)},
            "seconds": time.perf_counter() - t0}


def leaves_drawn(cfg) -> int:
    """The threefry normal draws (one launch each) a build of `cfg` makes:
    its wrapper's calls in a build on `meta`."""
    with DrawTap(threefry, "normal") as tap:
        lm.init_params(None, cfg, device="meta", serving=True)
    return len(tap.calls)


def sampled_generate(server, prompts, bad):
    """One `generate(greedy=False)` on the card, each step's Gumbel noise
    recorded: a launch a decode step, the first and last steps' noise
    equal to the plain version's bit for bit."""
    arch = server.cfg.name
    threefry.gumbel_launches = 0
    with DrawTap(threefry, "gumbel", clone=True) as tap:
        out, _ = server.generate(prompts, LM_GEN, greedy=False,
                                 seed=LM_SAMPLE_SEED)
    torch.cuda.synchronize()
    launched = threefry.gumbel_launches
    mism = 0
    for keys, n, kw, noise in (tap.calls[0], tap.calls[-1]):
        want = threefry.gumbel(keys, n, device="cpu", **kw)
        mism += int((words(noise) != words(want)).sum())
    row = {"seed": LM_SAMPLE_SEED, "launches": launched,
           "want_launches": LM_GEN,
           "noise_checked": 2 * tap.calls[0][1],
           "noise_mismatched_words": mism, "sample": out[0, :8].tolist(),
           "in_vocabulary": bool(((out >= 0)
                                  & (out < server.cfg.vocab_size)).all())}
    row["ok"] = launched == LM_GEN and mism == 0 and row["in_vocabulary"]
    if not row["ok"]:
        bad.append(f"{arch}: sampled generate: {row}")
    return row, launched


def seeded_cross_calls(server, prompts):
    """llama-vision's cross layers' kernel calls over a memory from
    LM_MEMORY_SEED (the server feeds zeros, whose k and v are 0): a
    prefill of `prompts` and one decode step of the served model, the
    first bidirectional call of each Sq recorded."""
    cfg = server.cfg
    toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
    memory = seeded_source(cfg, len(prompts), "cuda")
    with Recorder("mha_flash", attention_keep(())) as rec, \
            torch.inference_mode():
        logits, cache = lm.prefill(server.serving, toks, cfg,
                                   LM_PROMPT + 1, memory=memory)
        lm.decode_step(server.serving, logits.argmax(-1)[:, None], cache,
                       cfg, LM_PROMPT)
    torch.cuda.synchronize()
    return rec.calls


def long_generate(server, long, bad):
    """gemma2's generate at LM_LONG's prompt, where the window cuts keys:
    exact launches, and its local and global calls at the prefill and the
    first and last decode steps against the plain version on their last
    LM_CHECK_ROWS rows; `long` is its (requests, prompt, gen). Returns
    its row and its launches."""
    cfg = server.cfg
    B, P, G = long
    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    attn_layers, _ = kernel_layers(cfg)
    want = attn_layers * (1 + G)
    fa.launches = 0
    with Recorder("mha_flash", attention_keep((P, P + 1, P + G),
                                              bidir=False)) as rec:
        out, stats = server.generate(prompts, G)
    torch.cuda.synchronize()
    launched = fa.launches
    checks = lm_attention_checks(rec.calls, rows=LM_CHECK_ROWS)
    del rec
    row = {"requests": B, "prompt": P, "gen": G, "window": cfg.window,
           "launches": launched, "want_launches": want, **stats,
           "sample": out[0].tolist(), "kernel_checks": checks,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if launched != want:
        bad.append(f"{cfg.name}: the long generate launched {launched}, "
                   f"want {want}")
    if len(checks) != 6:
        bad.append(f"{cfg.name}: the long generate recorded {len(checks)} "
                   f"kernel calls")
    bad += [f"{cfg.name}: long: {c}" for c in checks if not c["ok"]]
    return row, launched


def lm_serve(arch, layers, bad):
    """One model of the lm phase. Returns its row and its launches."""
    published = registry.get_config(arch)
    cfg = published if layers is None else \
        dataclasses.replace(published, n_layers=layers)
    gc.collect()            # the last model's weights, held by a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    threefry.normal_launches = 0
    with DrawTap(threefry, "normal") as draws:
        server = BatchedServer(cfg, max_batch=LM_REQUESTS, seed=0,
                               max_len=LM_PROMPT + LM_GEN, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    drawn = threefry.normal_launches
    if drawn != leaves_drawn(cfg):
        bad.append(f"{arch}: the build launched threefry {drawn} times for "
                   f"{leaves_drawn(cfg)} drawn leaves")
    # the serving copy drawn as such: the build holds nothing more
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serving_gb = torch.cuda.memory_allocated() / 1e9
    if build_peak_gb - serving_gb > LM_BUILD_SLACK_GB:
        bad.append(f"{arch}: the build's peak {build_peak_gb} GB, the "
                   f"serving copy {serving_gb} GB")
    # the plain slices on the CPU beside the untimed card work below,
    # joined before the timed generate
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        slices_done = pool.submit(rng_leaf_slices(draws.calls))
    finally:
        pool.shutdown(wait=False)
    del draws
    torch.cuda.reset_peak_memory_stats()
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    attn_layers, mamba_layers = kernel_layers(cfg)
    enc_layers = encoder_layers(cfg)
    want = {"flash_attention": attn_layers * (1 + LM_GEN) + enc_layers,
            "mamba_scan": mamba_layers}

    fa.launches = ms.launches = 0
    with Recorder("mha_flash", attention_keep(
            LM_ATTN_SK, bidir=cfg.family != "vlm")) as attn, \
            Recorder("selective_scan_fused",
                     lambda x, *a, **kw: "prefill" if x.shape[1] > 1
                     else None) as scan:
        out, _ = server.generate(prompts, LM_GEN)
    torch.cuda.synchronize()
    launched = {"flash_attention": fa.launches, "mamba_scan": ms.launches}
    if launched != want:
        bad.append(f"{arch}: a generate launched {launched}, want {want}")
    launched = dict(launched)
    calls = dict(attn.calls)
    if cfg.family == "vlm":
        calls.update(seeded_cross_calls(server, prompts))
    checks = lm_attention_checks(calls) + lm_scan_checks(scan.calls)
    kinds = set(kernel_kinds(cfg))
    want_checks = len(LM_ATTN_SK) * len(kinds - {"bidir"}) \
        + 2 * ("bidir" in kinds) + (enc_layers > 0) \
        + (2 if mamba_layers else 0)
    if len(checks) != want_checks:
        bad.append(f"{arch}: recorded {len(checks)} kernel calls, want "
                   f"{want_checks}")
    bad += [f"{arch}: {c}" for c in checks if not c["ok"]]
    del attn, scan, calls
    sampled, sampled_launches = sampled_generate(server, prompts, bad)
    launched["threefry_normal"] = drawn
    launched["threefry_gumbel"] = sampled_launches
    slices = slices_done.result()
    build_slices = {"leaves": len(slices),
                    "dtypes": sorted({r["dtype"] for r in slices}),
                    "checked_words": sum(r["checked"] for r in slices),
                    "mismatched_words": sum(r["mismatches"]
                                            for r in slices)}
    if build_slices["mismatched_words"]:
        bad.append(f"{arch}: the serving build's slices: {build_slices}")
    _, stats = server.generate(prompts, LM_GEN)         # warm: the times
    step_ms, step_profile = decode_steps(server, prompts)
    weight_bytes = decode_weight_bytes(server.serving, cfg, LM_REQUESTS)
    long = None
    if arch in LM_LONG:
        long, n = long_generate(server, LM_LONG[arch], bad)
        launched["flash_attention"] += n
    vs_cpu = lm_card_vs_cpu(server, prompts)
    if not vs_cpu["ok"]:
        bad.append(f"{arch}: card and CPU disagree: {vs_cpu}")
    row = {"arch": arch, "layers": cfg.n_layers,
           "published_layers": published.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "reduced": [] if layers is None else
           [f"n_layers {layers} of {published.n_layers}"],
           "requests": LM_REQUESTS, "prompt": LM_PROMPT,
           "gen": LM_GEN, "launches": launched, "want_launches": want,
           "finite_tokens": bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           "sample": out[0, :8].tolist(), "build_s": build_s,
           "build_threefry_launches": drawn, "build_slices": build_slices,
           "sampled": sampled, **stats, "decode_step_ms_median": step_ms,
           "decode_step_profile": step_profile,
           "decode_cache_copy_ms": cache_copy_ms(cfg, attn_layers),
           "decode_weight_bytes": weight_bytes,
           "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "build_peak_mem_gb": build_peak_gb, "serving_mem_gb": serving_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernel_checks": checks, "long": long, "card_vs_cpu": vs_cpu}
    if not row["finite_tokens"]:
        bad.append(f"{arch}: a token outside the vocabulary")
    del server
    torch.cuda.empty_cache()
    return row, launched


def phase_lm():
    """The LM serving path at full width: each LM_CELLS model, one after
    the other. Every check runs before any fails. Returns the phase's
    launches."""
    bad, rows = [], []
    total = {"flash_attention": 0, "mamba_scan": 0, "threefry_normal": 0,
             "threefry_gumbel": 0}
    t0 = time.perf_counter()
    for arch, layers in LM_CELLS:
        row, launched = lm_serve(arch, layers, bad)
        rows.append(row)
        total = {k: total[k] + launched[k] for k in total}
        print(f"lm: {arch} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    emit({"phase": "lm", "models": rows, "launches": total,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi(),
          "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"lm phase: {bad}")
    return total


# ---------------------------------------------------------- train_lm phase
# (arch, layers kept of the published depth or None for all of them,
# batch, sequence, steps): the published widths; the depth cut only where
# fp32 params, grads and both AdamW moments (16 B a parameter) with the
# step's transients would not fit one 80 GB card, the step's peak counted
# on `meta` by `launch.dryrun.count_train`: qwen3-8b 12 of 36 layers
# (3.56 B parameters, 57 GB of state) and falcon-mamba-7b 32 of 64 (3.64
# B, 58.2 GB; 66.78 GB counted, 36 layers 74.59), each cell's batch and
# steps kept as they were when a step's backward ran the plain versions,
# so that its steps compare with those runs; gemma2-27b 4 of 46 (two
# superblocks of a local and a global layer, 3.445 B, 55.1 GB) on one row
# of 6144 tokens, over which the 4096 window cuts keys; whisper-tiny whole
# (54 M) on 8 x 448 tokens, its decoder's context, with the driver's
# frames (`launch.train.batch_on`: zeros, so that the encoder reads its
# learned positions); minicpm3-4b whole (4.07 B, 65.2 GB; 69.25 GB
# counted) and qwen1.5-4b whole (3.95 B, 63.2 GB; 66.04 GB counted) on
# 2 x 512
TRAIN_LM_CELLS = (("qwen3-8b", 12, 4, 1024, 4),
                  ("falcon-mamba-7b", 32, 2, 512, 3),
                  ("gemma2-27b", 4, 1, 6144, 3),
                  ("whisper-tiny", None, 8, 448, 3),
                  ("minicpm3-4b", None, 2, 512, 3),
                  ("qwen1.5-4b", None, 2, 512, 3))
TRAIN_LM_LR = 3e-4
# a cell's layout: the sharding policy's knobs (`sharding.act`), which
# keep the math. At gemma2-27b the default CE chunk (`lm.CE_CHUNK`, 65,536
# tokens: the row's 6143 in one) holds (6143, 256,000) fp32 logits and
# their backward's copies at once: 81.8 GB at the step's peak, counted on
# `meta`; in 2048-token chunks, 64.7 GB
TRAIN_LAYOUT = {"gemma2-27b": {"ce_chunk": 2048}}
# layer 0's superblock, forward and backward, through the kernels'
# autograd Functions against the same superblock through the plain
# versions, on the card, both in the config's bf16. The two differ by the
# kernels' own roundings (ATTN_BF16; the scan's 1e-4), which the layer's
# bf16 ops carry on (into the cotangents too): the output and each
# gradient (the input's and every parameter's) within TRAIN_LAYER_TOL of
# the plain one in norm, ||kernel - plain|| <= TRAIN_LAYER_TOL ||plain||
# (not elementwise: two gradients of one bf16 tensor differ by a few of
# its roundings, 2^-8 each, which an element left small by cancellation
# does not bound). Each
# kernel call's output at the ops phase's elementwise limits; the
# gradients a call's Function returns (the backward kernels') against
# the plain backward on the call's own inputs, its output and the
# cotangent it received, at the backward kernels' own limits
# (ATTN_BWD_LIMITS, SCAN_BWD_LIMITS, as the ops phase's backward cases
# hold them).
TRAIN_LAYER_TOL = 2e-2
# gemma2-27b's own limit for those rows, which 2e-2 cannot resolve there:
# its bf16 superblock moves that far when any one rounding moves. At
# 1 x 6144 tokens (tools/attn_long_rows.py, NVIDIA H100 80GB HBM3,
# 700 W), with no kernel in the run, the plain versions with the scores'
# scale moved by 1e-6 (each call's output moved by 5e-5: a few bf16
# roundings flipped) lie up to 2.02e-2 from the plain ones; the plain
# versions and the kernels each lie up to 9.45e-2 (layer 1's wq grad)
# from the same superblock in fp32, equally to three digits. The
# kernels lie up to 3.41e-2 from the plain versions (their calls 1.1e-3,
# gradients up to 4.0e-3), and the kernels' bf16 roundings of P and dS
# done in torch 3.49e-2: the limit takes 5e-2 over those, under the
# plain superblock's own 9.45e-2 (qwen3-8b and whisper-tiny: 1.25e-2 and
# 2.31e-2 from fp32, the nudge 5.7e-3 and 8.6e-3, within 2e-2)
TRAIN_LAYER_TOL_AT = {"gemma2-27b": 5e-2}
# a planted fault, one element of a kernel call's output (or of the
# gradient it returns for its first input) moved by the largest |value|
# of that tensor, must take more than this many times its limit
TRAIN_FAULT_SHARE = 10.0
# card against CPU: the first TRAIN_CPU_LAYERS layers of the same
# weights, copied, through every step of the cell's own schedule
# (`train_step_fn(cfg, AdamWConfig(lr=TRAIN_LM_LR), steps)`), each step
# on one row of TRAIN_CPU_TOKENS tokens of the cell's batch: each step's
# loss within TRAIN_CPU_LOSS_RTOL and the first step's gradient norm
# within TRAIN_CPU_GNORM_RTOL of the CPU's (both bf16 compute, rounded at
# other places: cuBLAS against the CPU's GEMMs, the kernels against the
# plain versions)
TRAIN_CPU_LAYERS, TRAIN_CPU_TOKENS = 2, 64
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GNORM_RTOL = 1e-2, 5e-2
# the CPU's share of the phase: its AdamW over the copy. gemma2-27b's 2
# layers come with its tied 256,000 x 4608 embedding (2.31 B parameters
# on the CPU, ~45 s a step on the host of an NVIDIA H100 80GB HBM3, 700
# W), so its comparison runs
# the first of the cell's 3 steps (its loss and gradient norm), for the
# script's time. That step runs at lr 0 (the schedule's one warmup step),
# so no AdamW update of gemma2-27b is compared; qwen3-8b's cell holds
# AdamW on the card to the CPU's over 4 steps. qwen1.5-4b's 2 layers come
# with its untied 151,936 x 2560 embedding and head (0.94 B parameters):
# the warmup step and the first AdamW step
TRAIN_CPU_STEPS = {"gemma2-27b": 1, "qwen1.5-4b": 2}
# the kernels against the plain versions over whole steps: the cells in
# TRAIN_PLAIN_HOLD built again from the same seed (after the first run is
# freed) run the same steps on the same batches with `ops.mha_flash` and
# `ops.selective_scan_fused` by their plain versions, forward and
# backward (autograd through `kernels.ref`): each step's loss within
# TRAIN_PLAIN_LOSS_RTOL of the kernels' run
TRAIN_PLAIN_HOLD = ("qwen3-8b", "qwen1.5-4b")
TRAIN_PLAIN_LOSS_RTOL = 1e-2
# a cell's peak (`max_memory_allocated` over its steps) against its step
# counted on `meta` by `launch.dryrun.count_train`, within the layout and
# shard phases' LAYOUT_PEAK_RATIO where the count is at least
# TRAIN_PEAK_GATE_GB, the cells whose depth or batch memory sets. Below
# it the allocator's fixed costs pass 1% of the count: whisper-tiny read
# 4.67 GB against 4.55 counted (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_PEAK_GATE_GB = 32.0
# the driver itself, `launch.train.train`, twice: at the reduced
# qwen1.5-4b, 6 steps with an asynchronous checkpoint at step 3 (a
# blocking one at 6), then a restore that runs 2 more (the Checkpointer's
# round trip: a full-width one would write 63 GB twice and read it back)
DRIVER = {"arch": "qwen1.5-4b", "steps": 6, "global_batch": 8,
          "seq_len": 64, "ckpt_every": 3}
DRIVER_MORE = 2
# and at qwen1.5-4b's published widths (40 layers, 3.95 B parameters), 3
# steps without a checkpoint: its pipeline draws 256 rows of 16 tokens
# whatever global_batch says (the reference's quirk, ROADMAP Queue C),
# 66.04 GB counted on `meta`
DRIVER_FULL = {"arch": "qwen1.5-4b", "smoke": False, "steps": 3,
               "global_batch": 8, "seq_len": 16}
DRIVER_MORE = 2


def plain_mha(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """`ops.mha_flash` by the plain version, differentiable, on any
    device."""
    B, Sq, H, hd = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], hd)
                  for t in (q, k, v))
    out = ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def plain_scan(x, dt, A, Bs, Cs, D_skip, h0=None):
    """`ops.selective_scan_fused` by the plain version."""
    y, h = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
    return y + x * D_skip, h


def bumped(t):
    """`t` with its middle element moved by the largest |value| of `t`."""
    bump = torch.zeros(t.numel(), dtype=t.dtype, device=t.device)
    bump[t.numel() // 2] = t.detach().abs().max()
    return t + bump.view(t.shape)


class Tap:
    """Stands in for `ops.mha_flash` and `ops.selective_scan_fused` while
    one superblock runs forward and backward: calls the kernel path (or,
    with `plain`, the plain versions above) and keeps each call's inputs,
    its output and, by hooks, the gradients of its inputs. `fault`
    ("out" or "grad") moves one element of the first call's output, or
    of the gradient it returns for its first input, by that tensor's
    largest |value|: a planted fault."""

    NAMES = ("mha_flash", "selective_scan_fused")

    def __init__(self, plain=False, fault=None):
        self.plain, self.fault, self.calls = plain, fault, []
        self.saved = {n: getattr(ops, n) for n in self.NAMES}

    def __enter__(self):
        for name, fn in zip(self.NAMES, (plain_mha, plain_scan)):
            setattr(ops, name, self._wrap(fn if self.plain
                                          else self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(ops, name, fn)

    def _wrap(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            rec = {"args": tuple(a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args), "kw": kw,
                   "grads": {}}
            if self.fault == "out" and not self.calls:
                first = bumped(first)
                out = (first, *out[1:]) if isinstance(out, tuple) else first
            rec["out"] = first.detach().clone()
            if first.requires_grad:
                first.register_hook(self._keep_cotangent(rec))
            for i, a in enumerate(args):
                if torch.is_tensor(a) and a.requires_grad:
                    a.register_hook(self._hook(rec, i))
            self.calls.append(rec)
            return out
        return call

    @staticmethod
    def _keep_cotangent(rec):
        def keep(g):
            rec["g_out"] = g.detach().clone()
        return keep

    def _hook(self, rec, i):
        def keep(g):
            if self.fault == "grad" and i == 0 and rec is self.calls[0]:
                g = bumped(g)
            rec["grads"][i] = g.detach().clone()
            return g
        return keep


def rel_norm(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def norm_closeness(case, got, want, limit):
    """The relative norm ||got - want|| / ||want|| against `limit`."""
    rel = rel_norm(got, want)
    return {"case": case, "ok": bool(torch.isfinite(got).all())
            and rel <= limit, "rel_norm_err": rel, "limit": limit,
            "limit_share": rel / limit}


def call_grads_check(rec):
    """The gradients one kernel call's Function returned (the backward
    kernels') against the plain backward on the call's own inputs, its
    output and the cotangent it received: rows of each input's gradient,
    elementwise within the kernel's limits (ATTN_BWD_LIMITS by dtype,
    SCAN_BWD_LIMITS)."""
    args = [a.detach() if torch.is_tensor(a) else a for a in rec["args"]]
    if len(args) == 3:                                   # attention
        qf, kf, vf, of = flat_attention({"args": args, "out": rec["out"]})
        want = attention_bwd_plain(qf, kf, vf, of, flat_heads(rec["g_out"]),
                                   **rec["kw"])
        want = [model_heads(w, args[0].shape[0]) for w in want]
        limits = ATTN_BWD_LIMITS[args[0].dtype]
    else:                                                # the scan, with D
        want = ref.mamba_scan_bwd_ref(*args, rec["kw"].get("h0"),
                                      rec["g_out"], None)
        limits = SCAN_BWD_LIMITS
    names = [f"grad{i}" for i in rec["grads"]]
    return grads_rows("call", names, list(rec["grads"].values()),
                      [want[i] for i in rec["grads"]], limits)


def superblock0(params, cfg, batch, tap):
    """Layer 0's superblock forward and backward on the batch's embedded
    tokens, under `tap`, with a fixed random cotangent. An enc-dec
    config's whole encoder runs first, on the batch's frames and without
    remat (one kernel call a layer), and the superblock's cross layer
    reads its output (a vlm's, the batch's memory). Returns (output,
    {"x": input grad, path: parameter grad}), the encoder's paths under
    "encoder/"."""
    tokens = batch["tokens"]
    sb = blocks.unstack(params["stack"], cfg.n_superblocks)[0]
    leaves = {path: t.detach().requires_grad_(True)
              for path, t in flatten(sb)}
    enc = {} if cfg.encoder is None else {
        path: t.detach().requires_grad_(True)
        for path, t in flatten(params["encoder"])}
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    with torch.no_grad():
        x = lm._embed(params, tokens, cfg)
        if cfg.learned_pos_emb:
            x = x + params["pos_embed"][positions].to(cfg.cdtype)
    x.requires_grad_(True)
    gen = torch.Generator(tokens.device).manual_seed(1)
    with tap:
        memory = batch.get("memory")
        if enc:
            memory = lm.encode({"encoder": unflatten(params["encoder"], enc)},
                               batch["frames"], cfg, remat=False)
        out, _ = blocks.apply_superblock(unflatten(sb, leaves), x, cfg,
                                         positions=positions, memory=memory)
        w = torch.randn(out.shape, generator=gen, device=out.device)
        grads = torch.autograd.grad((out.float() * w).sum(),
                                    [x, *leaves.values(), *enc.values()])
    return out.detach(), dict(zip(["x", *leaves,
                                   *(f"encoder/{p}" for p in enc)], grads))


def superblock_calls(cfg) -> int:
    """The kernel calls `superblock0` makes: one a kernel-route attention
    layer and one a Mamba layer of the superblock, one an encoder layer."""
    attn, mamba = kernel_layers(cfg)
    return (attn + mamba) // cfg.n_superblocks + encoder_layers(cfg)


def call_name(rec) -> str:
    """A tapped call's kernel, mask and lengths."""
    if len(rec["args"]) == 3:
        q, k, _ = rec["args"]
        return f"attention/{attention_kind(rec['kw'])}/Sq{q.shape[1]}" \
            f"/Sk{k.shape[1]}"
    return f"scan/S{rec['args'][0].shape[1]}"


def layer0_checks(arch, params, cfg, batch):
    """Layer 0 through the kernels' Functions against the plain versions:
    rows for the output and every gradient (within TRAIN_LAYER_TOL, or
    the arch's TRAIN_LAYER_TOL_AT), each kernel call's output and input
    gradients (`superblock_calls` of them); then each planted fault's
    share of its limits. A superblock with no kernel call (MLA) holds its
    output and gradients alone: there is no call to plant a fault in."""
    want_calls = superblock_calls(cfg)
    limit = TRAIN_LAYER_TOL_AT.get(arch, TRAIN_LAYER_TOL)

    def compare(kernel, plain):
        (out_k, g_k), tap_k = kernel
        (out_p, g_p), tap_p = plain
        rows = [norm_closeness("superblock/out", out_k, out_p, limit)]
        rows += [norm_closeness(f"superblock/grad/{p}", g_k[p], g_p[p],
                                limit) for p in g_p]
        for ck in tap_k.calls:
            if len(ck["args"]) == 3:                     # attention
                qf, kf, vf, of = flat_attention(ck)
                atol, rtol = ATTN_BF16["prefill"]
                rows.append(attention_closeness(
                    "call/attention/out", qf, kf, vf, of, ck["kw"], atol,
                    rtol))
            else:                                        # the scan, with D
                rows.append(closeness("call/scan/out", ck["out"],
                                      plain_scan(*ck["args"], **ck["kw"])[0],
                                      1e-4, 1e-4))
            rows += call_grads_check(ck)
        if len(tap_k.calls) != want_calls or len(tap_p.calls) != want_calls:
            rows.append({"case": "calls", "ok": False,
                         "kernel": len(tap_k.calls),
                         "plain": len(tap_p.calls), "want": want_calls})
        return rows

    def run(tap):
        return superblock0(params, cfg, batch, tap), tap
    plain = run(Tap(plain=True))
    before = {**counts(), **bwd_counts()}
    kernel = run(Tap())
    after = {**counts(), **bwd_counts()}
    rows = compare(kernel, plain)
    launched = {k: after[k] - before[k] for k in after}
    fwd = sum(launched[k] for k in counts())
    bwd = sum(launched[k] for k in bwd_counts())
    if fwd != len(kernel[1].calls) or bwd != 2 * len(kernel[1].calls):
        rows.append({"case": "one forward and one backward call a call",
                     "ok": False, "launches": launched,
                     "calls": len(kernel[1].calls)})
    faults = {}
    for fault in ("out", "grad") if want_calls else ():
        shares = [r.get("limit_share", float("inf"))
                  for r in compare(run(Tap(fault=fault)), plain)]
        faults[fault] = max(shares)
    ok = all(r["ok"] for r in rows) and \
        min(faults.values(), default=np.inf) > TRAIN_FAULT_SHARE
    return {"arch": arch, "ok": ok, "launches": launched,
            "calls": [call_name(c) for c in kernel[1].calls],
            "worst": max(rows, key=lambda r: r.get("limit_share",
                                                   float("inf"))),
            "bad": [r for r in rows if not r["ok"]], "checked": len(rows),
            "superblock_limit": limit, "planted_fault_shares": faults}


@contextlib.contextmanager
def step_parts(parts):
    """`launch.steps`' loss_and_grads and adamw_update, which its train
    steps call, each timed to a synchronize into parts["fwd_bwd_s"] and
    parts["adamw_s"] (a list each, a call a step) while open."""
    saved = steps_lib.loss_and_grads, steps_lib.adamw_update

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run
    steps_lib.loss_and_grads = timed(saved[0], "fwd_bwd_s")
    steps_lib.adamw_update = timed(saved[1], "adamw_s")
    try:
        yield
    finally:
        steps_lib.loss_and_grads, steps_lib.adamw_update = saved


# glibc's mallopt parameters and their defaults: M_TRIM_THRESHOLD 128 KiB,
# M_MMAP_MAX 65,536 mappings
MALLOC_TRIM, MALLOC_MMAP_MAX = -1, -4
MALLOC_DEFAULTS = {MALLOC_TRIM: 128 * 1024, MALLOC_MMAP_MAX: 65536}


@contextlib.contextmanager
def cpu_heap():
    """While open, glibc serves the CPU's large tensors from its heap and
    keeps what they free there for the next: by default it maps each
    allocation over 32 MB afresh and unmaps it when freed, so every
    elementwise pass over a (151,936, 4096) fp32 temporary faults in and
    zeroes its pages first. Arithmetic unchanged. On closing, the
    defaults again, and the heap's free pages back to the system
    (`malloc_trim`)."""
    libc = ctypes.CDLL(None)
    libc.mallopt(MALLOC_MMAP_MAX, 0)
    libc.mallopt(MALLOC_TRIM, 2 ** 31 - 1)
    try:
        yield
    finally:
        for param, value in MALLOC_DEFAULTS.items():
            libc.mallopt(param, value)
        libc.malloc_trim(0)


def copied(t, side):
    """`t` copied to `side`; to the CPU into memory whose pages a
    parallel zero fill touched first (a copy from the card into fresh
    pages ran slower)."""
    if side == "cuda":
        return t.detach().clone()
    return torch.zeros(t.shape, dtype=t.dtype).copy_(t.detach())


def train_card_vs_cpu(params, cfg, batches, steps):
    """The first TRAIN_CPU_LAYERS layers of the card's weights, copied
    (AdamW steps in place), on the card and on the CPU: the steps of the
    cell's schedule (`steps` in all) on one row of TRAIN_CPU_TOKENS
    tokens (no loss mask) of each of the pipeline's numpy `batches`, with
    seeded frames or memory (`seeded_batch`): each step's loss and
    gradient norm, and each side's seconds by part (the copy and AdamW's
    zero state, each step's forward and backward and its AdamW update),
    with the CPU's intra-op threads."""
    small = dataclasses.replace(cfg, n_layers=TRAIN_CPU_LAYERS)
    sub = dict(params, stack=tree_map(lambda t: t[:small.n_superblocks],
                                      params["stack"]))
    t0 = time.perf_counter()
    out, parts = {}, {}
    for side in ("cuda", "cpu"):
        part = parts[side] = {}
        t1 = time.perf_counter()
        with cpu_heap() if side == "cpu" else contextlib.nullcontext():
            p = tree_map(lambda t: copied(t, side), sub)
            opt = adamw_init(p, getattr(torch, cfg.opt_moment_dtype))
            torch.cuda.synchronize()
            part["copy_s"] = time.perf_counter() - t1
            step_fn = train_step_fn(small, AdamWConfig(lr=TRAIN_LM_LR),
                                    steps)
            losses, norms = [], []
            with step_parts(part):
                for batch in batches:
                    row = seeded_batch(
                        {"tokens": batch["tokens"][:1, :TRAIN_CPU_TOKENS]},
                        small, side)
                    p, opt, _, metrics = step_fn(p, opt, 0, row)
                    losses.append(float(metrics["loss"]))
                    norms.append(float(metrics["grad_norm"]))
            del p, opt, step_fn
        part["seconds"] = time.perf_counter() - t1
        out[side] = (losses, norms)
    torch.cuda.empty_cache()
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    rel = [abs(c - q) / abs(q) for c, q in zip(lc, lp)]
    named = flatten(sub)
    row = {"layers": TRAIN_CPU_LAYERS, "tokens": TRAIN_CPU_TOKENS,
           "steps": len(batches), "schedule_steps": steps, "lr": TRAIN_LM_LR,
           "loss": {"cuda": lc, "cpu": lp, "rel": rel,
                    "rtol": TRAIN_CPU_LOSS_RTOL},
           "grad_norm": {"cuda": gc, "cpu": gp,
                         "rel": [abs(c - q) / q for c, q in zip(gc, gp)],
                         "rtol_first": TRAIN_CPU_GNORM_RTOL},
           "parts": parts, "cpu_threads": torch.get_num_threads(),
           "cpu_capability": torch.backends.cpu.get_cpu_capability(),
           "params": sum(t.numel() for _, t in named),
           "params_embed_head": sum(t.numel() for path, t in named
                                    if path in ("embed", "lm_head")),
           "seconds": time.perf_counter() - t0}
    row["ok"] = max(rel) <= TRAIN_CPU_LOSS_RTOL and \
        row["grad_norm"]["rel"][0] <= TRAIN_CPU_GNORM_RTOL
    return row


@contextlib.contextmanager
def plain_ops():
    """`ops.mha_flash` and `ops.selective_scan_fused` by their plain
    versions (differentiable) while it is open."""
    saved = {n: getattr(ops, n) for n in Tap.NAMES}
    ops.mha_flash, ops.selective_scan_fused = plain_mha, plain_scan
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def cell_state(cfg, B, S):
    """A train_lm cell's start: its weights from prng_key(0) on the card
    and the cell's batch pipeline."""
    params = lm.init_params(prng.prng_key(0), cfg, device="cuda")
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=0, n_logical_shards=B,
                               shard_range=(0, B))      # B rows a batch
    return params, pipe


def cell_layout(arch):
    """The cell's sharding policy (TRAIN_LAYOUT), or none, while open."""
    knobs = TRAIN_LAYOUT.get(arch)
    return act_sharding.policy(act_sharding.ActivationPolicy(**knobs)
                               if knobs else None)


def train_counts(jobs):
    """`launch.dryrun.count_train`'s peak GB of each (cfg, B, S, layout
    knobs) job, on `meta`: run in a spawned process while the phase works
    (`phase_train_lm`)."""
    out = []
    for cfg, B, S, knobs in jobs:
        with act_sharding.policy(act_sharding.ActivationPolicy(**knobs)
                                 if knobs else None):
            out.append(dryrun.count_train(cfg, B, S).peak_live_bytes / 1e9)
    return out


def train_cfg(arch, layers):
    """`arch`'s published config, cut to `layers` (None: whole)."""
    published = registry.get_config(arch)
    return published if layers is None else \
        dataclasses.replace(published, n_layers=layers)


def driver_full_rows():
    """The (rows, tokens) of a DRIVER_FULL step: its pipeline's batch."""
    cfg = registry.get_config(DRIVER_FULL["arch"])
    pipe = SyntheticLMPipeline(
        vocab_size=cfg.vocab_size, seq_len=DRIVER_FULL["seq_len"],
        global_batch=DRIVER_FULL["global_batch"], seed=0,
        n_logical_shards=DRIVER_FULL["global_batch"])
    return tuple(pipe.batch_at(0)["tokens"].shape)


def peak_against_count(count, peak):
    """A train step's card peak (GB) against `count`, its step's
    `count_train` (GB): gated within LAYOUT_PEAK_RATIO where the count is
    at least TRAIN_PEAK_GATE_GB."""
    ratio = peak / count
    gated = count >= TRAIN_PEAK_GATE_GB
    lo, hi = LAYOUT_PEAK_RATIO
    return {"counted_gb": count, "ratio": ratio, "gated": gated,
            "ok": not gated or lo <= ratio <= hi}


def train_plain_hold(cfg, B, S, losses):
    """The cell's steps again, from the same seed and on the same batches,
    with the plain versions in place of the kernels (forward and
    backward): each step's loss against the kernels' `losses`."""
    t0 = time.perf_counter()
    params, pipe = cell_state(cfg, B, S)
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    step_fn = train_step_fn(cfg, AdamWConfig(lr=TRAIN_LM_LR), len(losses))
    plain = []
    before = {**counts_lm(), **bwd_counts()}
    with plain_ops():
        for _ in losses:
            batch = batch_on(next(pipe), cfg, "cuda")
            params, opt, _, metrics = step_fn(params, opt, 0, batch)
            plain.append(float(metrics["loss"]))
    launched = {k: n - before[k] for k, n in {**counts_lm(),
                                               **bwd_counts()}.items()}
    del params, opt, step_fn
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(plain, losses)]
    return {"losses_plain": plain, "losses_kernels": losses, "rel": rel,
            "rtol": TRAIN_PLAIN_LOSS_RTOL, "kernel_launches": launched,
            "ok": max(rel) <= TRAIN_PLAIN_LOSS_RTOL
            and not any(launched.values()),
            "seconds": time.perf_counter() - t0}


def attention_pairs(kind, Sq, Sk, window) -> int:
    """The (query, key) pairs one head of one sequence computes: every
    pair under a bidirectional mask, else the keys each right-aligned
    query row sees (within its window)."""
    if kind == "bidir":
        return Sq * Sk
    seen = np.arange(Sk - Sq, Sk) + 1
    if kind == "window":
        seen = np.minimum(seen, window)
    return int(seen.sum())


def step_flops(cfg, B, S):
    """Model FLOPs of a train step: 6 a weight a token for each matmul
    weight (the head's included; an enc-dec config's encoder on its B x
    n_frames frames, the cross layers' k and v projections on the
    memory), plus attention's forward, 2 (dqk + dv) a head for each pair
    `attention_pairs` counts, three times; and the FLOPs the card runs:
    the same with the remat re-forwards (2 a weight a token more), the
    kernel route's attention 2.5 times more and the torch route's (MLA)
    once more."""
    T, M = B * S, cfg.memory_len()
    params = lm.init_params(None, cfg, device="meta")
    cross = {f"layer{i}" for i, s in enumerate(cfg.block_pattern)
             if s.mixer == "cross_attn"}

    def weights(stack, tokens):
        n = 0
        for path, t in flatten(stack):
            if t.dim() < 3 or path.endswith(("conv_w", "A_log")):
                continue
            parts = path.split("/")
            on_memory = parts[0] in cross and parts[-1] in ("wk", "wv")
            n += t.numel() * (B * M if on_memory else tokens)
        return n

    def attention_fwd(c, Sq):
        kernel = other = 0.0
        for spec in c.block_pattern:
            if spec.mixer == "mamba":
                continue
            kind = attention.MIXER_KIND[spec.mixer]
            if c.mla is not None and spec.mixer != "cross_attn":
                dqk = c.mla.qk_nope_head_dim + c.mla.qk_rope_head_dim
                dv = c.mla.v_head_dim
            else:
                dqk = dv = c.hd
            Sk = M if spec.mixer == "cross_attn" else Sq
            f = c.n_superblocks * B * c.n_heads * 2 * (dqk + dv) \
                * attention_pairs(kind, Sq, Sk, c.window)
            if on_kernel_route(c, spec):
                kernel += f
            else:
                other += f
        return kernel, other

    mm = weights(params["stack"], T) + cfg.d_model * cfg.vocab_size * T
    kernel, other = attention_fwd(cfg, S)
    if cfg.encoder is not None:
        mm += weights(params["encoder"]["stack"], B * M)
        k_enc, o_enc = attention_fwd(cfg.encoder_cfg(), M)
        kernel, other = kernel + k_enc, other + o_enc
    model = 6 * mm + 3 * (kernel + other)
    # + the superblocks' and the CE chunk's re-forwards; attention's
    # backward kernels run 7 products where the model counts 4 (QK^T and
    # dO V^T twice each, against once): the kernel route's attention once
    # more in the re-forward and 1.5 times more in the backward, the torch
    # route's once more in the re-forward
    return model, model + 2 * mm + 2.5 * kernel + other


def train_cell(arch, layers, B, S, steps, count, bad):
    """One model of the train_lm phase: layer-0 checks, card against CPU,
    then `steps` train steps with every count at 0 before each and read
    after it; its peak against `count()`, its step's `count_train` (GB).
    Returns the row and the launches."""
    published = registry.get_config(arch)
    cfg = train_cfg(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    params, pipe = cell_state(cfg, B, S)
    first = seeded_batch(pipe.batch_at(0), cfg, "cuda")
    torch.cuda.synchronize()
    walls["build_s"] = time.perf_counter() - t0
    # layer 0 before any AdamW state: the plain versions' (32, 6144, 6144)
    # fp32 scores at gemma2-27b take ~45 GB beside its 13.8 GB of weights
    t0 = time.perf_counter()
    layer0 = layer0_checks(arch, params, cfg, first)
    if not layer0["ok"]:
        bad.append(f"{arch}: layer 0 through the kernels: {layer0}")
    walls["layer0_s"] = time.perf_counter() - t0
    del first
    torch.cuda.empty_cache()
    with cell_layout(arch):
        vs_cpu = train_card_vs_cpu(params, cfg, [
            pipe.batch_at(s)
            for s in range(TRAIN_CPU_STEPS.get(arch, steps))], steps)
    if not vs_cpu["ok"]:
        bad.append(f"{arch}: card and CPU disagree: {vs_cpu}")
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    attn_layers, mamba_layers = kernel_layers(cfg)
    attn_layers += encoder_layers(cfg)
    # the forward and the remat re-forward, a layer a step (an encoder
    # layer's too); the backward kernels, one call (two launches) a layer
    # a step
    want = {"flash_attention": 2 * attn_layers,
            "mamba_scan": 2 * mamba_layers,
            "flash_attention_bwd": 2 * attn_layers,
            "mamba_scan_bwd": 2 * mamba_layers}
    step_fn = train_step_fn(cfg, AdamWConfig(lr=TRAIN_LM_LR), steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, times, per_step, profile = [], [], [], None
    for s in range(steps):
        batch = batch_on(next(pipe), cfg, "cuda")
        torch.cuda.synchronize()
        fa.launches = ms.launches = fa.bwd_launches = ms.bwd_launches = 0
        with cell_layout(arch):
            if s == steps - 1 and steps > 2:     # the last step, profiled
                profile, metrics = profiled_step(step_fn, params, opt, batch)
                params, opt = profile.pop("state")
            else:
                t1 = time.perf_counter()
                params, opt, _, metrics = step_fn(params, opt, 0, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
        per_step.append({**counts_lm(), **bwd_counts()})
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    walls["steps_s"] = time.perf_counter() - t0
    launches = {k: sum(p[k] for p in per_step) for k in want}
    if any(p != want for p in per_step):
        bad.append(f"{arch}: a step launched {per_step}, want {want}")
    if not all(np.isfinite(losses)):
        bad.append(f"{arch}: a loss is not finite: {losses}")
    t0 = time.perf_counter()
    counted = peak_against_count(count(), peak)
    walls["count_wait_s"] = time.perf_counter() - t0
    if not counted["ok"]:
        bad.append(f"{arch}: the peak against its count: {counted}")
    step_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    model_flops, remat_flops = step_flops(cfg, B, S)
    row = {"arch": arch, "layers": cfg.n_layers, "published_layers":
           published.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "reduced": [] if layers is None else
           [f"n_layers {layers} of {published.n_layers}"],
           "layout": TRAIN_LAYOUT.get(arch),
           "frames": None if cfg.encoder is None else
           f"steps: launch.train.batch_on: zeros ({B}, "
           f"{cfg.encoder.n_frames}, {cfg.d_model}) fp32, the driver's; "
           f"layer 0 and card vs CPU: seeded_source (seed "
           f"{LM_MEMORY_SEED}), unit normal",
           "batch": B, "seq": S, "steps": steps, "lr": TRAIN_LM_LR,
           "losses": losses, "step_s": times, "step_ms_median":
           step_s * 1e3, "tokens_per_s": B * S / step_s,
           "peak_mem_gb": peak,
           "peak_mem_gb_previous": TRAIN_PEAK_GB_PREVIOUS.get(arch),
           "peak_counted": counted,
           "launches_per_step": per_step,
           "want_launches_per_step": want,
           "model_tflop": model_flops / 1e12,
           "model_tflop_with_remat": remat_flops / 1e12,
           "mfu_bf16": model_flops / step_s / BF16_FLOPS,
           "hfu_bf16_with_remat": remat_flops / step_s / BF16_FLOPS,
           "step_floor_ms": remat_flops / BF16_FLOPS * 1e3,
           "profiled_step": profile, "layer0": layer0, "card_vs_cpu": vs_cpu,
           "walls": walls}
    del params, opt, step_fn
    torch.cuda.empty_cache()
    if arch in TRAIN_PLAIN_HOLD:
        row["plain_hold"] = train_plain_hold(cfg, B, S, losses)
        if not row["plain_hold"]["ok"]:
            bad.append(f"{arch}: the plain versions' steps: "
                       f"{row['plain_hold']}")
    return row, launches


def profiled_step(step_fn, params, opt, batch):
    """One train step under torch.profiler: wall ms to a synchronize,
    device busy ms (the sum of its kernels: one stream), idle share and
    the top kernels by device time. Device activity only: falcon's step
    runs ~250 k kernels, and the host ops' events would take minutes to
    read back. The events are read once; null where none came back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, metrics = step_fn(params, opt, 0, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    row = {"wall_ms": wall, "device_busy_ms": None,
           "device_idle_share": None, "by_kernel_ms": [],
           "read_s": time.perf_counter() - t0 - wall / 1e3,
           "state": (params, opt)}
    if by_kernel:
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        by_class = {}
        for name, t in by_kernel.items():
            c = kernel_class(name)
            by_class[c] = by_class.get(c, 0.0) + t
        row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
                   device_kernels=len(by_kernel), by_class_ms=by_class,
                   by_kernel_ms=[{"name": k[:80], "ms": v} for k, v in top])
    return row, metrics


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: the port's LM kernels and
    their backward kernels, cuBLAS products, reductions, or elementwise
    and copies."""
    for kernel in ("flash_wgmma_kernel", "flash_decode_kernel",
                   "flash_f32_kernel", "mamba_scan_kernel",
                   "attn_bwd_dq", "attn_bwd_dkv", "scan_bwd_kernel",
                   "scan_bwd_sum_kernel"):
        if kernel in name:
            return kernel
    if any(k in name for k in ("gemm", "nvjet", "xmma", "gemv", "cutlass")):
        return "matmul"
    if "reduce_kernel" in name:
        return "reduction"
    return "elementwise and copies"


def train_driver(bad):
    """`launch.train.train` itself on the card at the reduced qwen1.5-4b:
    DRIVER's steps with an asynchronous checkpoint, then a restore that
    runs DRIVER_MORE more; a temporary directory under build/."""
    cfg = registry.reduced(registry.get_config(DRIVER["arch"]))
    per_step = 2 * cfg.n_superblocks * len(cfg.block_pattern)
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        kw = {k: v for k, v in DRIVER.items() if k != "steps"}
        fa.launches = ms.launches = fa.bwd_launches = 0
        _, losses = train_lm(**kw, steps=DRIVER["steps"], ckpt_dir=tmp,
                             log_every=0, device="cuda")
        launched = {"flash_attention": fa.launches,
                    "flash_attention_bwd": fa.bwd_launches}
        on_disk = Checkpointer(tmp).steps()
        _, more = train_lm(**kw, steps=DRIVER["steps"] + DRIVER_MORE,
                           ckpt_dir=tmp, restore=True, log_every=0,
                           device="cuda")
        after = Checkpointer(tmp).steps()
    row = {"arch": DRIVER["arch"] + " (reduced)", **DRIVER,
           "losses": losses, "launches": launched,
           "want_launches": {k: per_step * DRIVER["steps"] for k in launched},
           "checkpoints": on_disk, "restored_losses": more,
           "checkpoints_after_restore": after,
           "seconds": time.perf_counter() - t0}
    row["ok"] = (launched == row["want_launches"]
                 and all(np.isfinite(losses + more))
                 and losses[-1] < losses[0]
                 and on_disk == [DRIVER["ckpt_every"], DRIVER["steps"]]
                 and len(more) == DRIVER_MORE
                 and after[-1] == DRIVER["steps"] + DRIVER_MORE)
    if not row["ok"]:
        bad.append(f"train driver: {row}")
    return row, launched


@contextlib.contextmanager
def driver_steps(record):
    """`launch.train.train`'s steps while open: each with every count at 0
    before it (`zero_step_counts`) and read after it, timed to a
    synchronize, its tokens' shape kept; a dict each in `record`."""
    make = train_lib.make_train_step

    def counted(*args, **kw):
        step_fn = make(*args, **kw)

        def step(params, opt, err, batch):
            zero_step_counts()
            t0 = time.perf_counter()
            out = step_fn(params, opt, err, batch)
            torch.cuda.synchronize()
            record.append({"s": time.perf_counter() - t0,
                           "tokens": list(batch["tokens"].shape),
                           **counts_lm(), **bwd_counts()})
            return out
        return step
    train_lib.make_train_step = counted
    try:
        yield
    finally:
        train_lib.make_train_step = make


def train_driver_full(rows, count, bad):
    """`launch.train.train` itself on the card at DRIVER_FULL's published
    widths: each step's loss, launches and seconds, tokens/s, and the
    run's peak against `count()`, the `count_train` (GB) of a step of
    `rows` (its pipeline's rows and tokens), which every step must take."""
    cfg = registry.get_config(DRIVER_FULL["arch"])
    per_step = 2 * cfg.n_superblocks * len(cfg.block_pattern)
    want = {"flash_attention": per_step, "mamba_scan": 0,
            "flash_attention_bwd": per_step, "mamba_scan_bwd": 0}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record = []
    t0 = time.perf_counter()
    with driver_steps(record):
        losses = train_lm(**DRIVER_FULL, log_every=0, device="cuda")[1]
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    B, S = rows
    times = [r["s"] for r in record]
    step_s = float(np.median(times[1:]))
    launched = [{k: r[k] for k in want} for r in record]
    row = {"arch": DRIVER_FULL["arch"], **DRIVER_FULL,
           "layers": cfg.n_layers, "params": cfg.param_count(),
           "rows": B, "seq": S, "losses": losses, "step_s": times,
           "step_ms_median": step_s * 1e3, "tokens_per_s": B * S / step_s,
           "launches_per_step": launched, "want_launches_per_step": want,
           "peak_mem_gb": peak,
           "peak_counted": peak_against_count(count(), peak),
           "seconds": seconds}
    row["ok"] = (len(losses) == DRIVER_FULL["steps"]
                 and all(tuple(r["tokens"]) == rows for r in record)
                 and all(np.isfinite(losses))
                 and all(n == want for n in launched)
                 and row["peak_counted"]["gated"]
                 and row["peak_counted"]["ok"])
    if not row["ok"]:
        bad.append(f"train driver at full width: {row}")
    return row, {k: sum(n[k] for n in launched) for k in want}


def phase_train_lm():
    """The LM training path on the card: each TRAIN_LM_CELLS model at
    full width (cut depth), then the driver. Every check runs before any
    fails. Returns the phase's launches."""
    bad, rows = [], []
    total = {**counts_lm(), **bwd_counts()}
    total = {k: 0 for k in total}
    t0 = time.perf_counter()
    full_rows = driver_full_rows()
    jobs = [(train_cfg(arch, layers), B, S, TRAIN_LAYOUT.get(arch))
            for arch, layers, B, S, _ in TRAIN_LM_CELLS]
    jobs.append((registry.get_config(DRIVER_FULL["arch"]), *full_rows, None))
    # the `meta` counts (~20 s of Python) run in a process of their own
    # beside the first cell's CPU work
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        counted = pool.submit(train_counts, jobs)
        for i, cell in enumerate(TRAIN_LM_CELLS):
            row, launched = train_cell(
                *cell, lambda i=i: counted.result()[i], bad)
            rows.append(row)
            total = {k: total[k] + launched[k] for k in total}
        driver, launched = train_driver(bad)
        for k, n in launched.items():
            total[k] += n
        driver_full, launched = train_driver_full(
            full_rows, lambda: counted.result()[-1], bad)
        for k, n in launched.items():
            total[k] += n
    emit({"phase": "train_lm", "models": rows, "driver": driver,
          "driver_full": driver_full, "launches": total,
          "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi(), "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"train_lm phase: {bad}")
    return total


# ------------------------------------------------------------ layout phase
# the dry run against the card at the train_lm phase's qwen3-8b cell:
# full width, LAYOUT_LAYERS of 36 layers, LAYOUT_B x LAYOUT_S tokens
LAYOUT_ARCH, LAYOUT_LAYERS, LAYOUT_B, LAYOUT_S = "qwen3-8b", 12, 4, 1024
LAYOUT_CLIMB_ITERS = 4
# the card's max_memory_allocated over the dry run's peak live bytes: the
# allocator holds every live tensor (at least 1, less a little for
# tensors the count sees and the allocator does not, such as host
# scalars) plus its 512-byte rounding, cuBLAS's workspaces and blocks
# freed but not yet reused (1.0011 in the first card run, PERF.md)
LAYOUT_PEAK_RATIO = (0.99, 1.02)
LAYOUT_STEPS = 2           # timed steps a layout, after one warm-up step
# the layouts run for real differ only in knobs that leave the step's math
# as it is (remat, ce_chunk, attn_remat; the sharding-only attn_mode and
# kv_seq_shard are no-ops on one card): each step's loss within this of
# the baseline's
LAYOUT_LOSS_RTOL = 1e-2
MATH_KNOBS = ("grad_compress", "mla_absorb", "attn_scores_bf16",
              "moe_dispatch")
# MLA's absorbed decode at minicpm3-4b, full width and depth: B requests
# over a cache of MLA_CACHE tokens; logits within MLA_LOGIT_RTOL of the
# largest |logit| of the expanded path (the lm phase's limit)
MLA_ARCH, MLA_B, MLA_CACHE, MLA_LOGIT_RTOL = "minicpm3-4b", 8, 2048, 3e-2
MLA_REPS = 5
# dbrx-132b's MoE block: full width at 1 x MOE_TOKENS; the gate at the
# reduced width (fp32 compute), card against CPU with the CPU's routing
MOE_ARCH, MOE_TOKENS, MOE_MESH = "dbrx-132b", 2048, (16, 16)
MOE_SMALL_TOKENS, MOE_RTOL = 256, 1e-4
MOE_MODES = ("global", "local", "shard_map")


def layout_cfg():
    return dataclasses.replace(registry.get_config(LAYOUT_ARCH),
                               n_layers=LAYOUT_LAYERS)


def layout_shape():
    return ShapeConfig("train_lm", LAYOUT_S, LAYOUT_B, "train")


def layout_state(cfg):
    """Parameters from prng_key(0), fresh AdamW state, and the pipeline's
    first LAYOUT_STEPS + 1 batches (tokens only: the dry run's batch), all
    on the card."""
    torch.cuda.empty_cache()
    params = lm.init_params(prng.prng_key(0), cfg, device="cuda")
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=LAYOUT_S,
                               global_batch=LAYOUT_B, seed=0,
                               n_logical_shards=LAYOUT_B,
                               shard_range=(0, LAYOUT_B))
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i)["tokens"],
                                          device="cuda")}
               for i in range(LAYOUT_STEPS + 1)]
    return params, opt, batches


def op_classes(counter):
    """A count's ops, FLOPs and bytes by class, each as its share of the
    total: AdamW's `_foreach` passes, matmuls, casts and copies, the
    other elementwise ops and reductions, and the kernels' records."""
    out = {"kernels": {"ops": len(counter.kernels),
                       "flops": sum(k["flops"] for k in counter.kernels),
                       "bytes": sum(k["bytes"] for k in counter.kernels)}}
    for name, (n, flops, n_bytes) in counter.by_op.items():
        c = ("adamw _foreach" if name.startswith("_foreach") else
             "matmul" if name in ("mm", "addmm", "bmm", "baddbmm") else
             "casts and copies" if name in ("_to_copy", "copy_", "clone")
             else "other elementwise and reductions")
        r = out.setdefault(c, {"ops": 0, "flops": 0, "bytes": 0})
        r["ops"] += n
        r["flops"] += flops
        r["bytes"] += n_bytes
    for r in out.values():
        r["flops_share"] = r["flops"] / counter.flops
        r["bytes_share"] = r["bytes"] / counter.bytes
    return out


def layout_dry_vs_card(cfg, bad):
    """One train step counted on meta and the same step counted on the
    card: FLOPs, bytes and the kernels' records must be equal. Returns the
    row and the card's flash_attention (forward and backward) launches."""
    shape = layout_shape()
    t0 = time.perf_counter()
    meta, meta_mem, meta_s = dryrun.count_step(cfg, shape, BASELINE)
    params, opt, batches = layout_state(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = 0
    card, card_mem, card_s = dryrun.count_step(
        cfg, shape, BASELINE, inputs=(params, opt, batches[0]))
    torch.cuda.synchronize()
    launched = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batches
    torch.cuda.empty_cache()
    model_flops = rl.model_flops(cfg, shape, dryrun._useful_params(cfg))
    same = {"flops": meta.flops == card.flops,
            "bytes": meta.bytes == card.bytes,
            "kernels": meta.kernel_totals() == card.kernel_totals()}
    row = {"arch": LAYOUT_ARCH, "layers": LAYOUT_LAYERS,
           "batch": LAYOUT_B, "seq": LAYOUT_S, "layout": BASELINE.name(),
           "meta": {"flops": meta.flops, "bytes": meta.bytes,
                    "ops": meta.ops, "kernels": meta.kernel_totals(),
                    "peak_live_bytes": meta.peak_live_bytes,
                    "argument_bytes": meta_mem["argument"],
                    "by_class": op_classes(meta), "seconds": meta_s},
           "card": {"flops": card.flops, "bytes": card.bytes,
                    "ops": card.ops, "kernels": card.kernel_totals(),
                    "peak_live_bytes": card.peak_live_bytes,
                    "max_memory_allocated": peak, "seconds": card_s},
           "equal": same,
           "peak_ratio_card_over_meta": peak / meta.peak_live_bytes,
           "model_flops": model_flops,
           "step_flops": step_flops(cfg, LAYOUT_B, LAYOUT_S)[0],
           "model_over_step_flops": model_flops
           / step_flops(cfg, LAYOUT_B, LAYOUT_S)[0],
           "launches": launched,
           "want_launches": {"flash_attention": 2 * cfg.n_layers,
                             "flash_attention_bwd": 2 * cfg.n_layers},
           "seconds": time.perf_counter() - t0}
    if not all(same.values()):
        bad.append(f"dry run and card count differ: {same}")
    lo, hi = LAYOUT_PEAK_RATIO
    if not lo <= row["peak_ratio_card_over_meta"] <= hi:
        bad.append(f"card peak over the dry run's: "
                   f"{row['peak_ratio_card_over_meta']} outside {lo}-{hi}")
    if launched != row["want_launches"]:
        bad.append(f"the counted card step launched {launched}, want "
                   f"{row['want_launches']}")
    return row, launched


class CutReoptimizer(LayoutReoptimizer):
    """The re-optimizer on the cut train_lm cell: each evaluation is the
    port's dry run at `cfg` and `shape`."""

    def __init__(self, cfg, shape, out_dir):
        super().__init__(cfg.name, shape.name, out_dir=out_dir)
        self.cfg, self.shape_cfg = cfg, shape

    def evaluate(self, layout):
        return dryrun.run_cell(self.arch, self.shape, verbose=False,
                               layout=layout, cfg=self.cfg,
                               shape=self.shape_cfg)


def layout_climb(cfg):
    t0 = time.perf_counter()
    opt = CutReoptimizer(cfg, layout_shape(),
                         ROOT / "build" / "chip_smoke_perf")
    best, logs = opt.climb(max_iters=LAYOUT_CLIMB_ITERS, kind="train")
    terms = ("compute", "memory", "collective")
    rows = [{"iteration": l.iteration, "hypothesis": l.hypothesis,
             "layout": l.layout, "predicted_multipliers": l.predicted,
             "predicted": {k: l.before[k] * l.predicted[k] for k in terms}
             if l.predicted else None,
             "before": l.before, "counted": l.after, "verdict": l.verdict}
            for l in logs]
    return best, {"chosen": best.name(), "iterations": rows,
                  "seconds": time.perf_counter() - t0}


def math_same(a, b) -> bool:
    return all(getattr(a, k) == getattr(b, k) for k in MATH_KNOBS)


def layout_run(cfg, layout):
    """A warm-up step and LAYOUT_STEPS timed steps of `layout` on the card
    from the seeded weights and the same batches; the step's roofline from
    the dry run."""
    params, opt, batches = layout_state(cfg)
    step = steps_lib.step_fn(cfg, layout_shape())
    if layout.grad_compress:
        step = steps_lib.make_train_step(cfg, grad_compress=True)
    pol = dryrun.layout_policy(make_production_mesh(), layout)
    losses, times, launches, bwd = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with act_sharding.policy(pol):
        for i, batch in enumerate(batches):
            fa.launches = fa.bwd_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            launches.append(fa.launches)
            bwd.append(fa.bwd_launches)
            losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batches
    torch.cuda.empty_cache()
    rec = dryrun.run_cell(cfg.name, "train_lm", verbose=False, layout=layout,
                          cfg=cfg, shape=layout_shape())
    mode = "none" if layout.remat == "none" else "remat"
    want = (1 if mode == "none" else 2) * cfg.n_layers
    return {"layout": layout.name(), "losses": losses, "step_s": times,
            "step_ms_median": float(np.median(times)) * 1e3,
            "peak_gb": peak / 1e9, "launches_per_step": launches,
            "want_launches_per_step": want,
            # one backward call (two launches) a layer, in every mode
            "bwd_launches_per_step": bwd,
            "want_bwd_launches_per_step": 2 * cfg.n_layers,
            "t_bound_s": rec["roofline"]["t_bound_s"],
            "bottleneck": rec["roofline"]["bottleneck"],
            "counted_peak_gb": rec["memory"]["live_bytes_per_device"] / 1e9}


def layout_runs(cfg, best, bad):
    """The baseline, the climb's choice (where it differs) and the remat
    "dots" flip, run for real."""
    layouts = [BASELINE]
    if best.name() != BASELINE.name():
        layouts.append(best)
    dots = dataclasses.replace(BASELINE, remat="dots")
    if all(dots.name() != l.name() for l in layouts):
        layouts.append(dots)
    runs = [layout_run(cfg, l) for l in layouts]
    base = runs[0]
    for lay, run in zip(layouts, runs):
        run["loss_gate"] = math_same(lay, BASELINE)
        if run["loss_gate"]:
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], base["losses"]))
            run["loss_rel_to_baseline"] = rel
            if rel > LAYOUT_LOSS_RTOL or not all(np.isfinite(run["losses"])):
                bad.append(f"layout {run['layout']}: losses {run['losses']} "
                           f"against the baseline's {base['losses']}")
        if any(n != run["want_launches_per_step"]
               for n in run["launches_per_step"]) or any(
                n != run["want_bwd_launches_per_step"]
                for n in run["bwd_launches_per_step"]):
            bad.append(f"layout {run['layout']}: launched "
                       f"{run['launches_per_step']} and "
                       f"{run['bwd_launches_per_step']} (backward) a step")
    by_card = sorted(range(len(runs)), key=lambda i: runs[i]["step_ms_median"])
    by_roof = sorted(range(len(runs)), key=lambda i: runs[i]["t_bound_s"])
    return runs, {"card_order": [runs[i]["layout"] for i in by_card],
                  "roofline_order": [runs[i]["layout"] for i in by_roof],
                  "same_order": by_card == by_roof}


def reset_heads(cache, pos):
    for entry in cache.values():
        if "pos" in entry:
            entry["pos"].fill_(pos)


def layout_mla(bad):
    """minicpm3-4b at full width and depth: a decode step of MLA_B
    requests over a MLA_CACHE-token cache (prefilled from random prompts),
    with and without mla_absorb, on the same cache."""
    cfg = registry.get_config(MLA_ARCH)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    serving = lm.serving_params(
        lm.init_params(prng.prng_key(0), cfg, device="cuda"), cfg)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    P = MLA_CACHE - 1
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (MLA_B, P)),
                              dtype=torch.int32, device="cuda")
    token = torch.as_tensor(rng.integers(2, cfg.vocab_size, (MLA_B, 1)),
                            dtype=torch.int32, device="cuda")
    out = {}
    with torch.inference_mode():
        _, cache = lm.prefill(serving, prompts, cfg, MLA_CACHE)
        for name, absorb in (("expanded", False), ("absorbed", True)):
            pol = act_sharding.ActivationPolicy(mla_absorb=absorb)
            with act_sharding.policy(pol):
                def one():
                    reset_heads(cache, P)
                    return lm.decode_step(serving, token, cache, cfg, P)[0]
                logits = one().float()
                ms_step = cuda_ms(one, launches=1, reps=MLA_REPS, warmup=2)
            out[name] = (logits, ms_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del serving, cache
    torch.cuda.empty_cache()
    (want, ms_x), (got, ms_a) = out["expanded"], out["absorbed"]
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    shape = ShapeConfig("decode_2k", MLA_CACHE, MLA_B, "decode")
    recs = {name: dryrun.run_cell(
        MLA_ARCH, shape.name, verbose=False, cfg=cfg, shape=shape,
        layout=dataclasses.replace(BASELINE, mla_absorb=absorb))
        for name, absorb in (("expanded", False), ("absorbed", True))}
    flops = {k: r["hlo_analysis"]["flops"] for k, r in recs.items()}
    row = {"arch": MLA_ARCH, "layers": cfg.n_layers, "batch": MLA_B,
           "cache": MLA_CACHE, "params": cfg.param_count(),
           "max_abs_err": err, "largest_logit": top,
           "rel_err": err / top, "rtol": MLA_LOGIT_RTOL,
           "finite": bool(torch.isfinite(got).all()),
           "argmax_equal_share": float(
               (got.argmax(-1) == want.argmax(-1)).float().mean()),
           "decode_ms": {"expanded": ms_x, "absorbed": ms_a},
           "card_speedup": ms_x / ms_a,
           "dry_run_flops": flops,
           "dry_run_flop_ratio": flops["expanded"] / flops["absorbed"],
           "dry_run_t_bound_ms": {k: r["roofline"]["t_bound_s"] * 1e3
                                  for k, r in recs.items()},
           "peak_gb": peak, "seconds": time.perf_counter() - t0}
    if not row["finite"] or err > MLA_LOGIT_RTOL * top:
        bad.append(f"MLA absorbed decode: {row}")
    return row


def moe_case(cfg, T, device, gen):
    """One MoE layer's parameters from prng_key(0) and a (1, T, D) input
    from `gen`, on `device` (bf16 at full width: the serving copy)."""
    p = moe.init_moe(prng.prng_key(0), cfg, device=device)
    p = {k: v.to(cfg.cdtype) if k.startswith("moe_w") else v
         for k, v in p.items()}
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=device)
    return p, x.to(cfg.cdtype)


def moe_policy(mode):
    dp, tp = MOE_MESH
    return act_sharding.ActivationPolicy(
        dp_size=dp, tp_size=tp, moe_dispatch=mode,
        mesh=make_production_mesh())


def layout_moe(bad):
    """dbrx-132b's MoE block through the global, block-local and
    shard_map dispatches: card against CPU at the reduced width with the
    CPU's routing imposed, then each dispatch's time at full width."""
    t0 = time.perf_counter()
    full = registry.get_config(MOE_ARCH)
    small = dataclasses.replace(
        registry.reduced(full), compute_dtype="float32",
        moe=dataclasses.replace(registry.reduced(full).moe,
                                n_experts=full.moe.n_experts,
                                top_k=full.moe.top_k))
    gen = torch.Generator().manual_seed(0)
    p_cpu, x_cpu = moe_case(small, MOE_SMALL_TOKENS, "cpu", gen)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    rows = {}
    for mode in MOE_MODES:
        with act_sharding.policy(moe_policy(mode)), torch.inference_mode():
            routed = []
            real_route = moe.route

            def keep(probs, K):
                routed.append(real_route(probs, K))
                return routed[-1]
            moe.route = keep
            try:
                want, _ = moe.apply_moe(p_cpu, x_cpu, small)
            finally:
                moe.route = real_route
            gate, eidx = routed[0]
            moe.route = lambda probs, K: (gate.to(probs.device),
                                          eidx.to(probs.device))
            try:
                got, _ = moe.apply_moe(p_gpu, x_cpu.cuda(), small)
            finally:
                moe.route = real_route
        err = float((got.cpu() - want).abs().max())
        top = float(want.abs().max())
        rows[mode] = {"max_abs_err": err, "largest": top,
                      "rel_err": err / top, "rtol": MOE_RTOL}
        if not err <= MOE_RTOL * top:
            bad.append(f"MoE {mode} dispatch: card and CPU differ: "
                       f"{rows[mode]}")
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    p, x = moe_case(full, MOE_TOKENS, "cuda", gen)
    outs = {}
    with torch.inference_mode():
        for mode in MOE_MODES:
            with act_sharding.policy(moe_policy(mode)):
                outs[mode] = moe.apply_moe(p, x, full)[0].float()
                rows[mode]["ms"] = cuda_ms(
                    lambda: moe.apply_moe(p, x, full), launches=1, reps=5,
                    warmup=2)
                rows[mode]["finite"] = bool(torch.isfinite(outs[mode]).all())
    for mode in MOE_MODES:
        rows[mode]["rel_norm_to_global"] = float(
            (outs[mode] - outs["global"]).norm() / outs["global"].norm())
        if not rows[mode]["finite"]:
            bad.append(f"MoE {mode} dispatch at full width is not finite")
    expert_gb = sum(p[k].numel() * p[k].element_size()
                    for k in ("moe_wg", "moe_wu", "moe_wd")) / 1e9
    del p, x, outs
    torch.cuda.empty_cache()
    return {"arch": MOE_ARCH, "experts": full.moe.n_experts,
            "top_k": full.moe.top_k, "d_model": full.d_model,
            "d_ff": full.moe_d_ff, "tokens": MOE_TOKENS,
            "mesh": list(MOE_MESH), "expert_gb": expert_gb,
            "gate_at": {"d_model": small.d_model, "d_ff": small.moe_d_ff,
                        "tokens": MOE_SMALL_TOKENS, "dtype": "float32"},
            "dispatch": rows, "seconds": time.perf_counter() - t0}


def layout_psum(bad):
    """compressed_psum on a one-rank NCCL group made from a HashStore:
    the sum of one rank is its own quantize-then-dequantize."""
    import torch.distributed as dist
    x = torch.randn((1024, 1024), generator=torch.Generator(
        "cuda").manual_seed(3), device="cuda") * 3
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        got = compressed_psum(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    q, s = quantize_int8(x)
    want = dequantize_int8(q, s)
    row = {"shape": list(x.shape), "equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max())}
    if not row["equal"]:
        bad.append(f"compressed_psum: {row}")
    return row


def phase_layout():
    """The layout re-optimizer and its tooling on the card (see the
    module docstring). Every check runs before any fails. Returns the
    phase's flash_attention launches, forward and backward."""
    bad = []
    t0 = time.perf_counter()
    cfg = layout_cfg()
    dry, launched = layout_dry_vs_card(cfg, bad)
    best, climb = layout_climb(cfg)
    runs, order = layout_runs(cfg, best, bad)
    launched = dict(launched)
    launched["flash_attention"] += sum(sum(r["launches_per_step"])
                                       for r in runs)
    launched["flash_attention_bwd"] += sum(sum(r["bwd_launches_per_step"])
                                           for r in runs)
    mla = layout_mla(bad)
    moe_row = layout_moe(bad)
    psum = layout_psum(bad)
    emit({"phase": "layout", "dry_run_vs_card": dry, "climb": climb,
          "runs": runs, "order": order, "mla_absorb": mla, "moe": moe_row,
          "compressed_psum": psum, "launches": launched,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi(),
          "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"layout phase: {bad}")
    return launched


# ------------------------------------------------------------- shard phase
# The LM serving path across cards: `BatchedServer(mesh=...)` on the host
# mesh (1, SHARD_RANKS), one process a rank, dp = 1, tp = SHARD_RANKS,
# under the reference's `shard_map` MoE dispatch (`models/moe.py`): each
# rank draws and runs only its E/tp experts, every other leaf whole, and
# an all_reduce a MoE layer sums the ranks' outputs; the lm phase's 8
# prompts of 128 tokens and 32 greedy tokens. (arch, layers on four
# cards (None: the published depth), layers on one card): on four cards
# dbrx-132b and llama4-scout whole (36.5 B and 35.4 B parameters a rank,
# 73 and 71 GB) and jamba-1.5-large at two superblocks of its pattern,
# 16 of 72 layers (~62 GB a rank); with fewer cards the same code runs
# its SHARD_RANKS ranks over gloo on the cards there are, each rank's
# experts and its own copy of every other leaf on the card, at depths
# whose four ranks fit one 80 GB card: dbrx at 4 layers (12.7 B experts
# and 4 x 1.58 B replicated, ~38 GB), llama4 at one superblock of 4
# layers with its NoPE layer (~39 GB) and jamba's first 2 layers (a
# Mamba layer with its MLP and a Mamba layer with MoE, ~39 GB: four
# ranks of its first attention layer would need ~76 GB).
SHARD_CELLS = (("dbrx-132b", None, 4), ("jamba-1.5-large-398b", 16, 2),
               ("llama4-scout-17b-a16e", None, 4))
SHARD_RANKS = 4
# tp = 4 against tp = 1 at the one-card depths: the same seed and
# prompts served once by SHARD_RANKS ranks and once by a one-rank group
# on one card (all 16 experts, its all_reduce a no-op). The tp = 4 ranks
# are fed the tp = 1 run's greedy tokens and its experts (`RouteTap`, as
# the lm phase imposes the CPU's on the card: the ranks sum their top-k
# partials in bf16 in another order, and at dbrx's top-4 a router near a
# tie then picks another expert), so that every step compares the same
# inputs. The prefill's and the first LM_CPU_STEPS decode steps' logits
# within LM_LOGIT_RTOL of the tp = 1 run's largest |logit| (the scope
# and the bf16 limit of the lm phase's card-vs-CPU check); every step's
# share of that limit printed (later steps read caches that the other
# order of sums has moved apart for longer: 1.067 of it at dbrx's step
# 21 in the first run with the experts imposed, PERF.md); the greedy
# tokens equal at every step wherever the tp = 1 top-2 margin exceeds
# twice the limit (each of two logits may move by it), a step below it
# printed with its margin.
# Each rank's `max_memory_allocated` over its build and `generate` (less
# what the process held before the build) within SHARD_PEAK_RATIO of the
# rank's program counted on `meta` (`launch.dryrun.count_serve`, the
# layout phase's ratio).
SHARD_PEAK_RATIO = LAYOUT_PEAK_RATIO
SHARD_TIMEOUT_S = 480      # a spawn of ranks, joined or stopped by then
SHARD_AR_REPS = 20         # all_reduce calls timed a shape
# NVLink 4 on an H100 SXM: 18 links of 25 GB/s each way. A ring
# all_reduce of n bytes over r ranks sends and receives 2 (r - 1) / r n
# bytes a rank.
NVLINK_BYTES_PER_S = 450e9


def shard_cfg(arch, layers):
    """`arch`'s published config at `layers` (None: as published); a
    depth that is not a whole number of superblocks keeps the pattern's
    first `layers` layers."""
    published = registry.get_config(arch)
    if layers is None:
        return published
    n = len(published.block_pattern)
    if layers % n == 0:
        return dataclasses.replace(published, n_layers=layers)
    return dataclasses.replace(published, n_layers=layers,
                               block_pattern=published.block_pattern[:layers])


def moe_layers(cfg) -> int:
    return cfg.n_superblocks * sum(s.ffn == "moe" for s in cfg.block_pattern)


def all_reduce_ms(mesh, rows, cfg):
    """ms of one all_reduce of a (rows, d_model) tensor in cfg.cdtype over
    the mesh's group (the MoE layer's psum), host clock to a synchronize
    over SHARD_AR_REPS calls after a barrier; its bytes and the NVLink
    bound (NCCL only: gloo goes through host memory)."""
    import torch.distributed as dist
    x = torch.zeros((rows, cfg.d_model), dtype=cfg.cdtype,
                    device=mesh.device)
    for _ in range(3):
        dist.all_reduce(x, group=mesh.group)
    torch.cuda.synchronize()
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(SHARD_AR_REPS):
        dist.all_reduce(x, group=mesh.group)
    torch.cuda.synchronize()
    ms_call = (time.perf_counter() - t0) * 1e3 / SHARD_AR_REPS
    n_bytes = x.numel() * x.element_size()
    r = mesh.size
    nccl = dist.get_backend(mesh.group) == "nccl"
    bound = 2 * (r - 1) / r * n_bytes / NVLINK_BYTES_PER_S * 1e3
    return {"rows": rows, "bytes": n_bytes, "ms": ms_call,
            "nvlink_bound_ms": bound if nccl and r > 1 else None}


def shard_steps(server, prompts, forced, lead, keep):
    """The prefill and LM_GEN decode steps of `generate` again, under the
    server's policy, fed `forced` tokens ((LM_GEN + 1, B, 1): the tp = 1
    run's) or, without them, their own greedy tokens. Returns (the
    median host ms of a step over the first LM_GEN - LM_PROFILED, the
    last LM_PROFILED steps' profile on `lead`, the (LM_GEN + 1, B, V)
    fp32 logits on the CPU (`lead` and `keep` only: kept on the card
    until the last step, so that no copy falls in the profile) and the
    fed tokens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg, p = server.cfg, server.serving
    toks = torch.as_tensor(prompts.astype(np.int64), device=server.device)
    times, logits_all, fed = [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with torch.inference_mode(), server.sharded():
        logits, cache = lm.prefill(p, toks, cfg, LM_PROMPT + LM_GEN)
        for t in range(LM_GEN + 1):
            if lead and keep:
                logits_all.append(logits.float())
            tok = (forced[t].to(server.device) if forced is not None
                   else logits.argmax(-1)[:, None])
            fed.append(tok)
            if t == LM_GEN:
                break
            if lead and t == LM_GEN - LM_PROFILED:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(p, tok, cache, cfg, LM_PROMPT + t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if lead:
            prof.stop()
    row = {"steps": LM_PROFILED, "wall_ms": float(np.mean(
        times[-LM_PROFILED:])), "device_busy_ms": None,
        "device_idle_share": None, "by_kernel_ms": []}
    if lead:
        by_kernel = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / LM_PROFILED
        if by_kernel:      # else not measured: the profiler lost the events
            busy = sum(by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            row.update(device_busy_ms=busy,
                       device_idle_share=1.0 - busy / row["wall_ms"],
                       by_kernel_ms=[{"name": k[:80], "ms": v}
                                     for k, v in top])
    return (float(np.median(times[:-LM_PROFILED])), row,
            torch.stack(logits_all).cpu() if logits_all else None,
            torch.stack(fed).cpu())


def tp_agreement(got, want):
    """tp = 4's logits against tp = 1's, step by step (0: the prefill);
    the logits of steps 0 .. LM_CPU_STEPS held to the limit, every
    step's tokens."""
    rows, flips = [], []
    for t in range(len(want)):
        w, g = want[t], got[t]
        limit = LM_LOGIT_RTOL * float(w.abs().max())
        err = float((g - w).abs().max())
        top2 = w.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = g.argmax(-1) == w.argmax(-1)
        sure = margin > 2 * limit
        for b in torch.nonzero(~sure).flatten().tolist():
            flips.append({"step": t, "row": b, "margin": float(margin[b]),
                          "limit": limit, "same_token": bool(same[b])})
        held = t <= LM_CPU_STEPS
        rows.append({"step": t, "max_abs_err": err, "limit": limit,
                     "share": err / limit, "held": held,
                     "ok": (err <= limit or not held)
                     and bool(same[sure].all())})
    return {"prefill": rows[0], "worst_share_held": max(
        r["share"] for r in rows if r["held"]),
        "worst_share": max(r["share"] for r in rows),
        "shares": [r["share"] for r in rows],
        "steps_ok": all(r["ok"] for r in rows),
        "bad_steps": [r for r in rows if not r["ok"]],
        "below_margin": flips}


def shard_serve(mesh, arch, layers, mode, ref_dir):
    """One model on this rank. mode: "ref" (tp = 1: writes its logits,
    tokens and experts to ref_dir), "agree" (tp = 4 at the same depth, fed
    the ref's tokens and experts, rank 0 compares) or "full" (tp = 4,
    four cards). Returns this rank's row."""
    import torch.distributed as dist
    cfg = shard_cfg(arch, layers)
    lead = mesh.rank == 0
    bad, stage = [], {}
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        stage[name] = now - clock
        clock = now
    gc.collect()
    torch.cuda.empty_cache()
    counted = dryrun.count_serve(cfg, LM_REQUESTS, LM_PROMPT, LM_GEN,
                                 mesh=mesh).peak_live_bytes
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # what the process held before
    threefry.normal_launches = 0
    dist.barrier(group=mesh.group)
    lap("meta_count")
    with DrawTap(threefry, "normal") as draws:
        server = BatchedServer(cfg, max_batch=LM_REQUESTS, seed=0,
                               max_len=LM_PROMPT + LM_GEN, mesh=mesh)
    torch.cuda.synchronize()
    lap("build")
    drawn = threefry.normal_launches
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    attn_layers, mamba_layers = kernel_layers(cfg)
    want = {"flash_attention": attn_layers * (1 + LM_GEN),
            "mamba_scan": mamba_layers,
            "all_reduce": moe_layers(cfg) * (1 + LM_GEN)}
    fa.launches = ms.launches = act_sharding.all_reduces = 0
    out, stats = server.generate(prompts, LM_GEN)
    torch.cuda.synchronize()
    lap("generate")
    launched = {"flash_attention": fa.launches, "mamba_scan": ms.launches,
                "all_reduce": act_sharding.all_reduces}
    peak = torch.cuda.max_memory_allocated() - base
    if launched != want:
        bad.append(f"a generate launched {launched}, want {want}")
    ratio = peak / counted
    lo, hi = SHARD_PEAK_RATIO
    if not lo <= ratio <= hi:
        bad.append(f"peak {peak} over the meta count {counted}: {ratio}")
    # the expert leaves' slices, drawn from their offsets (every other
    # leaf's draw is the lm phase's, checked there)
    slices, _ = rng_leaf_checks([c for c in draws.calls if "offset" in c[2]])
    del draws
    mismatched = sum(r["mismatches"] for r in slices)
    moe_specs = sum(sp.ffn == "moe" for sp in cfg.block_pattern)
    if mismatched or len(slices) != len(moe.EXPERT_LEAVES) * moe_specs:
        bad.append(f"the build's expert slices: {len(slices)} leaves, "
                   f"{mismatched} words differ")
    lap("slices")
    ref_file = pathlib.Path(ref_dir) / f"{arch}.pt"
    forced = torch.load(ref_file) if mode == "agree" else None
    with Recorder("mha_flash", attention_keep(LM_ATTN_SK, bidir=False)) \
            as attn, Recorder("selective_scan_fused",
                              lambda x, *a, **kw: "prefill"
                              if x.shape[1] > 1 else None) as scan, \
            RouteTap() as routes:
        if forced is not None:
            routes.routes, routes.impose = list(forced["routes"]), True
        step_ms, profile_row, logits, fed = shard_steps(
            server, prompts, None if forced is None else forced["tokens"],
            lead, keep=mode != "full")
    lap("steps")
    checks = []
    if lead:
        checks = lm_attention_checks(attn.calls) \
            + lm_scan_checks(scan.calls)
        kinds = set(kernel_kinds(cfg))
        want_checks = len(LM_ATTN_SK) * len(kinds) \
            + (2 if mamba_layers else 0)
        if len(checks) != want_checks:
            bad.append(f"recorded {len(checks)} kernel calls, want "
                       f"{want_checks}")
        bad += [f"kernel check: {c}" for c in checks if not c["ok"]]
    del attn, scan
    agreement = None
    if mode == "ref" and lead:
        torch.save({"logits": logits, "tokens": fed,
                    "routes": [r.cpu() for r in routes.routes],
                    "router_min_margin": routes.margin}, ref_file)
    if mode == "agree":
        if routes.routes:
            bad.append(f"{len(routes.routes)} imposed routes left unused")
        if lead:
            agreement = tp_agreement(logits, forced["logits"])
            agreement["router_min_margin"] = forced["router_min_margin"]
            if not agreement["steps_ok"]:
                bad.append(f"tp={mesh.size} against tp=1: "
                           f"{agreement['bad_steps']}")
    del logits, forced
    lap("checks")
    reduce_ms = {"prefill": all_reduce_ms(mesh, LM_REQUESTS * LM_PROMPT,
                                          cfg),
                 "decode": all_reduce_ms(mesh, LM_REQUESTS, cfg)}
    lap("all_reduce_timing")
    weight_bytes = decode_weight_bytes(server.serving, cfg, LM_REQUESTS)
    row = {"arch": arch, "mode": mode, "rank": mesh.rank,
           "layers": cfg.n_layers,
           "published_layers": registry.get_config(arch).n_layers,
           "params": cfg.param_count(), "rank_bytes": server.serving_bytes(),
           "build_s": stage["build"], "build_threefry_launches": drawn,
           "build_slice_mismatches": mismatched,
           "generate_s": stage["generate"], **stats,
           "decode_step_ms_median": step_ms,
           "decode_step_profile": profile_row,
           "decode_weight_bytes": weight_bytes,
           "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "launches": launched, "want_launches": want, "peak_bytes": peak,
           "meta_peak_bytes": counted, "peak_ratio_card_over_meta": ratio,
           "all_reduce": reduce_ms, "kernel_checks": checks,
           "tp_agreement": agreement, "sample": out[0, :8].tolist(),
           "in_vocabulary": bool(((out >= 0)
                                  & (out < cfg.vocab_size)).all()),
           "stage_s": stage, "ok": not bad, "mismatches": bad}
    if not row["in_vocabulary"]:
        row["mismatches"].append("a token outside the vocabulary")
        row["ok"] = False
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return row


def shard_rank(mesh, runs, ref_dir):
    """A rank's runs, one after the other: [(kind, arch, layers, mode)],
    kind "serve" (`shard_serve`), "train" (`shard_train`), "moe"
    (`shard_moe_layer`) or "psum" (`shard_psum`). Returns its rows."""
    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    rows = []
    for kind, arch, layers, mode in runs:
        t0 = time.perf_counter()
        run = {"serve": shard_serve, "train": shard_train,
               "moe": shard_moe_layer, "psum": shard_psum}[kind]
        rows.append(run(mesh, arch, layers, mode, ref_dir))
        print(f"shard: rank {mesh.rank}/{mesh.size} {kind} {arch} {mode} "
              f"{time.perf_counter() - t0:.1f} s "
              f"{rows[-1].get('stage_s', '')}", file=sys.stderr, flush=True)
    return rows


# The train runs of the shard phase: the reference's train step under its
# `shard_map` policy on a (1, SHARD_RANKS) mesh
# (`launch.steps.make_train_step(..., mesh=)`): every rank runs every dense
# layer on the same batch and its E/4 experts of each MoE layer, whose
# leaves it keeps in fp32 with their AdamW moments (`lm.init_params(...,
# mesh=)`, drawn from the seed at their offsets); one all_reduce a MoE
# layer in the forward and again in the remat re-forward, two in the
# backward (the layer's input and gates), one for the global norm.
# SHARD_TRAIN_STEPS steps from prng_key(0) on the pipeline's batches at
# lr 3e-4 (a 3-step cosine: lr 0, then the full rate, then the cosine).
# Four cards, NCCL: the published widths on 1 x 4096 tokens (train_4k's
# sequence) at the deepest cut whose rank's step, counted on `meta` by
# `launch.dryrun.count_train`, stays under ~72 GB: dbrx-132b 3 of 40
# layers (66.2 GB; 4 would be 80.3), jamba-1.5-large its first 3 of 72
# (Mamba layers, with an MLP, MoE, an MLP: 70.2 GB; 2 would be 62.0),
# llama4-scout its first 2 of 48 (two chunked-attention layers with MoE
# and a shared expert, 66.9 GB; 3 would be 85.1); the embedding and head
# alone, with their gradients and moments, are 19.7 GB a rank at dbrx
# and 33.1 GB at llama4. One card: the same code over SHARD_RANKS
# gloo ranks sharing it, at the reduced configs (reduced jamba cut to
# one superblock, 8 layers) on 4 x 256 tokens, each held to a tp = 1 run
# of the same config on the card (no mesh: the global dispatch, every
# expert) bit for bit at every step: the losses, the grad norms and a
# checksum of every leaf (parameters, m, v) each rank holds, its experts'
# slice of each expert leaf against the same slice of the tp = 1 run's.
# At top-2 and top-1 a token's partials from the ranks meet in one
# addition, in either order, and the other ranks add zeros; the capacity
# a rank is the global dispatch's at dp = 1, so the drops are the same
# (measured bit-equal: PERF.md). Every rank, every step: exact
# kernel and all_reduce launches; the losses and grad norms, and a
# checksum of every leaf held whole (parameters, m, v), equal on every
# rank (all_gather); before the first step the grad norm of the whole
# model from each rank's sums of squares of its leaves, gathered, against
# the first step's (SHARD_NORM_RTOL: fp64 against the step's fp32
# sums). Four cards: each rank's peak over its build and steps within
# SHARD_PEAK_RATIO of its `count_train`; rank 0's last step under
# torch.profiler (idle share); the all_reduce of a MoE layer's
# (4096, d_model) at its NVLink bound.
SHARD_TRAIN_FULL = (("dbrx-132b", 3), ("jamba-1.5-large-398b", 3),
                    ("llama4-scout-17b-a16e", 2))
SHARD_TRAIN_CUT = (("dbrx-132b", None), ("llama4-scout-17b-a16e", None),
                   ("jamba-1.5-large-398b", 8))
SHARD_TRAIN_STEPS = 3
SHARD_TRAIN_SHAPE = {"full": (1, 4096), "cut": (4, 256)}
SHARD_TRAIN_LR = 3e-4
SHARD_NORM_RTOL = 1e-5
SHARD_SUM_CHUNK = 1 << 24  # elements a checksum or fp64 sum takes at once
SHARD_COUNTS = "train_counts.json"   # the ranks' `count_train`, by the parent
# Checkpoints across ranks (`checkpoint.Checkpointer(mesh=)`), in every
# train run on one card (tp = 1 and the gloo ranks) and, on four cards, in
# one more dbrx-132b run at its published widths ("full_ckpt"): an
# asynchronous save of (params, AdamW state) after step SHARD_CKPT_STEP
# under build/, the next step with the save in flight, then the
# checkpoint restored into the same tensors (`restore(into=True)`) and
# the last step run again. Held bit for bit: the restored leaves to those
# saved; the re-run step's loss, grad norm and every leaf the rank holds
# (parameters, m, v) to the unbroken step's; rank 0 reads the directory
# with the jax-free `load_reference_checkpoint` (every sha1 checked) and
# holds each rank's slice of every leaf to what that rank saved; on one
# card the tp = 4 manifest to the tp = 1 run's, leaf for leaf (names,
# shapes, dtypes, sha1s); the re-run step's launches exact. Four cards:
# dbrx's depth is the deepest of SHARD_CKPT_DEPTHS whose checkpoint
# (parameters, m and v in fp32: 12 B a parameter) fits half of the free
# space of build/ and would write in SHARD_CKPT_MAX_S at the rate of a
# probe (SHARD_RANKS threads writing SHARD_PROBE_BYTES each to build/,
# fsynced: the disk's rate, below what writes into the page cache see);
# the checkpoint's GB, each rank's snapshot and write seconds and GB/s,
# the step with a save in flight beside the step without, and the
# restore seconds.
SHARD_CKPT_STEP = 2
SHARD_CKPT_ROOT = ROOT / "build" / "chip_smoke_shard_ckpt"
SHARD_CKPT_ARCH = "dbrx-132b"
SHARD_CKPT_DEPTHS = (3, 2, 1)
SHARD_CKPT_MAX_S = 90
SHARD_PROBE_BYTES = 1 << 30
# `compressed_psum` across the four NCCL ranks: one call on a MoE layer's
# (SHARD_MOE_T, d_model) fp32 gradient-sized tensor at dbrx's width, rank
# r's drawn from seed SHARD_PSUM_SEED + r; every rank draws all four and
# holds the call, exactly, to the int32 sum of the four payloads
# requantized against the largest scale, times that scale.
SHARD_PSUM_SEED = 21


def shard_train_cfg(arch, layers, mode):
    """mode "full": the published config cut to `layers`; else the reduced
    config, cut to `layers` (None: as reduced)."""
    if mode == "full":
        return shard_cfg(arch, layers)
    cfg = registry.reduced(registry.get_config(arch))
    return cfg if layers is None else \
        dataclasses.replace(cfg, n_layers=layers)


def leaf_chunks(t):
    flat = t.detach().reshape(-1)
    return flat.split(SHARD_SUM_CHUNK)


def checksums(tree, part):
    """(2, leaves) int64 on the tree's device: the words (bf16 as int16,
    fp32 as int32) of `part(path, leaf)` (None: the leaf left out) summed
    plainly and weighted by their place, leaf after leaf."""
    out = []
    for path, t in flatten(tree):
        t = part(path, t)
        if t is None:
            continue
        words = t.detach().contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32)
        plain = weighted = 0
        for at, chunk in enumerate(leaf_chunks(words)):
            w = chunk.to(torch.int64)
            place = torch.arange(len(chunk), device=w.device) % 1021 + at
            plain = plain + w.sum()
            weighted = weighted + (w * place).sum()
        out.append(torch.stack([torch.as_tensor(plain),
                                torch.as_tensor(weighted)]))
    return torch.stack(out, 1)


def sq_sums(tree):
    """Each leaf's sum of squares in fp64 (sorted-leaf order), (leaves,)."""
    return torch.stack([sum(c.double().square().sum() for c in leaf_chunks(t))
                        for _, t in flatten(tree)])


def held_whole(path) -> bool:
    return path.rsplit("/", 1)[-1] not in act_sharding.EXPERT_LEAVES


def whole_only(path, t):
    """A `checksums` part: the leaves every rank holds whole."""
    return t if held_whole(path) else None


def rank_part(rank, ranks):
    """A `checksums` part: what rank `rank` of `ranks` holds of each leaf,
    its experts of an expert leaf (L, E, ...), every other leaf whole."""
    def part(path, t):
        if held_whole(path):
            return t
        El = t.shape[1] // ranks
        return t[:, rank * El:(rank + 1) * El]
    return part


def gathered(mesh, t):
    """Every rank's `t`, stacked (rank order); `t` alone without a mesh."""
    import torch.distributed as dist
    if mesh is None:
        return t[None]
    got = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(got, t.contiguous(), group=mesh.group)
    return torch.stack(got)


def whole_grad_norm(params, batch, cfg, mesh):
    """The grad norm of the whole model at `params` on `batch`: each
    rank's gradient leaves' fp64 sums of squares, gathered; an expert
    leaf's summed over the ranks, every other leaf's taken from rank 0
    (it is the whole leaf's on every rank). Returns (norm, whether every
    rank's leaves held whole had equal sums)."""
    with act_sharding.across(mesh):
        _, grads = steps_lib.loss_and_grads(params, batch, cfg)
    sums = sq_sums(grads)
    del grads
    every = gathered(mesh, sums)
    paths = [p for p, _ in flatten(params)]
    split = torch.tensor([not held_whole(p) for p in paths],
                         device=every.device)
    total = torch.where(split, every.sum(0), every[0]).sum()
    same = bool((every[:, ~split] == every[0, ~split]).all())
    return float(total.sqrt()), same


def driver_step(step_fn):
    """A `launch.steps` train step in the driver's signature, (params,
    opt, err, batch) -> (params, opt, err, metrics), for `profiled_step`."""
    def run(params, opt, err, batch):
        params, opt, metrics = step_fn(params, opt, batch)
        return params, opt, err, metrics
    return run


def step_counts():
    """The kernel and all_reduce launches since the counts were zeroed."""
    return {**counts_lm(), **bwd_counts(),
            "all_reduce": act_sharding.all_reduces,
            "cotangent_all_reduce": act_sharding.cotangent_all_reduces,
            "stat_all_reduce": act_sharding.stat_all_reduces}


def zero_step_counts():
    torch.cuda.synchronize()
    fa.launches = ms.launches = fa.bwd_launches = ms.bwd_launches = 0
    act_sharding.all_reduces = act_sharding.cotangent_all_reduces = 0
    act_sharding.stat_all_reduces = 0


def held_sums(params, opt, part):
    """`checksums` of `part` of the parameters, m and v, (2, 3 leaves)."""
    return torch.cat([checksums(t, part)
                      for t in (params, opt["m"], opt["v"])], 1)


def file_sums(tree, parts, device):
    """`held_sums` under each of `parts` of a checkpoint read by
    `load_reference_checkpoint` (numpy leaves, bf16 as `|V2` words), a
    leaf at a time on `device`: (len(parts), 2, 3 leaves)."""
    out = [[] for _ in parts]
    for t in (tree["0"], tree["1"]["m"], tree["1"]["v"]):
        for path, a in flatten(t):
            leaf = torch.from_numpy(a.view(np.int16) if a.dtype.kind == "V"
                                    else a).to(device)
            for i, part in enumerate(parts):
                out[i].append(checksums({path: leaf}, part))
            del leaf
    return torch.stack([torch.cat(cols, 1) for cols in out])


def ckpt_arrays(d):
    """A committed step's manifest entries (names, files, shapes, dtypes,
    sha1s)."""
    return json.loads((pathlib.Path(d) / "MANIFEST.json").read_text())[
        "arrays"]


def ckpt_bytes(cfg) -> int:
    """The bytes of a train checkpoint of `cfg` (parameters, m and v, the
    step), counted on `meta`."""
    mom = torch.tensor([], dtype=getattr(torch, cfg.opt_moment_dtype))
    return sum(t.numel() * (t.element_size() + 2 * mom.element_size())
               for _, t in flatten(lm.init_params(None, cfg, device="meta"))
               ) + 4


def shard_train(mesh, arch, layers, mode, ref_dir):
    """One train run on this rank. mode: "ref" (tp = 1 in the parent, no
    mesh, on card 0: writes its losses and norms to ref_dir), "agree"
    (tp = 4 at the reduced configs, rank 0 compares with the ref), "full"
    (tp = 4 on four cards) or "full_ckpt" (the same with the checkpoint
    round trip, SHARD_CKPT_*). Returns this rank's row."""
    full = mode.startswith("full")
    cfg = shard_train_cfg(arch, layers, "full" if full else mode)
    B, S = SHARD_TRAIN_SHAPE["full" if full else "cut"]
    device = mesh.device if mesh is not None else "cuda:0"
    lead = mesh is None or mesh.rank == 0
    ckpt_on = mode != "full"
    ckpt_dir = SHARD_CKPT_ROOT / f"{arch}.{layers}.{mode}"
    bad, stage = [], {}
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        stage[name] = now - clock
        clock = now

    def barrier():
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=mesh.group)
    gc.collect()
    torch.cuda.empty_cache()
    if mesh is None:
        counted = dryrun.count_train(cfg, B, S).peak_live_bytes
    else:       # counted once in the parent: a mesh's ranks are alike
        counted = json.loads((pathlib.Path(ref_dir) / SHARD_COUNTS).read_text(
        ))[f"{arch}.{layers}.{mode}"]
    if lead and ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    threefry.normal_launches = 0
    barrier()
    lap("meta_count")
    params = lm.init_params(prng.prng_key(0), cfg, device=device, mesh=mesh)
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    torch.cuda.synchronize()
    drawn = threefry.normal_launches
    lap("build")
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=0, n_logical_shards=B,
                               shard_range=(0, B))
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(s)["tokens"],
                                          device=device)}
               for s in range(SHARD_TRAIN_STEPS)]
    norm_whole, norms_alike = whole_grad_norm(params, batches[0], cfg, mesh)
    lap("whole_norm")
    step_fn = steps_lib.make_train_step(
        cfg, AdamWConfig(lr=SHARD_TRAIN_LR), SHARD_TRAIN_STEPS, mesh=mesh)
    attn_layers, mamba_layers = kernel_layers(cfg)
    M = moe_layers(cfg) if mesh is not None else 0
    want = {"flash_attention": 2 * attn_layers,
            "mamba_scan": 2 * mamba_layers,
            "flash_attention_bwd": 2 * attn_layers,
            "mamba_scan_bwd": 2 * mamba_layers,
            "all_reduce": 2 * M, "cotangent_all_reduce": 2 * M,
            "stat_all_reduce": int(mesh is not None)}
    mine = rank_part(0, 1)              # every leaf as this rank holds it
    ckpt = Checkpointer(ckpt_dir, mesh=mesh) if ckpt_on else None
    losses, norms, lrs, times, per_step, profile = [], [], [], [], [], None
    alike, held, saved = [], [], None
    for s, batch in enumerate(batches):
        zero_step_counts()
        if mode == "full" and lead and s == len(batches) - 1:
            profile, metrics = profiled_step(driver_step(step_fn),
                                             params, opt, batch)
            params, opt = profile.pop("state")
        else:
            t1 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        per_step.append(step_counts())
        scalars = torch.stack([metrics["loss"].float(),
                               metrics["grad_norm"].float()])
        losses.append(float(scalars[0]))
        norms.append(float(scalars[1]))
        lrs.append(float(metrics["lr"]))
        trees = (params, opt["m"], opt["v"])
        if not full:           # (ranks, 2, leaves): each tp = 4 rank's part
            parts = ([rank_part(r, SHARD_RANKS) for r in range(SHARD_RANKS)]
                     if mesh is None else [rank_part(0, 1)])
            held.append(torch.stack([held_sums(params, opt, part)
                                     for part in parts]).cpu())
        if mesh is not None:
            sums = torch.cat([checksums(t, whole_only) for t in trees], 1)
            every = gathered(mesh, sums)
            scal = gathered(mesh, scalars)
            alike.append({"step": s,
                          "leaves_held_whole": bool((every == sums).all()),
                          "loss_and_norm": bool((scal == scalars).all())})
        if ckpt_on and s + 1 == SHARD_CKPT_STEP:
            saved = held_sums(params, opt, mine)
            t1 = time.perf_counter()
            ckpt.save(s + 1, [params, opt], extra={"data_step": s + 1},
                      blocking=False)
            save_call_s = time.perf_counter() - t1
            barrier()   # the next step timed from the last rank's snapshot
    peak = torch.cuda.max_memory_allocated() - base
    lap("steps")
    ckpt_row = None
    if ckpt_on:
        ckpt_row = shard_ckpt_round_trip(
            mesh, ckpt, ckpt_dir, step_fn, params, opt, batches[-1], saved,
            losses[-1], norms[-1], save_call_s, times, mode, arch, layers,
            bad)
        per_step.append(ckpt_row.pop("counts"))
        if "profile" in ckpt_row:
            profile = ckpt_row.pop("profile")
        params, opt = ckpt_row.pop("state")
        lap("checkpoint")
    if any(p != want for p in per_step):
        bad.append(f"a step launched {per_step}, want {want}")
    if not all(np.isfinite(losses)):
        bad.append(f"a loss is not finite: {losses}")
    if not all(a["leaves_held_whole"] and a["loss_and_norm"]
               for a in alike):
        bad.append(f"the ranks differ: {alike}")
    if not norms_alike:
        bad.append("the ranks' gradients of the leaves held whole differ")
    norm_err = abs(norms[0] - norm_whole) / norm_whole
    if norm_err > SHARD_NORM_RTOL:
        bad.append(f"the first step's grad norm {norms[0]} against the "
                   f"whole model's {norm_whole}: {norm_err}")
    ratio = peak / counted
    lo, hi = SHARD_PEAK_RATIO
    if full and not lo <= ratio <= hi:
        bad.append(f"peak {peak} over the meta count {counted}: {ratio}")
    ref_file = pathlib.Path(ref_dir) / f"{arch}.train.pt"
    agreement = None
    if mode == "ref":
        torch.save({"losses": losses, "norms": norms, "held": held},
                   ref_file)
    elif mode == "agree":
        want_run = torch.load(ref_file)
        agreement = {
            "losses_tp1": want_run["losses"], "norms_tp1": want_run["norms"],
            "loss_rel": [abs(a - b) / abs(b) for a, b in
                         zip(losses, want_run["losses"])],
            "norm_rel": [abs(a - b) / abs(b) for a, b in
                         zip(norms, want_run["norms"])],
            # per step: the leaves (of parameters, m, v) whose checksums
            # differ from the tp = 1 run's part for this rank
            "leaves_unequal": [
                int((mine_[0] != want_[mesh.rank]).any(0).sum())
                for mine_, want_ in zip(held, want_run["held"])],
            "leaves": int(held[0].shape[-1])}
        agreement["bit_equal"] = (losses == want_run["losses"]
                                  and norms == want_run["norms"]
                                  and not any(agreement["leaves_unequal"]))
        if not agreement["bit_equal"]:
            bad.append(f"tp={mesh.size} rank {mesh.rank} against tp=1: "
                       f"{agreement}")
    reduce_ms = None
    if mode == "full":
        reduce_ms = all_reduce_ms(mesh, B * S, cfg)
    lap("checks")
    step_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    row = {"arch": arch, "mode": mode, "rank": 0 if mesh is None
           else mesh.rank, "layers": cfg.n_layers,
           "published_layers": registry.get_config(arch).n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "rank_param_bytes": sum(t.numel() * t.element_size()
                                   for _, t in flatten(params)),
           "batch": B, "seq": S, "lr": lrs, "losses": losses,
           "grad_norms": norms, "grad_norm_whole_model": norm_whole,
           "grad_norm_rel_err": norm_err, "ranks_alike": alike,
           "step_s": times, "step_ms_median": step_s * 1e3,
           "tokens_per_s": B * S / step_s, "profiled_step": profile,
           "launches_per_step": per_step, "want_launches_per_step": want,
           "build_threefry_launches": drawn, "peak_bytes": peak,
           "meta_peak_bytes": counted, "peak_ratio_card_over_meta": ratio,
           "all_reduce": reduce_ms, "tp_agreement": agreement,
           "checkpoint": ckpt_row, "stage_s": stage, "ok": not bad,
           "mismatches": bad}
    del params, opt, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return row


def shard_ckpt_round_trip(mesh, ckpt, ckpt_dir, step_fn, params, opt, batch,
                          saved, loss, norm, save_call_s, times, mode, arch,
                          layers, bad):
    """The checkpoint round trip after a run's last step (see
    SHARD_CKPT_STEP): the save's commit, the restore into the same
    tensors, the last step again, each held bit for bit; rank 0 reads the
    directory with `load_reference_checkpoint` and holds each rank's slice
    of every leaf to what that rank saved; at "agree", the manifest to the
    tp = 1 run's. Returns the row, with the re-run step's launch counts
    ("counts"), its profile on four cards' rank 0 ("profile") and the
    state ("state")."""
    lead = mesh is None or mesh.rank == 0
    ranks = 1 if mesh is None else mesh.size
    device = params["embed"].device
    t0 = time.perf_counter()
    ckpt.wait()
    wait_s = time.perf_counter() - t0
    last = held_sums(params, opt, rank_part(0, 1))
    t0 = time.perf_counter()
    _, step, extra = ckpt.restore([params, opt], into=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored = held_sums(params, opt, rank_part(0, 1))
    if step != SHARD_CKPT_STEP or extra != {"data_step": SHARD_CKPT_STEP}:
        bad.append(f"restored step {step} ({extra}), want "
                   f"{SHARD_CKPT_STEP}")
    if not torch.equal(restored, saved):
        bad.append("the restored leaves differ from those saved: "
                   f"{int((restored != saved).any(0).sum())} leaves")
    zero_step_counts()
    row = {}
    if mode == "full_ckpt" and lead:
        row["profile"], metrics = profiled_step(driver_step(step_fn),
                                                params, opt, batch)
        params, opt = row["profile"].pop("state")
        rerun_s = row["profile"]["wall_ms"] / 1e3
    else:
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        rerun_s = time.perf_counter() - t0
    row["counts"] = step_counts()
    again = (float(metrics["loss"].float()), float(
        metrics["grad_norm"].float()))
    rerun_equal = {"loss_and_norm": again == (loss, norm),
                   "leaves": bool(torch.equal(
                       held_sums(params, opt, rank_part(0, 1)), last))}
    if not all(rerun_equal.values()):
        bad.append(f"the restored step {SHARD_CKPT_STEP + 1} against the "
                   f"unbroken one: {rerun_equal}, {again} vs {(loss, norm)}")
    # rank 0 reads the directory without the Checkpointer
    every = gathered(mesh, saved)
    step_dir = ckpt_dir / f"step_{SHARD_CKPT_STEP:08d}"
    arrays = ckpt_arrays(step_dir)
    reread, manifest_tp1 = None, None
    if lead:
        t0 = time.perf_counter()
        tree = load_reference_checkpoint(step_dir)
        got = file_sums(tree, [rank_part(r, ranks) for r in range(ranks)],
                        device)
        del tree
        reread = {"seconds": time.perf_counter() - t0, "ranks_equal": [
            bool(torch.equal(got[r], every[r])) for r in range(ranks)]}
        if not all(reread["ranks_equal"]):
            bad.append(f"load_reference_checkpoint against the ranks' "
                       f"saved leaves: {reread}")
        if mode == "agree":
            tp1 = ckpt_arrays(SHARD_CKPT_ROOT / f"{arch}.{layers}.ref" /
                              step_dir.name)
            manifest_tp1 = {"leaves": len(tp1), "equal": arrays == tp1,
                            "unequal": [k for k in tp1
                                        if arrays.get(k) != tp1[k]][:8]}
            if not manifest_tp1["equal"]:
                bad.append(f"the tp = {ranks} manifest against tp = 1's: "
                           f"{manifest_tp1}")
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.group)
    if lead and mode == "full_ckpt":
        shutil.rmtree(ckpt_dir)           # tens of GB; the ref's stay
    gb = sum(np.prod(a["shape"], dtype=np.int64) * (
        2 if a["dtype"] == "bfloat16" else np.dtype(a["dtype"]).itemsize)
        for a in arrays.values()) / 1e9
    stats = dict(ckpt.last_save)
    row.update({
        "step": SHARD_CKPT_STEP, "gb": gb, "leaves": len(arrays),
        "rank_gb_written": stats["bytes"] / 1e9,
        "save_call_s": save_call_s, "snapshot_s": stats["snapshot_s"],
        "write_s": stats["write_s"],
        "write_gb_per_s": stats["bytes"] / 1e9 / max(stats["write_s"], 1e-9),
        "hash_s": stats.get("hash_s"), "commit_s": stats["commit_s"],
        "wait_after_last_step_s": wait_s, "restore_s": restore_s,
        "restore_gb_read": ckpt.last_restore["bytes"] / 1e9,
        "step_s_without_save": times[SHARD_CKPT_STEP - 1],
        "step_s_save_in_flight": times[SHARD_CKPT_STEP],
        "rerun_step_s": rerun_s, "rerun_equal": rerun_equal,
        "reread": reread, "manifest_tp1": manifest_tp1,
        "state": (params, opt)})
    return row


# dbrx-132b's MoE layer at full width through the dispatch across ranks,
# forward and backward: T = 4096 tokens of d_model 6144, 16 experts of
# 10752 at top-4, each rank its 4 experts (fp32 leaves, ~10 GB a rank
# with their gradients and the step's buffers), against the one-device
# emulation of the same `shard_map` at a (1, 4) descriptor mesh
# (`moe._dispatch_sharded`, ~38 GB), run first in the parent, on the same
# seeded inputs, gates and experts (each expert drawn alone from its own
# seed, so that a rank draws only its own). Held: y, the gates' and each
# rank's experts' gradients within SHARD_MOE_TOL of their largest |value|
# (the experts' through a strided sample and each expert's sum of
# squares); the input's gradient within SHARD_MOE_TOL too, its distance
# printed: the ranks sum a token's K cotangents before the ranks, the
# emulation (as the reference's transposed program) over the ranks first,
# and in bf16 the two orders round differently at top-4.
SHARD_MOE_ARCH = "dbrx-132b"
SHARD_MOE_T = 4096
SHARD_MOE_SEED = 11
SHARD_MOE_TOL = 1e-2
SHARD_MOE_SAMPLE = (slice(None), slice(None, None, 97), slice(None, None, 89))


def moe_expert(e, name, cfg, device):
    """Expert e's leaf `name` (0.02 x a unit normal, cfg's param dtype),
    from its own seed."""
    D, Fd = cfg.d_model, cfg.moe_d_ff
    shape = (Fd, D) if name == "moe_wd" else (D, Fd)
    g = torch.Generator(device=device).manual_seed(
        SHARD_MOE_SEED + 1 + 3 * e + moe.EXPERT_LEAVES.index(name))
    return (0.02 * torch.randn(shape, generator=g, device=device)
            ).to(cfg.pdtype)


def moe_experts(cfg, lo, hi, device):
    """Experts lo .. hi - 1 of each expert leaf, leaves needing grads."""
    return {n: torch.stack([moe_expert(e, n, cfg, device)
                            for e in range(lo, hi)]).requires_grad_(True)
            for n in moe.EXPERT_LEAVES}


def moe_grads(x, gate, w):
    """The gradients to hold: x's, the gates', and of each expert leaf
    its strided sample and each expert's fp64 sum of squares."""
    out = {"dx": x.grad.float().cpu(), "dgate": gate.grad.float().cpu()}
    for n in moe.EXPERT_LEAVES:
        g = w[n].grad
        out[f"{n}/sample"] = g[SHARD_MOE_SAMPLE].float().cpu()
        out[f"{n}/sq"] = torch.stack([e.double().square().sum()
                                      for e in g]).cpu()
    return out


def shard_moe_emulated(ref_dir):
    """The parent's half, on card 0: the seeded inputs, gates and
    cotangent, written to ref_dir, then the emulation's y and gradients,
    written there."""
    device = "cuda:0"
    cfg = registry.get_config(SHARD_MOE_ARCH)
    E, K, D, cdt = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.cdtype
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(SHARD_MOE_SEED)
    x = torch.randn((SHARD_MOE_T, D), generator=g, device=device).to(cdt)
    router = 0.02 * torch.randn((D, E), generator=g, device=device)
    gate, eidx = moe.route(torch.softmax(x.float() @ router, -1), K)
    cot = torch.randn((SHARD_MOE_T, D), generator=g, device=device).to(cdt)
    inputs = {"x": x, "gate": gate, "eidx": eidx, "cot": cot}
    torch.save({k: v.cpu() for k, v in inputs.items()},
               pathlib.Path(ref_dir) / "moe.inputs.pt")
    x, gate = x.requires_grad_(True), gate.requires_grad_(True)
    w = moe_experts(cfg, 0, E, device)
    pol = act_sharding.ActivationPolicy(
        moe_dispatch="shard_map", tp_size=SHARD_RANKS,
        mesh=Mesh(("data", "model"), (1, SHARD_RANKS)))
    torch.cuda.reset_peak_memory_stats()
    y = moe._dispatch_sharded(x, eidx, gate, w, cfg, pol, act_fn(cfg.act))
    y.backward(cot)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"y": y.detach().float().cpu(), **moe_grads(x, gate, w)}
    torch.save(out, pathlib.Path(ref_dir) / "moe.emulated.pt")
    del x, gate, w, y, out, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return {"peak_gb": peak / 1e9, "seconds": time.perf_counter() - t0}


def shard_moe_layer(mesh, arch, layers, mode, ref_dir):
    """A rank's half (arch SHARD_MOE_ARCH at its published width; layers
    and mode unused): its 4 experts from their seeds, the parent's
    inputs, `moe._dispatch_rank` forward and backward, held to the
    emulation."""
    cfg = registry.get_config(arch)
    El = cfg.moe.n_experts // mesh.size
    j = mesh.tp_rank
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d = pathlib.Path(ref_dir)
    inputs = {k: v.to(mesh.device)
              for k, v in torch.load(d / "moe.inputs.pt").items()}
    x = inputs["x"].requires_grad_(True)
    gate = inputs["gate"].requires_grad_(True)
    w = moe_experts(cfg, j * El, (j + 1) * El, mesh.device)
    torch.cuda.reset_peak_memory_stats()
    act_sharding.all_reduces = act_sharding.cotangent_all_reduces = 0
    y = moe._dispatch_rank(x, inputs["eidx"], gate, w, cfg, mesh,
                           act_fn(cfg.act), decode=False)
    y.backward(inputs["cot"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    reduces = [act_sharding.all_reduces, act_sharding.cotangent_all_reduces]
    got = {"y": y.detach().float().cpu(), **moe_grads(x, gate, w)}
    del x, gate, w, y, inputs
    gc.collect()
    torch.cuda.empty_cache()
    want = torch.load(d / "moe.emulated.pt")
    errs = {}
    for k, g in got.items():
        ref_k = want[k]
        if "/" in k:                       # an expert leaf: this rank's
            ref_k = ref_k[j * El:(j + 1) * El]
        top = float(ref_k.abs().max())
        err = float((g.double() - ref_k.double()).abs().max())
        errs[k] = {"max_abs_err": err, "top": top, "share": err / max(
            top, 1e-30) / SHARD_MOE_TOL, "bit_equal": bool(torch.equal(
                g, ref_k.to(g.dtype)))}
    bad = [f"{k}: {e}" for k, e in errs.items() if e["share"] > 1]
    if reduces != [1, 2]:
        bad.append(f"all_reduces forward, backward {reduces}, want [1, 2]")
    return {"arch": arch, "mode": "moe", "rank": mesh.rank,
            "tokens": SHARD_MOE_T, "d_model": cfg.d_model,
            "experts": cfg.moe.n_experts, "rank_experts": El,
            "top_k": cfg.moe.top_k, "d_ff": cfg.moe_d_ff, "tol": SHARD_MOE_TOL,
            "errors": errs, "peak_gb": peak / 1e9, "all_reduces": reduces,
            "seconds": time.perf_counter() - t0, "ok": not bad,
            "mismatches": bad}


def shard_psum(mesh, arch, layers, mode, ref_dir):
    """A rank's `compressed_psum` call (SHARD_PSUM_SEED; layers unused),
    held to the sum of the requantized payloads; ms a call."""
    import torch.distributed as dist
    cfg = registry.get_config(arch)
    shape = (SHARD_MOE_T, cfg.d_model)
    xs = [3 * torch.randn(shape, generator=torch.Generator(
        mesh.device).manual_seed(SHARD_PSUM_SEED + r), device=mesh.device)
        for r in range(mesh.size)]
    scale = torch.stack([quantize_int8(x)[1] for x in xs]).max()
    want = sum(torch.clamp(torch.round(x / scale), -127, 127).to(
        torch.int8).to(torch.int32) for x in xs).to(torch.float32) * scale
    got = compressed_psum(xs[mesh.rank], group=mesh.group)
    torch.cuda.synchronize()
    row = {"arch": arch, "mode": mode, "rank": mesh.rank,
           "shape": list(shape), "equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()),
           "backend": dist.get_backend(mesh.group)}
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(SHARD_AR_REPS):
        compressed_psum(xs[mesh.rank], group=mesh.group)
    torch.cuda.synchronize()
    row["ms"] = (time.perf_counter() - t0) * 1e3 / SHARD_AR_REPS
    row["mismatches"] = [] if row["equal"] else [f"compressed_psum: {row}"]
    row["ok"] = row["equal"]
    return row


def shard_counts(runs, ref_dir):
    """Each train run's `count_train` on meta for a rank of the
    (1, SHARD_RANKS) mesh, counted once here (every rank's is the same),
    written to ref_dir for the ranks."""
    counted = {}
    for kind, arch, layers, mode in runs:
        if kind == "train":
            full = mode.startswith("full")
            cfg = shard_train_cfg(arch, layers, "full" if full else mode)
            B, S = SHARD_TRAIN_SHAPE["full" if full else "cut"]
            counted[f"{arch}.{layers}.{mode}"] = dryrun.count_train(
                cfg, B, S, mesh=Mesh(("data", "model"), (1, SHARD_RANKS),
                                     rank=0)).peak_live_bytes
    (pathlib.Path(ref_dir) / SHARD_COUNTS).write_text(json.dumps(counted))


def write_probe() -> float:
    """GB/s of SHARD_RANKS threads each writing and fsyncing
    SHARD_PROBE_BYTES of random bytes to build/ at once."""
    block = np.random.default_rng(0).integers(
        0, 256, 1 << 26, dtype=np.uint8).tobytes()
    paths = [SHARD_CKPT_ROOT / f"probe{r}" for r in range(SHARD_RANKS)]

    def write(path):
        with open(path, "wb") as f:
            for _ in range(SHARD_PROBE_BYTES // len(block)):
                f.write(block)
            f.flush()
            os.fsync(f.fileno())
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SHARD_RANKS) as pool:
        list(pool.map(write, paths))
    seconds = time.perf_counter() - t0
    for path in paths:
        path.unlink()
    return SHARD_RANKS * SHARD_PROBE_BYTES / seconds / 1e9


def shard_ckpt_depth():
    """Four cards: dbrx's checkpointed depth (SHARD_CKPT_DEPTHS), with the
    free bytes of build/, the probe's write rate and each depth's
    checkpoint bytes and seconds at that rate."""
    free = shutil.disk_usage(SHARD_CKPT_ROOT).free
    rate = write_probe()
    sizes = {L: ckpt_bytes(shard_cfg(SHARD_CKPT_ARCH, L))
             for L in SHARD_CKPT_DEPTHS}
    fits = [L for L in SHARD_CKPT_DEPTHS if sizes[L] <= free / 2
            and sizes[L] / 1e9 / rate <= SHARD_CKPT_MAX_S]
    return {"free_gb": free / 1e9, "probe_gb_per_s": rate,
            "ckpt_gb": {L: b / 1e9 for L, b in sizes.items()},
            "write_s_at_probe": {L: b / 1e9 / rate for L, b in sizes.items()},
            "layers": fits[0] if fits else SHARD_CKPT_DEPTHS[-1],
            "fits": bool(fits)}


def topology() -> str:
    try:
        return subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def phase_shard():
    """The shard phase (see SHARD_CELLS, SHARD_TRAIN_FULL, SHARD_CKPT_*,
    SHARD_PSUM_SEED and SHARD_MOE_*): the tp = 1 runs (in this process:
    the serving ones in a one-rank group on card 0, the train ones without
    a mesh) and the MoE layer's emulation, the ranks' `meta` counts, then
    the SHARD_RANKS ranks, spawned once (the one-card runs and, on four
    cards, the full ones, the checkpointed dbrx run and compressed_psum).
    A rank that fails fails the phase. Returns the phase's launches,
    summed over ranks."""
    t0 = time.perf_counter()
    gc.collect()            # the earlier phases' blocks, for the ranks
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    four = cards >= SHARD_RANKS
    backend = "nccl" if four else "gloo"
    devices = [f"cuda:{r % cards}" for r in range(SHARD_RANKS)]
    names = [torch.cuda.get_device_name(i) for i in range(cards)]
    not_run = [] if four else [
        f"{kind} {arch} at {layers or registry.get_config(arch).n_layers} "
        f"of {registry.get_config(arch).n_layers} layers over NCCL, one rank "
        f"a card" for kind, cells in (("serve", [(a, f) for a, f, _ in
                                                 SHARD_CELLS]),
                                      ("train", SHARD_TRAIN_FULL))
        for arch, layers in cells]
    if SHARD_CKPT_ROOT.exists():
        shutil.rmtree(SHARD_CKPT_ROOT)
    SHARD_CKPT_ROOT.mkdir(parents=True)
    depth = shard_ckpt_depth() if four else None
    emit({"phase": "shard_cards", "cards": names, "count": cards,
          "ranks": SHARD_RANKS, "backend": backend,
          "rank_devices": devices, "not_run_for_want_of_cards": not_run,
          "topology": topology(),
          "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "free_gb": [torch.cuda.mem_get_info(i)[0] / 1e9
                      for i in range(cards)],
          "checkpoint_depth": depth})
    with tempfile.TemporaryDirectory(prefix="shard-") as ref_dir:
        # tp = 1: a one-rank group in this process, on card 0
        mesh = join_host_mesh(0, 1, ref_dir, backend=backend,
                              device="cuda:0")
        try:
            ref = shard_rank(mesh, [("serve", a, cut, "ref")
                                    for a, _, cut in SHARD_CELLS], ref_dir)
        finally:
            leave(mesh)
        ref += [shard_train(None, a, cut, "ref", ref_dir)
                for a, cut in SHARD_TRAIN_CUT]
        emulated = shard_moe_emulated(ref_dir)
        gc.collect()
        torch.cuda.empty_cache()
        runs = [("serve", a, cut, "agree") for a, _, cut in SHARD_CELLS]
        runs += [("train", a, cut, "agree") for a, cut in SHARD_TRAIN_CUT]
        runs += [("moe", SHARD_MOE_ARCH, None, "moe")]
        if four:
            runs += [("serve", a, full, "full") for a, full, _ in SHARD_CELLS]
            runs += [("train", a, full, "full") for a, full in
                     SHARD_TRAIN_FULL]
            runs += [("train", SHARD_CKPT_ARCH, depth["layers"], "full_ckpt"),
                     ("psum", SHARD_MOE_ARCH, None, "psum")]
        t1 = time.perf_counter()
        shard_counts(runs, ref_dir)
        counts_s = time.perf_counter() - t1
        ranked = spawn_ranks(shard_rank, SHARD_RANKS, (runs, ref_dir),
                             backend=backend, devices=devices,
                             timeout_s=SHARD_TIMEOUT_S * (4 if four else 1))
    shutil.rmtree(SHARD_CKPT_ROOT)
    rows = ref + [r for rank_rows in ranked for r in rank_rows]
    bad = [f"{r['arch']} {r['mode']} rank {r['rank']}: {m}"
           for r in rows for m in r["mismatches"]]
    if four and not depth["fits"]:
        bad.append(f"no checkpoint depth fits build/: {depth}")
    cases, train, moe_rows, psum_rows = [], [], [], []
    for i, (kind, arch, layers, mode) in enumerate(runs):
        mine = [rank_rows[i] for rank_rows in ranked]
        lead = mine[0]
        if kind == "moe":
            moe_rows = mine
            continue
        if kind == "psum":
            psum_rows = [{k: r[k] for k in ("rank", "shape", "equal",
                                            "max_abs_err", "ms", "backend")}
                         for r in mine]
            continue
        if kind == "train":
            train.append({
                k: lead[k] for k in (
                    "arch", "mode", "layers", "published_layers", "d_model",
                    "params", "batch", "seq", "lr", "losses", "grad_norms",
                    "grad_norm_whole_model", "grad_norm_rel_err",
                    "ranks_alike", "step_s", "step_ms_median",
                    "tokens_per_s", "profiled_step", "all_reduce",
                    "tp_agreement", "want_launches_per_step")})
            train[-1].update({
                "ranks": SHARD_RANKS, "backend": backend,
                "rank_param_gb": [r["rank_param_bytes"] / 1e9 for r in mine],
                "peak_gb": [r["peak_bytes"] / 1e9 for r in mine],
                "meta_peak_gb": [r["meta_peak_bytes"] / 1e9 for r in mine],
                "peak_ratio_card_over_meta": [
                    r["peak_ratio_card_over_meta"] for r in mine],
                "launches_per_step_per_rank": [r["launches_per_step"]
                                               for r in mine],
                "leaves_unequal_tp1_per_rank": [
                    r["tp_agreement"]["leaves_unequal"]
                    if r["tp_agreement"] else None for r in mine],
                "checkpoint_per_rank": [r["checkpoint"] for r in mine],
                "rank0_stage_s": lead["stage_s"],
                "ok": all(r["ok"] for r in mine)})
            continue
        cases.append({
            "arch": arch, "mode": mode, "layers": lead["layers"],
            "published_layers": lead["published_layers"],
            "params": lead["params"],
            "ranks": SHARD_RANKS, "backend": backend,
            "build_s": [r["build_s"] for r in mine],
            "generate_s": [r["generate_s"] for r in mine],
            "prefill_s": lead["prefill_s"], "decode_s": lead["decode_s"],
            "tok_per_s": lead["tok_per_s"],
            "decode_step_ms_median": lead["decode_step_ms_median"],
            "decode_step_profile": lead["decode_step_profile"],
            "decode_bound_ms": lead["decode_bound_ms"],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in mine],
            "meta_peak_gb": [r["meta_peak_bytes"] / 1e9 for r in mine],
            "peak_ratio_card_over_meta": [r["peak_ratio_card_over_meta"]
                                          for r in mine],
            "rank_weight_gb": [r["rank_bytes"] / 1e9 for r in mine],
            "expert_slice_mismatches": [r["build_slice_mismatches"]
                                        for r in mine],
            "rank0_stage_s": lead["stage_s"],
            "all_reduce_a_layer": lead["all_reduce"],
            "launches_per_rank": [r["launches"] for r in mine],
            "want_launches_per_rank": lead["want_launches"],
            "kernel_checks": lead["kernel_checks"],
            "tp_agreement": lead["tp_agreement"], "sample": lead["sample"],
            "ok": all(r["ok"] for r in mine)})
    launched = {"flash_attention": 0, "mamba_scan": 0,
                "flash_attention_bwd": 0, "mamba_scan_bwd": 0,
                "threefry_normal": 0}
    for r in rows:
        if r["mode"] in ("moe", "psum"):
            continue
        if "launches_per_step" in r:            # a train run
            for k in ("flash_attention", "mamba_scan",
                      "flash_attention_bwd", "mamba_scan_bwd"):
                launched[k] += sum(p[k] for p in r["launches_per_step"])
        else:
            launched["flash_attention"] += r["launches"]["flash_attention"]
            launched["mamba_scan"] += r["launches"]["mamba_scan"]
        launched["threefry_normal"] += r["build_threefry_launches"]
    emit({"phase": "shard", "cases": cases, "train": train,
          "moe_layer": {"emulated": emulated, "ranks": moe_rows},
          "tp1": [{k: r[k] for k in ("arch", "layers", "build_s",
                                     "generate_s", "decode_step_ms_median",
                                     "peak_ratio_card_over_meta", "sample")}
                  for r in ref if "generate_s" in r],
          "tp1_train": [{k: r[k] for k in ("arch", "layers", "losses",
                                           "grad_norms", "step_ms_median",
                                           "checkpoint")}
                        for r in ref if "losses" in r],
          "compressed_psum": psum_rows, "counts_s": counts_s,
          "launches": launched, "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi(), "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"shard phase: {bad}")
    return launched


# -------------------------------------------------------------- ops phase
# (case, B, Sq, Sk, H, K, hd, causal, window, softcap, dtype, atol, rtol,
#  the one PyTorch call that computes the same function: SDPA with
#  "is_causal" (top-left causal, the same when Sq = Sk), "full" (no mask:
#  one right-aligned query sees every key) or "mask" (an explicit boolean
#  right-aligned causal attn_mask); or "flex", a compiled
#  `flex_attention` with the softcap as its score_mod and the
#  right-aligned sliding-window causal mask as its block mask, timed after
#  its compile)
# A case holds |kernel - plain| <= atol * std(v) + rtol * |plain|
# everywhere (attention_closeness): attention is linear in v, so atol is
# stated for v of unit std, as the ops cases draw it, and a model's call
# scales it by the std of its own v (1.28 at qwen3-8b's layer 0). In
# bf16, rtol covers one rounding of the output (at most 2^-7 |x|) and atol
# the kernel's P rounded to bf16 for the P.V product, which shows in the
# rows with few keys (the first rows of prefill and gemma2); the decode
# cases' rows all see 4093 to 4096 keys. Each ops case's atol is at least
# 1.8 times what the sound kernel needs (PERF.md); a kernel that drops one
# 64-key tile, or one split's partial in the decode merge, fails at decode.
ATTN_BF16 = {"prefill": (4e-3, 1e-2), "decode": (1e-3, 1e-2)}
ATTENTION_CASES = (
    ("qwen3-8b/prefill", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["prefill"], "is_causal"),
    ("qwen3-8b/decode", 8, 1, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["decode"], "full"),
    ("gemma2-27b/local", 1, 8192, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, *ATTN_BF16["prefill"], "flex"),  # SDPA has no softcap
    ("qwen3-8b/fp32", 1, 1024, 1024, 32, 8, 128, True, 0, 0.0,
     torch.float32, 2e-5, 2e-5, "is_causal"),
    ("gemma2-27b/decode-local", 8, 1, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, *ATTN_BF16["decode"], "flex"),  # SDPA has no softcap
    ("qwen3-8b/suffix4", 8, 4, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["decode"], "mask"),  # chunked decode
)
PLAIN_HEADS = 8            # plain attention in slices of 8 heads (memory)

# (case, S, d_inner, d_state): src/repro/configs' widths, batch 1
SCAN_CASES = (
    ("falcon-mamba-7b", 2048, 2 * 4096, 16),        # d_model 4096, expand 2
    ("jamba-1.5-large/mamba", 2048, 2 * 8192, 16),  # d_model 8192, expand 2
)


# The backward kernels in the ops phase, each driven through its ops
# function's autograd Function (the forward kernel, then the backward's
# two launches) with a seeded cotangent: (case, B, S, H, K, hd, window,
# softcap), bf16 and causal: qwen3-8b at the train_lm cell's 4 x 1024
# tokens and gemma2-27b's sliding-window layer at 8192; (case, B, S,
# d_inner, d_state, full): falcon-mamba-7b at the train_lm cell's 2 x 512
# with the cotangent of y alone (as training gives it), and at the ops
# phase's forward case, 1 x 2048, from a given h0 with the cotangents of
# y and h_last ("full").
ATTENTION_BWD_CASES = (
    ("qwen3-8b/train", 4, 1024, 32, 8, 128, 0, 0.0),
    ("gemma2-27b/local", 1, 8192, 32, 16, 128, 4096, 50.0),
)
SCAN_BWD_CASES = (
    ("falcon-mamba-7b/train", 2, 512, 2 * 4096, 16, False),
    ("falcon-mamba-7b", 1, 2048, 2 * 4096, 16, True),
)
# Each gradient against the plain backward (`ref.flash_attention_bwd_ref`,
# `ref.mamba_scan_bwd_ref`) on the same inputs, forward output and
# cotangent: |kernel - plain| <= atol * max|plain| + rtol * |plain|, with
# (atol, rtol) from ATTN_BWD_LIMITS by dtype, or SCAN_BWD_LIMITS. fp32
# (attention and the scan): both compute in fp32 from the same inputs;
# atol covers fp32 sums taken in other orders and expf against torch's
# exp (the worst in the first card runs: 3e-6 of the largest |value| in
# fp32 attention, 1.4e-6 in the scan). bf16 attention: the kernel rounds
# P and dS to bf16 for the tensor cores where the plain backward keeps
# fp32, and both round their results to bf16: rtol is one bf16 ulp
# (2^-7 |x|) and atol 4e-3, 2.8 times the worst the tensor-core kernel
# needed at these shapes and at ragged, windowed, softcapped and Sq != Sk
# ones in its first card run (1.4e-3). A planted fault, the plain backward
# with the cotangent of one query tile (of one head of each GQA group; of
# the first 32 channels; of the middle step) left out, as a kernel that
# skipped it would give, must fall outside the same limits.
ATTN_BWD_LIMITS = {torch.bfloat16: (4e-3, 2.0 ** -7),
                   torch.float32: (1e-5, 0.0)}
SCAN_BWD_LIMITS = (1e-5, 0.0)
BWD_TILE = 32              # the dkv kernel's query tile, the scan's block
# The backward cases' ms with the previous design of the backward kernels
# (PERF.md §6, rows 3b and 4b: attention on mma.sync with a first pass for
# the logsumexp, the scan with a forward walk of its own; NVIDIA H100 80GB
# HBM3, 700 W; not re-run), for each row to stand beside, and the train_lm
# cells' peak GB then at the depths they run now (falcon-mamba-7b's, at 16
# of 64 layers then, 35.632 GB, does not compare with its 32)
BWD_MS_PREVIOUS = {"qwen3-8b/train": 1.89125, "gemma2-27b/local": 18.25726,
               "falcon-mamba-7b/train": 1.44703, "falcon-mamba-7b": 3.01307}
TRAIN_PEAK_GB_PREVIOUS = {"qwen3-8b": 59.557}


def closeness(case, out, want, atol, rtol):
    """How `out` stands to `want`: "ok" if both have one shape, `out` is
    finite and |out - want| <= atol + rtol * |want| everywhere; the largest
    |out - want|, the share of its limit the worst element takes (above 1
    fails) and the least atol this rtol would need."""
    out, want = out.float(), want.float()
    if out.shape != want.shape or not torch.isfinite(out).all():
        return {"case": case, "ok": False, "shape": list(out.shape),
                "want_shape": list(want.shape), "finite": False}
    diff = (out - want).abs()
    share = float((diff / (atol + rtol * want.abs())).max())
    return {"case": case, "ok": share <= 1.0, "atol": atol, "rtol": rtol,
            "max_abs_err": float(diff.max()), "limit_share": share,
            "atol_needed": float((diff - rtol * want.abs()).max())}


def attention_plain(qf, kf, vf, **kw):
    """ref.flash_attention_ref over slices of about PLAIN_HEADS query rows
    (whole GQA groups, and their k/v rows), so that the plain version's
    score matrices stay a few GB (gemma2's 32 heads at S=8192 would take
    8.6 GB a matrix)."""
    G = qf.shape[0] // kf.shape[0]
    step = G * max(PLAIN_HEADS // G, 1)
    out = torch.empty_like(qf)
    for a in range(0, qf.shape[0], step):
        b = min(a + step, qf.shape[0])
        out[a:b] = ref.flash_attention_ref(qf[a:b], kf[a // G:b // G],
                                           vf[a // G:b // G], **kw)
    return out


def counts():
    return {"flash_attention": fa.launches, "mamba_scan": ms.launches,
            "tree_conv": tree_conv.tree_conv_launches,
            "tree_cnn_fused": tree_conv.tree_cnn_fused_launches}


def counts_lm():
    return {"flash_attention": fa.launches, "mamba_scan": ms.launches}


def bwd_counts():
    """The LM kernels' backward launches (two a backward call)."""
    return {"flash_attention_bwd": fa.bwd_launches,
            "mamba_scan_bwd": ms.bwd_launches}


def ops_call(kernel, fn, *args, **kw):
    """One ops call, which must launch `kernel` once and nothing else."""
    before = counts()
    out = fn(*args, **kw)
    after = counts()
    want = {k: v + (k == kernel) for k, v in before.items()}
    if after != want:
        raise AssertionError(f"{fn.__name__} launched {after} from "
                             f"{before}; wanted one {kernel} launch")
    return out


def ops_inputs(ckpt_tree, db, wl, meta):
    """Every ops case's inputs, made on the card from one seed: model
    layout for attention; for the scan falcon-mamba-7b's widths (d_inner
    = 2 * 4096) and jamba-1.5-large's (d_inner = 2 * 8192), both d_state
    16 with Mamba's A = -(1..16) per channel; the serving tick's trees
    and random trees at N=64 for the tree conv."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    attn = []
    for (case, B, Sq, Sk, H, K, hd, causal, window, cap, dtype, atol, rtol,
         sdpa) in ATTENTION_CASES:
        attn.append({"case": case, "dtype": dtype, "atol": atol,
                     "rtol": rtol, "sdpa": sdpa,
                     "args": (randn(B, Sq, H, hd, dtype=dtype),
                              randn(B, Sk, K, hd, dtype=dtype),
                              randn(B, Sk, K, hd, dtype=dtype)),
                     "kw": dict(causal=causal, window=window, softcap=cap)})
    scans = []
    for case, S, di, N in SCAN_CASES:
        scans.append((case, (
            randn(1, S, di), randn(1, S, di).abs() * 0.1,
            -torch.arange(1, N + 1, device="cuda",
                          dtype=torch.float32).repeat(di, 1),
            randn(1, S, N), randn(1, S, N), randn(di))))
    trained = to_cuda(ckpt_tree["actor"]["enc"])
    trees = (to_cuda(serving_batch(db, wl, meta)),
             to_cuda(random_batch(np.random.default_rng(1), N_LANES, 64,
                                  meta.feat_dim)))
    return attn, scans, trained, trees


def phase_ops(ckpt_tree, db, wl, meta):
    """Drive the kernels.ops path at full widths with every count at 0 and
    read the counts. Then hold every result to its kernel's plain version
    on the same inputs, and fail naming each case outside its limit; then
    time each kernel, its plain version and, where one computes the same
    function, PyTorch's own call. Then the backward cases
    (`ops_backward`), each checked, faulted and timed."""
    attn, scans, trained, (tree1, tree2) = ops_inputs(ckpt_tree, db, wl,
                                                      meta)
    fa.launches = ms.launches = fa.bwd_launches = ms.bwd_launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    with torch.inference_mode():
        for a in attn:
            a["out"] = ops_call("flash_attention", ops.mha_flash, *a["args"],
                                **a["kw"])
        scan_outs = [ops_call("mamba_scan", ops.selective_scan_fused, *scan)
                     for _, scan in scans]
        conv1 = ops_call("tree_conv", ops.tree_conv_batch, *tree1,
                         trained["conv1"])
        h1 = ops_call("tree_conv", ops.tree_conv_batch, *tree2,
                      trained["conv1"])
        conv2 = ops_call("tree_conv", ops.tree_conv_batch, h1, *tree2[1:],
                         trained["conv2"])
    torch.cuda.synchronize()
    launched = counts()

    convs = (("aqora/conv1", tree1, trained["conv1"], conv1),
             ("aqora/conv1-N64", tree2, trained["conv1"], h1),
             ("aqora/conv2", (h1, *tree2[1:]), trained["conv2"], conv2))
    with torch.inference_mode():
        held = ([attention_check(a) for a in attn]
                + [scan_check(case, scan, out)
                   for (case, scan), out in zip(scans, scan_outs)]
                + [conv_check(*c) for c in convs])
    bad = [h for h in held if not h["ok"]]
    if bad:
        raise AssertionError(f"kernel and plain version disagree: {bad}")
    with torch.inference_mode():
        rows = ([attention_row(a) for a in attn]
                + [scan_row(case, scan) for case, scan in scans]
                + [conv_row(*c) for c in convs])
    for row, h in zip(rows, held):
        row.update(h)
    lone = [r for r in rows if r.get("device_kernels_per_op", 1) != 1]
    if lone:
        raise AssertionError(f"an ops call ran more than its kernel: {lone}")
    bwd_rows, bwd_launched = ops_backward()
    for k, n in bwd_launched.items():
        launched[k] = launched.get(k, 0) + n
    emit({"phase": "ops", "launches": launched, "cases": rows,
          "backward": bwd_rows, "nvidia_smi": nvidia_smi()})
    bad = [r for r in bwd_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a backward kernel and its plain version "
                             f"disagree: {bad}")
    return launched, rows, bwd_rows


def flat_heads(t):
    """(B, S, H, hd) -> the kernel's (B*H, S, hd)."""
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd)


def model_heads(t, B):
    """The kernel's (B*H, S, hd) -> (B, S, H, hd)."""
    BH, S, hd = t.shape
    return t.reshape(B, BH // B, S, hd).transpose(1, 2)


def attention_bwd_plain(q, k, v, out, g, **kw):
    """ref.flash_attention_bwd_ref over slices of PLAIN_HEADS query rows
    (whole GQA groups) and their k/v rows: fp32 score matrices of a few GB
    at gemma2's S = 8192."""
    G = q.shape[0] // k.shape[0]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for a in range(0, q.shape[0], PLAIN_HEADS):
        b = min(a + PLAIN_HEADS, q.shape[0])
        dq[a:b], dk[a // G:b // G], dv[a // G:b // G] = \
            ref.flash_attention_bwd_ref(q[a:b], k[a // G:b // G],
                                        v[a // G:b // G], out[a:b], g[a:b],
                                        **kw)
    return dq, dk, dv


def grads_rows(case, names, got, want, limits):
    """`closeness` of each gradient to the plain one, limits = (atol as a
    share of its largest |value|, rtol)."""
    atol, rtol = limits
    return [closeness(f"{case}/{n}", g, w,
                      max(atol * float(w.float().abs().max()), 1e-30), rtol)
            for n, g, w in zip(names, got, want) if w is not None]


def launched_by(fn):
    """Run fn; the LM kernels' launches it made (forward and backward)."""
    before = {**counts(), **bwd_counts()}
    out = fn()
    torch.cuda.synchronize()
    after = {**counts(), **bwd_counts()}
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def fault_shares(bads, want, names, limits):
    """Each planted fault's largest share of the limits (above 1:
    refused)."""
    return {name: max(r["limit_share"] for r in grads_rows(name, names, bad,
                                                          want, limits))
            for name, bad in bads.items()}


def attention_bwd_case(case, B, S, H, K, hd, window, cap, gen):
    """One backward case through `mha_flash`'s Function: the gradients
    against the plain backward, two planted faults, a repeat bit-equal,
    then the kernel's time beside the plain backward's, the bound, the
    previous design's and SDPA's backward (without a window or softcap) or a compiled
    flex_attention's (with them)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v = (randn(B, S, n, hd).requires_grad_(True) for n in (H, K, K))
    w = randn(B, S, H, hd)
    kw = dict(causal=True, window=window, softcap=cap)

    def drive():
        out = ops.mha_flash(q, k, v, **kw)
        return out.detach(), torch.autograd.grad(out, (q, k, v), w)
    (out, grads), launched = launched_by(drive)
    qf, kf, vf, of, gf = (flat_heads(t.detach()).contiguous()
                          for t in (q, k, v, out, w))
    got = [flat_heads(g) for g in grads]
    # the logsumexp the Function saved: the forward kernel's again
    of2, lse = fa._forward(qf, kf, vf, **kw, scale=None, return_lse=True)
    if not torch.equal(of2, of):
        raise AssertionError(f"{case}: the forward kernel is not "
                             f"repeatable")
    want = attention_bwd_plain(qf, kf, vf, of, gf, **kw)
    names, limits = ("dq", "dk", "dv"), ATTN_BWD_LIMITS[torch.bfloat16]
    rows = grads_rows(case, names, got, want, limits)
    G = H // K
    first_tile, one_head = gf.clone(), gf.clone()
    first_tile[:, :BWD_TILE] = 0
    one_head.view(-1, G, S, hd)[:, G - 1] = 0
    faults = fault_shares(
        {n: attention_bwd_plain(qf, kf, vf, of, g, **kw)
         for n, g in (("first_q_tile", first_tile),
                      ("one_head_of_each_group", one_head))},
        want, names, limits)
    again = [fa.flash_attention_bwd(qf, kf, vf, of, gf, lse, **kw)
             for _ in range(2)]
    repeat = all(torch.equal(a.contiguous(), b) and torch.equal(b, c)
                 for a, b, c in zip(got, *again))
    ms_kernel = cuda_ms(lambda: fa.flash_attention_bwd(qf, kf, vf, of, gf,
                                                       lse, **kw),
                        launches=3, reps=5, warmup=2)
    by_kernel = median_by_kernel(
        lambda: fa.flash_attention_bwd(qf, kf, vf, of, gf, lse, **kw))
    plain = cuda_ms(lambda: attention_bwd_plain(qf, kf, vf, of, gf, **kw),
                    launches=1, reps=3, warmup=1)
    pairs = work.allowed_pairs(S, S, True, window)
    n_bytes, flops = work.attention_bwd_work(B * H, B * K, S, S, hd,
                                             causal=True, window=window,
                                             itemsize=2)
    row = {"case": case, "entry": "mha_flash backward",
           "kernel": "flash_attention_bwd", "q": [B, S, H, hd],
           "kv": [B, S, K, hd], **kw, "dtype": "torch.bfloat16",
           "launches": launched, "ms": ms_kernel,
           "device_ms_by_kernel": by_kernel or None, "plain_ms": plain,
           **work.bound(n_bytes, flops, BF16_FLOPS),
           # the function's one exp a pair; the kernels take two
           "sfu_ms": sfu_ms(pairs * B * H),
           # the kernels' 7 products (QK^T and dO V^T twice each)
           "kernel_tflop_per_s": 7 * 2 * hd * pairs * B * H / ms_kernel / 1e9,
           "tflop_per_s": flops / ms_kernel / 1e9,
           "ms_previous": BWD_MS_PREVIOUS.get(case),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "worst": max(rows, key=lambda r: r["limit_share"]),
           "planted_limit_share": faults, "repeat_bit_equal": repeat,
           "library_ms": None,
           "library_note": "none: SDPA has no softcap or window"}
    row["kernel_over_bound"] = ms_kernel / row["bound_ms"]
    if window == 0 and cap == 0.0:
        row.update(sdpa_bwd(qf, kf, vf, gf, B, want))
    else:
        row.update(flex_bwd(case, qf, kf, vf, gf, B, want, kw))
    if row["library_ms"] is not None:
        row["kernel_over_library"] = ms_kernel / row["library_ms"]
    if row["ms_previous"] is not None:
        row["previous_over_kernel"] = row["ms_previous"] / ms_kernel
    row["ok"] = (all(r["ok"] for r in rows) and repeat
                 and min(faults.values()) > 1
                 and launched == {"flash_attention": 1,
                                  "flash_attention_bwd": 2})
    return row


def sdpa_bwd(qf, kf, vf, gf, B, want):
    """SDPA's backward as a yardstick (the port never calls it): causal
    (top-left, the same as right-aligned at Sq = Sk), enable_gqa, timed
    as forward plus backward less the forward; its gradients' largest
    difference from the plain backward's."""
    F = torch.nn.functional
    q4, k4, v4 = (t.view(B, -1, t.shape[1], t.shape[2]).detach()
                  .requires_grad_(True) for t in (qf, kf, vf))
    g4 = gf.view(q4.shape)

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (q4, k4, v4), g4)
    note = ("F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
            " forward + backward, less the forward")
    try:
        grads = fwd_bwd()
        diff = max(float((a.reshape(b.shape).float() - b.float()).abs()
                         .max()) for a, b in zip(grads, want))
        both = cuda_ms(fwd_bwd, launches=3, warmup=2)
        alone = cuda_ms(fwd, launches=3, warmup=2)
        names = sorted({n[:80] for n, _ in device_kernels(fwd_bwd)})
    except Exception as e:           # the cell says why, in place of a time
        return {"library_ms": None, "library_note": f"{note} could not run: "
                f"{type(e).__name__}: {str(e)[:300]}"}
    return {"library_ms": both - alone, "library_fwd_bwd_ms": both,
            "library_fwd_ms": alone, "library_max_abs_diff": diff,
            "library_note": note, "library_backend": sdpa_backend(names),
            "library_kernels": names}


def sdpa_backend(names):
    """The SDPA backend a profiled call ran, from its device kernels'
    names: cuDNN, flash, memory-efficient, or the math path (none of
    those: plain GEMMs and softmax)."""
    low = [n.lower() for n in names]
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("efficient", "mem_eff", "fmha"))):
        if any(m in n for n in low for m in marks):
            return backend
    return "math"


def flex_bwd(case, qf, kf, vf, gf, B, want, kw):
    """A compiled `flex_attention`'s backward as a yardstick for a
    windowed, softcapped case (the port never calls it): the softcap as
    score_mod, the sliding-window causal block mask, enable_gqa; timed as
    forward plus backward less the forward, after its compile. Its
    gradients are held to the plain backward at the case's own limits
    first: outside them, or if it cannot run here, library_ms is None and
    the note says why."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S, hd = qf.shape[1], qf.shape[2]
    cap, window = kw["softcap"], kw["window"]
    q4, k4, v4 = (t.view(B, -1, S, hd).detach().requires_grad_(True)
                  for t in (qf, kf, vf))
    g4 = gf.view(q4.shape)
    score_mod, mask_mod = flex_mods(cap, window, S, S)
    note = (f"flex_attention(score_mod=softcap {cap}, block_mask=causal "
            f"window {window}, enable_gqa=True), torch.compile'd, forward "
            f"+ backward less the forward")
    threads = inductor_config.compile_threads
    inductor_config.compile_threads = 1          # no pool of compile workers
    try:
        mask = create_block_mask(mask_mod, None, None, S, S, device="cuda")
        compiled = torch.compile(flex_attention)

        def fwd():
            return compiled(q4, k4, v4, score_mod=score_mod, block_mask=mask,
                            enable_gqa=True)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), (q4, k4, v4), g4)
        t0 = time.perf_counter()
        grads = [g.reshape(w.shape) for g, w in zip(fwd_bwd(), want)]
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        held = grads_rows(f"{case}/flex", ("dq", "dk", "dv"), grads, want,
                          ATTN_BWD_LIMITS[torch.bfloat16])
        row = {"library_note": note, "library_compile_s": compile_s,
               "library_vs_plain": held,
               "library_max_abs_diff": max(r["max_abs_err"] for r in held)}
        if not all(r["ok"] for r in held):
            return {**row, "library_ms": None,
                    "library_note": f"{note} is outside the case's limits "
                                    f"against the plain backward"}
        both = cuda_ms(fwd_bwd, launches=3, reps=3, warmup=2)
        alone = cuda_ms(fwd, launches=3, reps=3, warmup=2)
        return {**row, "library_ms": both - alone,
                "library_fwd_bwd_ms": both, "library_fwd_ms": alone}
    except Exception as e:           # the cell says why, in place of a time
        return {"library_ms": None,
                "library_note": f"{note} could not run: "
                                f"{type(e).__name__}: {str(e)[:300]}"}
    finally:
        inductor_config.compile_threads = threads


def scan_bwd_case(case, B, S, di, N, full, gen):
    """One backward case through `selective_scan_fused`'s Function: the
    gradients against the plain backward, two planted faults, a repeat
    bit-equal, then the kernels' times beside the plain backward's and
    the bound."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dt = randn(B, S, di), randn(B, S, di).abs() * 0.1
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(
        di, 1)
    Bs, Cs, D = randn(B, S, N), randn(B, S, N), randn(di)
    h0 = randn(B, di, N) if full else None
    ins = [t.requires_grad_(True) for t in (x, dt, A, Bs, Cs, D)
           + ((h0,) if full else ())]
    gy = randn(B, S, di)
    gh = randn(B, di, N) if full else None

    def drive():
        y, h = ops.selective_scan_fused(*ins[:6], h0=h0)
        outs = (y, h) if full else (y,)
        return torch.autograd.grad(outs, ins, (gy, gh) if full else (gy,))
    grads, launched = launched_by(drive)
    plain = [t.detach() for t in ins] + ([] if full else [None])
    want = ref.mamba_scan_bwd_ref(*plain, gy, gh)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    rows = grads_rows(case, names, grads, want, SCAN_BWD_LIMITS)
    first_block, one_step = gy.clone(), gy.clone()
    first_block[..., :BWD_TILE] = 0
    one_step[:, S // 2] = 0
    gh_block = None
    if gh is not None:
        gh_block = gh.clone()
        gh_block[:, :BWD_TILE] = 0
    faults = fault_shares(
        {"first_block": ref.mamba_scan_bwd_ref(*plain, first_block, gh_block),
         "one_step": ref.mamba_scan_bwd_ref(*plain, one_step, gh)},
        want, names, SCAN_BWD_LIMITS)
    # the chunk states the Function saved: the forward kernel's again
    states = ms._forward(*plain, with_states=True)[2]
    again = [ms.mamba_scan_bwd(*plain, gy, gh, states) for _ in range(2)]
    repeat = all(torch.equal(a, b) and torch.equal(b, c)
                 for a, b, c in zip(grads, *again))
    ms_kernel = cuda_ms(lambda: ms.mamba_scan_bwd(*plain, gy, gh, states),
                        launches=3, reps=5, warmup=2)
    by_kernel = median_by_kernel(
        lambda: ms.mamba_scan_bwd(*plain, gy, gh, states))
    plain_ms = cuda_ms(lambda: ref.mamba_scan_bwd_ref(*plain, gy, gh),
                       launches=1, reps=3, warmup=1)
    n_bytes, flops = work.scan_bwd_work(B, S, di, N, skip=True, h0=full,
                                        gy=True, gh=full)
    row = {"case": case, "entry": "selective_scan_fused backward",
           "kernel": "mamba_scan_bwd", "x": [B, S, di], "A": [di, N],
           "h0": full, "gh": full, "dtype": "torch.float32",
           "launches": launched, "ms": ms_kernel,
           "device_ms_by_kernel": by_kernel or None, "plain_ms": plain_ms,
           **work.bound(n_bytes, flops, FP32_FLOPS),
           # the function's one exp a (b, t, d, n), as the kernel takes
           "sfu_ms": sfu_ms(B * S * di * N),
           "tb_per_s": n_bytes / ms_kernel / 1e9,
           "ms_previous": BWD_MS_PREVIOUS.get(case),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "worst": max(rows, key=lambda r: r["limit_share"]),
           "planted_limit_share": faults, "repeat_bit_equal": repeat,
           "library_ms": None, "library_note": "none"}
    row["kernel_over_bound"] = ms_kernel / row["bound_ms"]
    if row["ms_previous"] is not None:
        row["previous_over_kernel"] = row["ms_previous"] / ms_kernel
    row["ok"] = (all(r["ok"] for r in rows) and repeat
                 and min(faults.values()) > 1
                 and launched == {"mamba_scan": 1, "mamba_scan_bwd": 2})
    return row


def ops_backward():
    """The ops phase's backward cases (ATTENTION_BWD_CASES,
    SCAN_BWD_CASES); their launches through the Functions."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [attention_bwd_case(*c, gen) for c in ATTENTION_BWD_CASES]
    rows += [scan_bwd_case(*c, gen) for c in SCAN_BWD_CASES]
    launched = {}
    for r in rows:
        for k, n in r["launches"].items():
            launched[k] = launched.get(k, 0) + n
    return rows, launched


def flat_attention(a):
    """The case's q, k, v and kernel output in the kernel's own layout,
    (B*H, Sq, hd) and (B*K, Sk, hd)."""
    q, k, v = a["args"]
    B, Sq, H, hd = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
                  for t in (q, k, v))
    return qf, kf, vf, a["out"].transpose(1, 2).reshape(B * H, Sq, hd)


def attention_closeness(case, qf, kf, vf, out, kw, atol, rtol):
    """`closeness` of a kernel's output to the plain version's, with atol
    (stated for v of unit std) times the std of v."""
    v_std = float(vf.float().std())
    row = closeness(case, out, attention_plain(qf, kf, vf, **kw),
                    atol * v_std, rtol)
    row["v_std"] = v_std
    return row


def attention_check(a):
    return attention_closeness(a["case"], *flat_attention(a), a["kw"],
                               a["atol"], a["rtol"])


def attention_row(a):
    qf, kf, vf, out = flat_attention(a)
    B, Sq, H, hd = a["args"][0].shape
    dst = torch.empty_like(qf)
    ms_kernel = cuda_ms(lambda: fa._launch(qf, kf, vf, dst, scale=None,
                                           **a["kw"]),
                        launches=5, warmup=3)
    # the training forward: each row's logsumexp written too (bf16 paths)
    lse = (torch.empty(qf.shape[:2], dtype=torch.float32, device="cuda")
           if a["dtype"] == torch.bfloat16 else None)
    ms_lse = None if lse is None else cuda_ms(
        lambda: fa._launch(qf, kf, vf, dst, lse, scale=None, **a["kw"]),
        launches=5, warmup=3)
    plain = cuda_ms(lambda: attention_plain(qf, kf, vf, **a["kw"]),
                    launches=1, reps=3, warmup=1)
    Sk = kf.shape[1]
    pairs = work.allowed_pairs(Sq, Sk, a["kw"]["causal"], a["kw"]["window"])
    n_bytes, flops = work.attention_work(
        B * H, kf.shape[0], Sq, Sk, hd, causal=a["kw"]["causal"],
        window=a["kw"]["window"], itemsize=qf.element_size())
    peak = BF16_FLOPS if a["dtype"] == torch.bfloat16 else FP32_FLOPS
    row = {"case": a["case"], "entry": "mha_flash",
           "kernel": "flash_attention",
           "path": fa.kernel_path(B * H, kf.shape[0], Sq, Sk, hd, qf.dtype),
           "q": list(a["args"][0].shape), "kv": list(a["args"][1].shape),
           **a["kw"], "dtype": str(a["dtype"]),
           "allowed_pairs_per_head": pairs, "ms": ms_kernel,
           "ms_with_lse": ms_lse,
           "plain_ms": plain, **work.bound(n_bytes, flops, peak),
           "sfu_ms": sfu_ms(pairs * B * H),
           "tflop_per_s": flops / ms_kernel / 1e9,
           "tb_per_s": n_bytes / ms_kernel / 1e9,
           "library_ms": None, "library_note": "none: SDPA has no softcap"}
    row["kernel_over_bound"] = ms_kernel / row["bound_ms"]
    how = a["sdpa"]
    if how == "flex":
        row.update(flex_library(a, qf, kf, vf, out))
        if row["library_ms"] is not None:
            row["kernel_over_library"] = ms_kernel / row["library_ms"]
    elif how is not None:
        q4, k4, v4 = (t.view(B, -1, t.shape[1], hd) for t in (qf, kf, vf))
        kw = {"is_causal": how == "is_causal"}
        if how == "mask":                     # right-aligned causal
            qpos = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
            kw = {"attn_mask": torch.arange(Sk, device="cuda")[None] <= qpos}

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True, **kw)
        row["library_ms"] = cuda_ms(sdpa, launches=5, warmup=3)
        row["kernel_over_library"] = ms_kernel / row["library_ms"]
        row["library_max_abs_diff"] = float(
            (sdpa().reshape(B * H, Sq, hd).float() - out.float()).abs().max())
        row["library_note"] = ("F.scaled_dot_product_attention("
                               + ("attn_mask=<right-aligned causal>"
                                  if how == "mask" else
                                  f"is_causal={how == 'is_causal'}")
                               + ", enable_gqa=True)")
    return row


def flex_mods(cap, window, Sq, Sk):
    """flex_attention's score_mod (the softcap) and mask_mod (causal,
    right-aligned, the sliding window) for a gemma2 case."""
    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        qpos = q_idx + (Sk - Sq)
        keep = kv_idx <= qpos
        if window > 0:
            keep = keep & (kv_idx > qpos - window)
        return keep
    return score_mod, mask_mod


def flex_library(a, qf, kf, vf, out):
    """The time of one compiled `flex_attention` call on case `a`'s
    inputs (softcap as score_mod, the sliding-window causal block mask,
    enable_gqa), after its compile. Its output is held to the plain
    version at the case's own limits first: if it falls outside them, or
    cannot run here, library_ms is None and the note says why."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    kw = a["kw"]
    B, Sq, _, hd = a["args"][0].shape
    Sk, cap, window = kf.shape[1], kw["softcap"], kw["window"]
    q4, k4, v4 = (t.view(B, -1, t.shape[1], hd) for t in (qf, kf, vf))
    score_mod, mask_mod = flex_mods(cap, window, Sq, Sk)
    note = (f"flex_attention(score_mod=softcap {cap}, block_mask=causal "
            f"window {window}, enable_gqa=True), torch.compile'd")
    threads = inductor_config.compile_threads
    inductor_config.compile_threads = 1          # no pool of compile workers
    try:
        mask = create_block_mask(mask_mod, None, None, Sq, Sk, device="cuda")
        compiled = torch.compile(flex_attention)

        def call():
            return compiled(q4, k4, v4, score_mod=score_mod,
                            block_mask=mask, enable_gqa=True)
        t0 = time.perf_counter()
        got = call().reshape(-1, Sq, hd)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        held = attention_closeness(a["case"], qf, kf, vf, got, kw,
                                   a["atol"], a["rtol"])
        row = {"library_note": note, "library_compile_s": compile_s,
               "library_vs_plain": held,
               "library_max_abs_diff": float(
                   (got.float() - out.float()).abs().max())}
        if not held["ok"]:
            return {**row, "library_ms": None,
                    "library_note": f"{note} is outside the case's limits "
                                    f"against the plain version: {held}"}
        return {**row, "library_ms": cuda_ms(call, launches=5, warmup=3)}
    except Exception as e:           # the cell says why, in place of a time
        return {"library_ms": None,
                "library_note": f"{note} could not run: "
                                f"{type(e).__name__}: {str(e)[:300]}"}
    finally:
        inductor_config.compile_threads = threads


def scan_check(case, scan, out):
    """y and h_last of one selective_scan_fused call against the plain
    version; the row is y's, failing if either is outside the limit."""
    x, dt, A, Bs, Cs, D = scan
    y_want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs)
    row = closeness(case, out[0], y_want + x * D, 1e-4, 1e-4)
    h = closeness(case + "/h_last", out[1], h_want, 1e-4, 1e-4)
    row["h_last"] = h
    row["ok"] = row["ok"] and h["ok"]
    return row


def device_kernels(fn, calls: int = 1, sessions: int = 3):
    """(name, device ms) of each device kernel that `calls` calls of `fn`
    run, by torch.profiler. A session that comes back with no device
    event at all lost them (seen on an H100 at the ops phase's scan op,
    in one run of this script): it is taken again, up to
    `sessions` times, and an empty list means not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            return kernels
    return []


def median_by_kernel(fn, calls: int = 5) -> dict:
    """Median device ms of each kernel `fn` launches, by name, over
    `calls` calls under torch.profiler (a median per kernel, so that a
    session that lost some of its events still reads a call's time)."""
    times = {}
    for name, t in device_kernels(fn, calls):
        times.setdefault(name[:60], []).append(t)
    return {k: float(np.median(v)) for k, v in times.items()}


def device_ms(fn, calls: int = 20) -> float:
    """Median device time of the one kernel `fn` launches, by
    torch.profiler: the kernel alone, without the gaps between launches
    that CUDA events over back-to-back calls include."""
    times = [t for _, t in device_kernels(fn, calls)]
    return float(np.median(times)) if times else None


def scan_row(case, scan):
    """The scan kernel's time as selective_scan_fused launches it (with
    the skip term), the whole op's, and their floors."""
    x, dt, A, Bs, Cs, D = scan
    y = torch.empty_like(x)
    h_last = torch.empty((x.shape[0], x.shape[2], A.shape[1]),
                         device=x.device)
    ms_kernel = cuda_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, h_last, D),
                        launches=5, warmup=3)
    # the training forward: the chunk states written too
    states = torch.empty((x.shape[0], -(-x.shape[1] // ms.CHUNK), x.shape[2],
                          A.shape[1]), device=x.device)
    ms_states = cuda_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, h_last, D,
                                           None, states),
                        launches=5, warmup=3)
    dev_ms = device_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, h_last, D),
                       calls=5)
    op_ms = cuda_ms(lambda: ops.selective_scan_fused(*scan), launches=5,
                    warmup=3)
    kernels = [k for k, _ in device_kernels(
        lambda: ops.selective_scan_fused(*scan))]
    plain = cuda_ms(lambda: ref.mamba_scan_ref(x, dt, A, Bs, Cs), launches=1,
                    reps=3, warmup=1)
    B, S, di = x.shape
    N = A.shape[1]
    n_bytes, flops = work.scan_work(B, S, di, N)
    return {"case": case, "entry": "selective_scan_fused",
            "kernel": "mamba_scan", "x": list(x.shape), "A": list(A.shape),
            "dtype": "torch.float32", "ms": ms_kernel, "device_ms": dev_ms,
            "ms_with_states": ms_states, "op_ms": op_ms,
            "device_kernels_per_op": len(kernels),
            "device_kernel_names": sorted(set(k[:60] for k in kernels)),
            "plain_ms": plain, **work.bound(n_bytes, flops, FP32_FLOPS),
            "sfu_ms": sfu_ms(B * S * di * N),
            "tb_per_s": n_bytes / ms_kernel / 1e9, "library_ms": None,
            "library_note": "none"}


def conv_check(case, tree, p, out):
    return closeness(case, out, ref.tree_conv_batch_ref(
        *tree, *(p[w] for w in tree_conv.WEIGHTS)), 1e-5, 1e-5)


def conv_row(case, tree, p, out):
    feat, left, right, mask = tree
    weights = tuple(p[w] for w in tree_conv.WEIGHTS)
    B, N, Fd = feat.shape
    H = p["wr"].shape[1]
    # raw launches on prepared arguments: at a few microseconds a call the
    # wrapper's Python would be what the events time
    fn = tree_conv._conv_library()
    dst = torch.empty_like(out)
    args = (*(t.data_ptr() for t in (*tree, *weights, dst)),
            B, N, Fd, H, torch.cuda.current_stream().cuda_stream)
    ms_kernel = cuda_ms(lambda: fn(*args), launches=200)
    dev_ms = device_ms(lambda: fn(*args))
    plain = cuda_ms(lambda: ref.tree_conv_batch_ref(*tree, *weights),
                    launches=20)
    n_bytes, flops = work.tree_conv_work(B, N, Fd, H, float(mask.sum()))
    return {"case": case, "entry": "tree_conv_batch", "kernel": "tree_conv",
            "shape": [B, N, Fd, H], "dtype": "torch.float32",
            "ms": ms_kernel, "device_ms": dev_ms, "plain_ms": plain,
            **work.bound(n_bytes, flops, FP32_FLOPS), "sfu_ms": 0.0,
            "library_ms": None, "library_note": "none"}


# the phases `--only` runs alone (after the device and build phases)
ALONE = {"layout": phase_layout, "lm": phase_lm, "train_lm": phase_train_lm,
         "shard": phase_shard}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one serve on the card")
    ap.add_argument("--only", choices=list(ALONE), action="append",
                    help="run the device and build phases and this phase "
                         "(repeatable) alone, with no summary or result "
                         "line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as the reference
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, fn, *a):
        """Run one phase, print and keep its seconds."""
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", file=sys.stderr,
              flush=True)
        return out
    smi = timed("device", phase_device)
    timed("build", phase_build)
    if args.only:
        for phase in args.only:
            timed(phase, ALONE[phase])
        emit({"phase_seconds": seconds, "script_s":
              time.perf_counter() - start, "nvidia_smi": smi})
        return 0
    db, wl, meta = deployment()
    tree = load_reference_checkpoint(CKPT)
    worst, timing, bwd_worst, bwd_timing = timed(
        "kernels", phase_kernels, db, wl, meta, tree)
    launches = timed("serve", phase_serve, db, wl, meta,
                     params_from_numpy(tree))
    train_launches, trained, trajs = timed("train", phase_train, db, wl,
                                           meta, tree)
    learn_launches, state, replay, ref_replay = timed(
        "learn", phase_learn, db, wl, meta, tree)
    qos_launches = timed("qos", phase_qos, db, wl, meta, state, replay,
                         ref_replay)
    control_launches = timed("control", phase_control, wl, meta, state)
    gen_launches = timed("gen", phase_gen)
    ablate_launches, ablate_profiled = timed("ablate", phase_ablate)
    if args.profile:
        timed("profile", phase_profile, db, wl, meta,
              params_from_numpy(tree))
    ops_launches, ops_rows, bwd_rows = timed("ops", phase_ops, tree, db, wl,
                                             meta)
    timed("late_profiles", phase_late_profiles, bwd_timing, trained, trajs,
          ablate_profiled)
    rng_launches, rng_rows = timed("rng", phase_rng)
    lm_launches = timed("lm", phase_lm)
    threefry.normal_launches = 0          # the builds of the next phases
    train_lm_launches = timed("train_lm", phase_train_lm)
    train_lm_launches["threefry_normal"] = threefry.normal_launches
    threefry.normal_launches = 0
    layout_launches = timed("layout", phase_layout)
    layout_launches["threefry_normal"] = threefry.normal_launches
    shard_launches = timed("shard", phase_shard)
    emit({"phase_seconds": seconds, "script_s": time.perf_counter() - start,
          "nvidia_smi": smi})
    summary = [{
        "name": "tree_cnn_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused.cu",
        "replaces": "src/repro/kernels/tree_conv.py:224",
        "launches": launches + learn_launches["tree_cnn_fused"]
        + qos_launches["tree_cnn_fused"]
        + control_launches["tree_cnn_fused"]
        + gen_launches["tree_cnn_fused"]
        + ablate_launches["tree_cnn_fused"], "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "case": "step18/serving"}, {
        "name": "tree_cnn_fused_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused_bwd.cu",
        "replaces": "src/repro/kernels/tree_conv.py:202",
        "launches": train_launches["tree_cnn_fused_bwd"]
        + learn_launches["tree_cnn_fused_bwd"]
        + qos_launches["tree_cnn_fused_bwd"]
        + control_launches["tree_cnn_fused_bwd"]
        + ablate_launches["tree_cnn_fused_bwd"],
        "max_abs_err": bwd_worst,
        **{k: bwd_timing["step18/ppo-actor/B24/N48"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "case": "step18/ppo-actor/B24/N48"}]
    for name, replaces, case in (
            ("tree_conv", "src/repro/kernels/tree_conv.py:56", "aqora/conv2"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:79",
             "qwen3-8b/prefill"),
            ("mamba_scan", "src/repro/kernels/mamba_scan.py:55",
             "falcon-mamba-7b")):
        mine = [r for r in ops_rows if r["kernel"] == name]
        row = next(r for r in mine if r["case"] == case)
        phases = {"ops": ops_launches, "lm": lm_launches,
                  "train_lm": train_lm_launches, "layout": layout_launches,
                  "shard": shard_launches}
        by_kernel_phase = {ph: n.get(name, 0) for ph, n in phases.items()
                           if n.get(name, 0)}
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(by_kernel_phase.values()),
            "launches_by_phase": by_kernel_phase,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}, "case": case})
    for name, fwd, case in (
            ("flash_attention_bwd", "flash_attention", "qwen3-8b/train"),
            ("mamba_scan_bwd", "mamba_scan", "falcon-mamba-7b/train")):
        mine = [r for r in bwd_rows if r["kernel"] == name]
        row = next(r for r in mine if r["case"] == case)
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": next(r["replaces"] for r in summary
                             if r["name"] == fwd),
            "replaces_note": "the backward of that kernel's function: the "
                             "reference differentiates its jnp oracle "
                             "(src/repro/kernels/ref.py) with autodiff",
            "launches": sum(ph.get(name, 0) for ph in (
                ops_launches, train_lm_launches, layout_launches,
                shard_launches)),
            "launches_by_phase": {
                ph: n[name] for ph, n in (
                    ("ops", ops_launches), ("train_lm", train_lm_launches),
                    ("layout", layout_launches), ("shard", shard_launches))
                if n.get(name, 0)},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}, "case": case})
    by_phase = {"rng": rng_launches["threefry_normal"],
                "lm": lm_launches["threefry_normal"],
                "train_lm": train_lm_launches["threefry_normal"],
                "layout": layout_launches["threefry_normal"],
                "shard": shard_launches["threefry_normal"]}
    normal_row, gumbel_row = rng_rows
    summary += [{**normal_row, "launches": sum(by_phase.values()),
                 "launches_by_phase": by_phase},
                {**gumbel_row, "launches": lm_launches["threefry_gumbel"],
                 "launches_by_phase": {
                     "lm": lm_launches["threefry_gumbel"]}}]
    if any(r["launches"] == 0 for r in summary):
        raise AssertionError(f"a kernel of the path never launched: {summary}")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
