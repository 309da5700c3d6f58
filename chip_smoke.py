#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out FILE] [--checkpoint F --vocab F --merges F]
                          [--gate-checkpoint F --gate-vocab F]

Needs one NVIDIA GPU and this checkout beside the script (phases 8, 11,
11b, 12 and 13 read configs/cluster.toml; phase 14 starts this script
again as its two tp ranks, which run phases 15, 16 and 17 too).

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (`nvidia-smi` name and power limit) and the torch build;
2. build every kernel of the port from this checkout's sources;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the tutoring path gives it (batch 1-8 x windows 33, 320, 384,
   GPT-2's full 1024, GQA, rows padded to their last slot, a window of a
   larger cache, q strided as the model passes it), with the launch plan
   (`n_split`), kernel, eager-call, plain-version and library-call times
   beside the least time the card could take;
3b. the paged path's kernels the same way: decode attention with per-row
   lengths over a float and an int8 cache (8 and 16 slots, widths 160 and
   384, lengths spread over [1, width], splits left empty) and, over an
   int8 cache, the bucketed engine's decode step as phase 18 (d) runs it
   (8 rows, the whole 192-slot cache, the model's bias); the paged
   step's append kernel (`decode_attention_append`: the new K/V row
   quantized and written, then attention) at 8 and 16 slots, widths 160,
   384 and 1,024 (two splits), int8 and bf16 caches, float32, GQA (G = 4)
   and two rows split four ways, each with a dead slot at the width,
   holding the output within tolerance and the written cache (k, v, ks,
   vs) `torch.equal` to its plain version's, timed beside the kernel it
   replaced alone, the torch sequence it replaced in one CUDA graph, the
   plain version and SDPA, its bound counting the append's bytes; and the int8
   weight-only matmul (`ops/sweep_int8.py`) at GPT-2 small's five products
   for M = 1, 16, 32 (the fused admission chunk), 256 in bf16 (tensor
   cores) and float32 (CUDA cores), and the four dense products at the
   relevance gate's M = 128 and 1,024 in bf16,
   timed over more than 100 MB of distinct weight copies so the L2 cannot
   serve them, plus the 49 products of one decode model call, the 48 dense
   products of one admission chunk (M = 32) and the 48 of one int8 gate
   forward at M = 128 and 1,024 (bf16 x from 17 rows runs the wgmma route,
   `ops/csrc/int8_matmul_wgmma.cu`, each such case also held against the
   plain version and timed on the mma.sync route it replaced there,
   `int8_matmul_replaced`, and the wgmma route called twice bit-equal);
   GPT-2 medium's five
   products at M = 16 (K = 1,024) and the append kernel at its 16 heads
   and gpt2-xl's 25; and the expert layer's product
   (`int8_matmul_experts`: gpt2-moe's wi 768 -> 3,072 and wo 3,072 -> 768
   for all 8 experts in one launch) at C = 5, 10, 80 and 640 rows an
   expert (decode at 16 slots, a 32-token admission chunk, a 256-token
   prefill, a scoring quantum of 8 x 256), bf16 and float32, beside
   `torch.bmm` over the dequantized experts;
4. the bucketed path: `BatchingQueue` -> `TutoringEngine` (GPT-2 small at
   full width, bf16, seeded random weights unless a checkpoint is given)
   answering 8 concurrent tutoring questions, greedy twice and once with
   the reference sampling defaults; the kernels' launch counters must show
   that the path ran through them; greedy tokens of the kernel path must
   equal the plain path's in float32; one more greedy device batch runs
   under `torch.profiler` (device busy share, kernel time by name);
4b. the production path: `PagedQueue` -> `PagedEngine` (GPT-2 small at full
   width, bf16, int8 weights, int8 KV cache, 16 slots, chunk 16, inflight
   3) answering 24 questions in two waves, the second landing mid-decode
   (admission mid-decode, the cache widening), greedy twice (equal
   answers) and once with the reference sampling defaults; append-kernel
   (int8 KV) launches = 12 x decode model calls and no other one-row
   attention variant, int8 matmul launches = 49 x model calls (48 dense
   and one unembedding), exact by route: decode calls (16 rows) on the
   mma.sync tiles, prefills (a prompt bucket of rows) on the wgmma ones;
   tokens/s, mean TTFT, and a `torch.profiler` window
   (device busy share); then the paged engine in float32 with int8 weights,
   with an int8 and with a dense cache, kernel-path greedy tokens equal to
   the plain attention path's;
4c. the deployment config (configs/cluster.toml's tutoring node, its
   speculative decoding left out there): the production path above plus megastep 4
   (controller ceiling 8) as CUDA-graph replays, fused staged admission at
   32 prompt tokens an iteration and the radix prefix cache at 512 blocks,
   answering two waves: one course prompt (a long shared course context)
   with the 12 bare questions, then, once that prompt's blocks are in the
   radix tree, the other 7 course prompts and 4 exact repeats of wave-1
   questions, the waves under the compile guard
   (`compile_count_guard(expected_from_inventory(eng))`, `utils/guards.py`:
   no new program key, graph capture, kernel build or layout validation,
   and each program's keys equal to `engine/program_inventory.py`'s; the
   `inventory` line prints them with the counters before and after, and a
   negative witness, a guarded region that captures one more graph pair
   and one that runs an int8 product at a new layout, must each raise
   naming its counter); tokens/s, mean TTFT, graph replays and host decisions per
   generated token, the final K and dead lanes, stalled tokens (0), prefix
   hits (the shared context spliced into all 7 later course slots),
   launches by route counted through the replays (append-kernel attention
   = 12 x decode model calls, int8 matmul = 49 x model calls: a decode
   call's on the mma.sync tiles, an admission chunk's on the wgmma ones;
   each graph's kernel nodes
   equal its counted launches at capture; each decode chunk graph holds
   one programmatic edge an append launch and no torch append kernel,
   while the admission graphs still hold theirs), and a `torch.profiler`
   window beside
   phase 4b's, holding no more of the port's kernels than counted; then
   float32 (int8 and dense cache, 12 of the 24 requests: the 8 course
   prompts and 4 bare questions) greedy tokens of the
   deployment config equal to the sequential config's, prefix hits
   included (in bf16 the share that agrees and the first divergences are
   reported, and each prompt's flip logits through the 32-token admission
   chunks are held against the cold prefill's and a float32 reference's),
   and bf16 graph replays at K=4 equal to the eager chunk loop, greedy and
   seeded-sampled (16 requests x 64 new tokens); strict dispatch (`utils/guards.py`): under
   `strict_dispatch()` the deployment engine admits 2 requests (fused
   staging) and runs its megasteps to their answers without raising, an
   unmarked `.item()` of a CUDA tensor in the scope raises, the same read
   inside `intended_transfer()` and one on another thread do not, and
   the sync debug mode is off after it; approximate top-k: two bucketed
   nodes built from the node's flags with the reference sampling, one with
   `--approx-topk`, sample the same tokens for the 8 questions from the
   same seed;
5. gRPC on 127.0.0.1 (`serve_async`), under a tokenizer that decodes each
   of GPT-2's 50,257 ids to non-empty text (the given --vocab/--merges,
   the trained BPE where data/gpt2-local is present, else a byte-level
   vocabulary of that size built from the seed; the record names it), so
   a dropped or wrong token shows in the answer: one `GetLLMAnswer` on the
   bucketed engine equal to the engine's direct answer in text (non-empty)
   and in generated tokens; then, on the deployment config of phase 4c,
   8 concurrent `StreamLLMAnswer` calls and the same 8 queries over
   `GetLLMAnswer`: each stream gap-free, equal to the unary answer and to
   the engine's direct answer, its digest the sha256 of the stripped
   answer, its token count the direct answer's; resumes at offset 2 and
   at half the answer for two of them (exactly the token suffix, the same
   digest); launches through the replays as in 4c; host dispatches per
   token of the 8 prompts as watched streams at most 1.1x their unwatched
   run's (both through a fresh `PagedQueue` that holds all 8 before it
   starts, so the admissions match; the gRPC runs' ratios are reported);
   then, on the same config at 8 new tokens, a session whose turn 2
   (framed with FOLLOWUP_TEMPLATE over turn 1's transcript) admits with a
   prefix hit of turn 1's whole blocks (`session_active` 1,
   `session_pinned_blocks` > 0), and a drain (POST /admin/drain: both RPCs
   UNAVAILABLE, /healthz draining; undrained, an answer again; /metrics
   with stream_chunks, ttft, session_active); every served run under the
   compile guard (phase 4c's), the session engine's warmup capturing two
   graphs a width;
6. the relevance gate (`RelevanceGate`, configs/cluster.toml [gate]) at
   bert-base-uncased width (12 layers, 768 wide, vocabulary 30,522, 512
   positions, buckets 64-512, threshold 0.6), from seeded random weights
   under the byte tokenizer unless --gate-checkpoint/--gate-vocab are
   given (the record names which), in float32, bf16 and bf16 with int8
   weights: phase 4's 8 questions against an assignment text sized for
   each length bucket, one past the 512 positions and an empty one, all
   through each gate (int8 matmul launches = 48 x forwards, all on the
   wgmma route; none for the others; no attention kernel); bf16
   similarities within 2e-2 of float32's with equal decisions wherever
   float32's is further than that from 0.6, int8's within 0.05; a cache
   hit within 1e-5 of the joint miss in float32 (2e-2 in bf16); the
   float32 gate's embeddings within 1e-4 of their scale of a float64
   forward on the CPU (no TF32; the error under TF32 is reported beside);
   `check` latency p50 over 20 calls per bucket, miss and hit, the first
   check after warmup(), and a `torch.profiler` window of misses at
   buckets 64 and 512 (kernels per forward, device busy share), beside
   phase 5's TTFT over the stream;
7. speculative decoding (configs/cluster.toml [tutoring] with its
   commented-out spec_tokens = 8, prompt lookup): (a) the decode-attention
   kernel's window variant (T = k+1 query rows a row, each with its own
   causal frontier) against its plain version, row by row (each query
   row's error against its own largest output) and with two planted
   frontier faults that must fail that check, at T = 2 and 9, int8 and
   bf16 caches, widths 384 and 640, ragged frontiers one of which reaches
   the width, with its µs, bound and SDPA over a [B, 1, T, S] mask
   beside; (b) the bucketed engine with spec 8 (the kernel against its
   plain version first at this engine's rows and cache width with its
   padding bias, bf16 and float32; window launches = 12 x verify windows;
   float32 tokens equal the plain decoder's) and the float32 deployment
   with spec 8 equal to phase 4c's float32 deployment on its 12
   requests, 12 of 12; (c) the bf16 deployment with spec 8 (the
   kernel against its plain version first at each of its cache widths, 16
   slots, T = 9, int8 cache), through `PagedQueue` on 4c's two waves:
   tokens/s, TTFT, spec_tokens_per_window, spec_accepted_tokens, model
   calls per token, kernels and device ms per verify model call, the
   drain's busy share (12 requests), answers beside 4c's and the greedy
   tokens of 12 requests beside 4c's (first divergences with their
   top-2 margins), window launches = 12 x verify model calls through the
   replays, no other attention variant, served under the compile guard;
   (d) the
   n-gram drafter under the reference sampling (12 requests, every answer
   non-empty, acceptance); (e) the server built from --spec-tokens 8, and
   4 unary answers and 4 streams over gRPC equal to the engine's direct
   answers under phase 5's tokenizer. (d) and (e) run GPT-2 small's width
   cut to 4 of its 12 layers (window launches = 4 x verify calls), and
   (c)'s profiled drain its first 4 requests, so the script keeps room for
   phase 14;
8. the bulk-scoring tenant (configs/cluster.toml [scoring]) on the node
   started from the deployment file (`tutoring_server.resolve_args` with
   --config, `engine_from_args`, warmup, `serve_args`; phase 4c's engine
   plus the score shapes 1-8 texts x 32-256 tokens warmed after the graph
   capture): the first bulk job after warmup (128 texts of 48 tokens, the
   tenant alone) builds no kernel and grows no allocator segment; one
   quantum (8 texts, M = 512) launches 48 dense and one unembedding int8
   product on the wgmma route and no attention kernel, with its kernels
   and device busy share under `torch.profiler`; the card's scoring
   saturation at 8 x 256 alone (tokens/s); then 24 questions 0.03 s apart
   through the node's `GetLLMAnswer`, with the tenant OFF and then ON
   (the corpus POSTed to /admin/score first and polled to done over the
   admin plane): total and interactive tokens/s
   (`paged_score_tenant_total_tokens_per_sec_per_chip`), TTFT p90, quanta,
   quantum walls, the preemption wait (the first question lands mid-
   quantum: it must wait, and no longer than the longest quantum), no
   quantum while a question waited, no more serving-loop stalls than OFF,
   all of it under the compile guard (the score program's keys its 16
   score pairs); the job's bf16 logprobs within
   SCORE_BF16_REL_TOLERANCE of a run with the int8 matmul's plain version
   swapped in, and in float32 (int8 weights) a text's logprob batched
   equal to its logprob alone.

9. Llama-3-8B (`models/llama.py`, preset llama3-8b: 32 layers, width
   4,096, 32 query heads over 8 KV heads of 128, intermediate 14,336,
   vocabulary 128,256, untied lm_head), seeded random weights under the
   byte tokenizer: (a) each kernel of its path against its plain version
   at its shapes, timed beside its bound and library call: the int8
   matmul's seven products at M = 16, 32, 512 and 2,048 and its
   unembedding at M = 16 and 512 (the deep ones through the x-staged
   plans), the append kernel over int8 and bf16 caches (16 slots, G = 4,
   Dh = 128, lengths over [1, 384]), the int8 window at T = 9 (width 391)
   and the bucketed kernel (batch 8, width 384); (b) a float32 witness at
   full width cut to 4 layers: the paged engine with int8 weights and KV
   gives equal greedy tokens on 8 prompts with fused attention off, on
   and on with spec 8 (launches: 29 int8 products a model call on the
   CUDA cores; the append kernel 4 a decode call, or the window kernel 4
   a verify call); (c) the deployment config from configs/cluster.toml
   (`--config`, `--model llama3-8b`) at full depth in bf16: 16 requests
   in two waves, 128 new tokens each, through `PagedQueue`: tokens/s,
   TTFT p50/p90, decode model calls, device ms a decode call by idle
   graph replay beside its weights' bytes bound, kernels a decode call,
   launches by route through the replays (append = 32 x decode calls,
   int8 = 224 dense and 1 unembedding x model calls, decode calls' on the
   mma.sync tiles, admission chunks' on the wgmma ones), peak allocation,
   seconds to initialise and to warm; then (d) one scoring quantum at
   8 x 256 (M = 2,048) against the plain logprobs, and a short spec-8
   run of 4 requests at full width cut to 4 layers (window = 4 x verify
   calls, int8 = 28 dense and 1 unembedding x model calls; 8 layers
   before phase 16 took the time), so that the
   whole script keeps room for phase 13.
10. gpt2-moe (`models/moe.py`, preset gpt2-moe: GPT-2 small's trunk, 8
   experts of GPT-2 small's MLP, top-2, capacity factor 1.25), seeded
   random weights under the byte tokenizer: (a) its expert products in
   phase 3b; (b) a float32 witness at full
   width cut to 4 layers, the paged engine with int8 weights and KV
   eagerly: the kernel path's greedy tokens on 8 prompts equal to the plain
   path's (plain attention, both int8 wrappers' plain versions; launches: 8
   expert and 9 dense int8 products a model call on the CUDA cores, 4
   append a decode call); (c) the deployment config from
   configs/cluster.toml (`--config`, `--model gpt2-moe`) at full depth in
   bf16: 16 requests in two waves, 128 new tokens, greedy twice on one
   schedule (wave 1 drained, then wave 2, the engine reset and the prefix
   tree emptied before each: equal tokens; at capacity 1.25 an answer
   depends on the rows that share its forwards, so that is the schedule
   that must repeat), then once through PagedQueue with wave 2 landing
   mid-decode: tokens/s, TTFT
   p50/p90, device ms a decode call by idle graph replay beside its int8
   weights' bytes bound, where that time goes under `torch.profiler`
   (expert, dense and unembedding products, append, the eager rest),
   kernels a decode call, launches by route through the replays (append =
   12 x decode calls; int8 = 24 expert, 24 dense and 1 unembedding x model
   calls on the mma.sync tiles but an admission chunk's dense products and
   unembedding (32 rows) on the wgmma ones; each graph's kernel nodes
   equal its counted launches at capture); (d) one scoring quantum at 8 x
   256 (C = 640, all 49 products on the wgmma route) against the plain
   logprobs; then the same 16 requests at the file's
   sampling settings.
11. the LMS main path (ROADMAP's north star, no JAX anywhere): a copy of
   configs/cluster.toml in a temporary directory with free ports for the
   five LMS nodes, the data directory there, the tutoring node's address
   and metrics port in [tutoring] and [tutoring_fleet] (the file's fleet
   names LMS ports 50055/50056), the gate's checkpoint and vocabulary
   removed unless --gate-checkpoint/--gate-vocab are given, and the
   gate's threshold set to the midpoint between the lowest similarity of
   the 8 QUESTIONS and an off-topic query's under an in-process gate on
   the nodes' seed and dtype (the next off-topic query of a fixed list
   until the gap is at least 4e-2); each change printed. Five LMS
   processes (`python -m distributed_lms_raft_llm_tpu_torch.serving.
   lms_server --config <copy> --id N --metrics-port P`, output kept in
   the run's output directory), each building the bert-base gate on the
   card (bf16), and the tutoring node in this process from the same copy
   (`resolve_args --config`, `engine_from_args`, warmup, `serve_args`):
   GPT-2 small at full width, bf16, int8 weights and KV, 16 slots,
   megastep, fused admission, the prefix cache, greedy, phase 5's
   tokenizer. One leader named by all five through WhoIsLeader within
   10 s of all five serving; one student through the port's `LMSClient`:
   Register, Login, Post an assignment PDF, the 8 QUESTIONS concurrently
   over GetLLMAnswer (each equal to the node's direct answer, non-empty),
   the off-topic query refused with the reference's text at a similarity
   within 2e-2 of the in-process gate's (plus the text's rounding), the
   leader's gate_pass 8 and gate_reject 1, 2 questions over
   StreamLLMAnswer equal to their unary answers (no resume, digest ok);
   then the leader's process SIGKILLed: a new leader within 10 s, the
   session valid and a question answered as before, the killed node
   restarted on its data directory at the leader's applied index within
   10 s of serving; launches over the phase through the node's counters
   (append = 12 x decode calls, int8 = 49 x model calls on the tensor
   cores, no other attention variant; the node under the compile guard);
   GetLLMAnswer p50/p90 through the LMS beside the node's direct calls
   (cold, before the LMS run; and again after it, as warm), the leader's
   `gate.check` span p50/p90 over the 8 concurrent questions and alone
   (the off-topic one), election, failover and catch-up seconds. Every
   LMS process is stopped in a `finally`;
11b. a two-group LMS: five more port LMS processes, started beside phase
   11's (they boot during it), from a second copy of configs/cluster.toml
   with the same changes on other ports plus a `[groups]` section (count
   2, a port stride for which every node's group-1 Raft port was probed
   free, a secret), in front of phase 11's tutoring node with its gate
   threshold. Once phase 11's processes are stopped: every node's GET
   /admin/raft names the same leader of each group (5 members, term and
   applied index >= 1, group 1 on base + stride), POST /admin/reshard
   answers 400 "resharding is not enabled on this deployment"; 8
   students, 4 homed in each group by `RoutingMap.initial(2)`, and an
   instructor register and log in once, each student posts the
   assignment PDF, and the instructor's fan-out read returns all 8; the
   8 QUESTIONS concurrently, one a student, through the routers (each
   equal to the node's direct answer; the node's direct calls again
   beside them), the off-topic query refused with its similarity, one
   StreamLLMAnswer of a group-1 student equal to its unary answer; each
   leader's `gate.check` spans; the posts read back through a node
   leading neither group; then the process leading group 1 SIGKILLed:
   both groups led again within 10 s and a group-1 student answered
   through the routers (seconds from the kill); the same journey once
   through `python -m distributed_lms_raft_llm_tpu_torch.client.cli`
   with piped stdin (register, log in, post, ask: the direct answer);
   launches over the phase exact as in phase 11.
12. fine-tune and serve: a course directory written from the seed (notes
   of phases 4c, 6 and 11's course texts and the questions, cut to 9
   batches of 8 x 128 byte tokens; a PDF made by `utils/pdf.make_pdf`; a
   file the loader ignores); GPT-2 small at full width (bf16 compute,
   float32 params) trained 2 epochs (18 steps; 36 before phase 16 took
   the time) through the trainer's
   entry point (`train.train.main`, the `python -m
   distributed_lms_raft_llm_tpu_torch.train.train` CLI, in process) with
   a checkpoint and an export: every loss finite, every gradient norm
   above 0, the last loss below 0.8x the first, the sidecar's step 18;
   the median step ms after the first 3 steps, tokens/s and the peak
   allocation reported; resume: the first epoch run by `fit` with the
   CLI's schedule and checkpointed, then the CLI's entry point (in this
   process; a fresh one before phase 17 took the time) resumes it from
   the checkpoint file to step 18, its checkpoint bit-equal to the
   straight run's, leaf by leaf; the export read back through `convert.gpt2_params_from_hf`
   gives float32 logits over a framed question within 1e-5 of their range
   of the trained params'; a node from configs/cluster.toml (the
   deployment's `[tutoring]`, greedy) with `--checkpoint` on the export
   answers the 8 questions over `GetLLMAnswer`, each equal to its engine's
   direct greedy answer, launches exact through the replays (append =
   12 x decode calls, int8 = 49 x model calls on the tensor cores), no
   capture while serving; how far greedy decoding continues the corpus
   from a 256-byte prefix (reported); in float32 the deployment engine on
   the export gives the kernel path's greedy tokens equal to the plain
   path's; then gpt2-moe 4 steps on the corpus's first batches (losses,
   `moe_balance` and gradient norms finite, norms above 0), its native
   export read back through `moe.params_from_hf` with equal float32
   logits.
13. one seeded semester: `sim.SemesterSim` (the port's `sim/`) with
   configs/cluster.toml's `[sim]` as it stands (24 students, 30 s, base
   rate 8, 3 tutoring nodes, course concentration 0.6, bulk scoring, the
   continuous SLOs; read from a `deployment_copy` with no change, since
   the sim binds ephemeral ports and keeps its data in a temporary
   directory) on the port's in-process LMS (3 Raft nodes, group router
   off, `KeywordGate`) and tutoring fleet, tutoring node 0 on the
   deployment engine of phases 4c and 11 (GPT-2 small at full width,
   seeded random weights, phase 5's tokenizer, greedy as there, since a
   stream resumed mid-answer regenerates it; the file's `[tutoring]` and
   `[scoring]`: paged, int8 weights and KV, megastep graphs, fused
   admission, the prefix cache, a `ScoringManager`), built
   and warmed through `SemesterSim(..., tutoring_engine_factory=)` on the
   sim's loop before any Raft node boots; nodes 1-2 and the autoscaled
   node are the echo stand-in, as in the JAX package's sim. The record's
   verdict must hold: every event executed ok, every end-of-run SLO, no
   lost acked write or read-your-writes violation, no false burn alarm,
   an acyclic lock graph without violations. Node 0: /healthz names the
   `PagedEngine`; its engine answered at least one course's question and
   every course's question it received (prompts attributed by their
   course context); its /metrics' `ttft` count equals the answers its
   engine finished, `llm_requests` at least the engine's submissions, its
   `scoring_quanta` the engine's score calls. Launches over the semester
   through the replays: append = 12 x decode calls and no other
   attention variant, int8 = 49 x model calls exact by route (decode on
   the mma.sync tiles; admission chunks, prefills and score quanta on the
   wgmma ones); node 0 under the compile guard from its warmup to the
   semester's end, and no kernel built in its boot.
   Printed: ask p50/p95, turn TTFT p95, degraded answers and rate, ledger
   counts, events, alerts, tick stalls, node 0's tokens/s, answers by
   course and routes, the launches and the phase's seconds.
14. tensor parallelism (`parallel/`): Llama-3-8B's widths (width 4,096,
   32 query heads over 8 KV heads of 128, intermediate 14,336, vocabulary
   128,256) cut to 4 layers, seeded random weights, the byte tokenizer.
   (c) first, alone on the card: each kernel a tp rank runs at its shard's
   shapes against its plain version, timed beside its bound and library
   call: the int8 append kernel at 16 slots, 16 of 32 query heads over 4
   of 8 KV heads (width 384), and the int8 products' halves (wq, wk, wv,
   wg, wu and lm_head's 64,128 vocabulary rows column-parallel, wo and wd
   row-parallel) at M = 16 and 512. Then this script starts itself twice
   as two tp ranks (`--tp-rank`), which join one gloo process group on
   the card (NCCL refuses two ranks on one device) and build every engine
   alike, rank 0 driving and rank 1 following it; meanwhile this process
   runs the tp 1 references. (a) A float32 witness (int8 weights and KV,
   eager): greedy tokens of 4 requests x 16 new tokens byte-equal at tp 1
   and tp 2, both ranks the same tokens and host decisions. (b) The
   deployment config (configs/cluster.toml [tutoring]: int8 weights and
   KV, megastep 4/8, fused admission, the prefix cache; `cuda_graphs=False`
   since gloo's collectives cannot be captured) at tp 2 in bf16, 8
   requests x 32 new tokens through `PagedQueue` on rank 0: both ranks the
   same tokens and decisions, tokens beside tp 1's (each first divergence
   where tp 1's top-2 margin is below 0.1), one forward's logits no
   further from tp 1's bf16 ones and the float32 model's than twice tp
   1's bf16 logits sit from the float32 ones, each rank's KV bytes half
   of tp 1's, `serving_tp` 2; launches by route exact on each rank (append = 4 x
   decode calls; int8 = 28 dense and 1 unembedding x model calls, decode
   calls on the mma.sync tiles, admission chunks on the wgmma ones). A
   refusal: `cuda_graphs=True` over gloo raises on each rank. These times
   are not tp's speed: every collective crosses host memory.
15. the rest of serving's parallel axes, in phase 14's two rank processes
   (after its work there), this process running the one-rank references
   meanwhile. (a) gpt2-moe at full width and depth (8 experts, top-2),
   int8 weights and KV, over two ep ranks (each holding 4 of the 8
   experts, half of ep 1's expert bytes): a float32 witness (4 requests x
   16 tokens, eager) byte-equal to ep 1's, the ranks equal in tokens and
   decisions; the deployment config eagerly (8 bare questions x 32, bf16,
   all submitted then drained: capacity drops make a token depend on its
   batch, so ep 1 and ep 2 run one schedule): both ranks the same tokens
   and decisions, tokens reported beside ep 1's with the router's
   near-ties, one forward's logits (bit-equal to ep 1's or not, said) no
   further from ep 1's and the float32 model's than twice ep 1's own bf16
   error; a scoring quantum of 8 x 256 (C = 640, the wgmma expert route);
   launches by route exact on each rank; whether a 4-expert launch of the
   expert kernel gives each expert an 8-expert launch's bits. (b) GPT-2 small's scoring (int8)
   over two sp ranks, 2 texts in the 1,024-token bucket: the ring forward
   (`parallel/ring.py`, the K/V blocks rotated through host buffers over
   gloo), its steps and rotations timed; each text's log probability
   within 1e-5 (relative) of sp 1's in float32, and in bf16 within twice
   bf16's own error at sp 1; ranks equal; launches exact. (c) The
   deployment's gate (bert-base, int8, bf16) over two tp ranks: 8 pairs'
   similarity within 2e-2 of tp 1's, equal verdicts away from the 0.6
   threshold, each rank half the word table, launches exact. Then alone
   on the card: the expert kernel at 4 experts (C 5 / 10 / 80 / 640 bf16,
   C 5 float32) and BERT-base's products' tp-2 halves at M = 128 and
   1,024, each against its plain version beside its bound and library
   call. (d) A graphed GPT-2 small engine served once through a node
   (`serve_args`, the scoring tenant on), then dropped with the garbage
   collector off: freed by reference counting alone, its memory returned.
16. the sharded trainer (`train.make_sharded_train_step`, `parallel/
   pipeline.py`), in phase 14's two rank processes after phase 15 (its
   engines dropped), this process running the one-rank references
   meanwhile (`make_sharded_train_step` on a one-rank mesh). GPT-2 small
   at full width and depth (12 layers, vocabulary 50,257) in float32
   (TF32 off), seeded weights, 3 steps of seeded 8 x 128 batches under a
   ragged loss mask (~70% of the targets), lr 1e-4 (warmup 1), remat on:
   (a) over two dp ranks: each step's loss within 1e-5 and grad norm
   within 1e-4 (relative) of one rank's, the ranks' metrics equal, every
   leaf of the state after step 3, gathered and written by rank 0
   (`save_train_state` over the mesh), within the CPU tests' tolerances
   of one rank's (Adam's moments, the params, the key bias within lr x
   the steps that move it, counts and step equal), both ranks' params
   bit-equal (sha256); the gradient bytes all-reduced a step and the ms;
   (b) over two pp stages at pp_micro 2 and 4: the same checks, each
   rank's blocks and their moments half of one rank's bytes, the ticks
   (n_micro + 1 a step), the hops (n_micro sends and receives a step on
   each rank) with ms per tick and per hop; (c) over two sp ranks at
   2 x 1,024 tokens (the ring forward and backward): the same checks on
   its own one-rank reference, the rotations 12 a step forward and 12
   in remat's recompute, 12 backward; (d) gpt2-moe at full width and
   depth (8 experts, top-2) over two ep ranks: loss with aux,
   `moe_balance` and grad norm against ep 1 as in (a), each rank's
   expert params and moments half of ep 1's bytes; (e) the trainer's CLI
   on both ranks (`train.train.main --pp 2 --backend gloo`, bf16 compute,
   phase 12's course directory at 4 x 512 byte tokens: 4 steps) with a
   checkpoint and an export: finite losses, the checkpoint holding the
   one-device file's keys and shapes, restored here at pp 1 for the next
   step (epoch 2's first batch) within 2e-2 (relative) of the ranks'
   next step at pp 2, the export read back through the serving
   converter giving the checkpoint params' float32 logits; (f) on each
   rank, the refusals: tp 2 at GPT-2 small's vocabulary, pp with MoE,
   with sp and with tp (the JAX package's messages word for word), an
   engine over a pp-2 mesh. The training path launches none of the
   port's kernels (checked: no launch over the phase). These times are
   not parallelism's speed: every collective crosses host memory.
17. dp inside one engine, in phase 14's two rank processes after phase
   16, this process running the dp-1 references meanwhile: the ranks laid
   out by `make_hybrid_mesh({}, {"dp": 2})`, each process a host of its
   own (`local_world_size=1`), on gloo; every engine over both ranks,
   rank 0 driving and rank 1 replaying the whole batch. (a) GPT-2 small's
   deployment (configs/cluster.toml [tutoring]: paged, int8 weights and
   KV, megastep 4/8 on CUDA graphs, which a dp-only engine captures over
   gloo since its model calls hold no collective, fused admission, the
   prefix cache) at full width and depth in float32: phase 4c's 4 bare
   questions x 32 greedy tokens, served under the compile guard on each
   rank (warmup first), each rank's tokens byte-equal to a dp-1 engine's,
   both ranks the same decisions, each rank's KV bytes dp 1's, and each
   rank's launches by route (append = 12 x decode calls, int8 = 49 x
   model calls on the CUDA cores, through the replays) equal to dp 1's;
   (b) the bucketed engine on the same config: one generate of the 4
   questions (answers equal to dp 1's) and one scoring quantum of the 8
   QUESTIONS (log probabilities within 1e-5 of dp 1's), launches equal to
   dp 1's; (c) the deployment's gate (bert-base, int8, bf16): one check,
   its verdict dp 1's and its similarity within 2e-2, launches equal.
   dp adds no throughput here, as in the JAX package: each rank computes
   what one rank computes.

18. the deployment from artifacts built on the card: (a) the port's
   `tools/make_local_checkpoint.py` (no `tokenizers`, no `transformers`)
   writes GPT-2 small's byte-level BPE and checkpoint and bert-base's
   WordPiece and checkpoint into a temporary directory (never data/),
   trained on this checkout's text, the weights drawn on the card from
   the seed: seconds for the corpus, each trainer and each checkpoint,
   the corpus' bytes and sha256, both vocabularies' sizes, the prompts'
   token counts under the BPE beside the byte tokenizer; (b) the tutoring
   node's engine from configs/cluster.toml with only --checkpoint,
   --vocab and --merges pointed at them (int8 weights and KV, graphs,
   megastep, fused admission, the prefix cache), warmed, serving the 8
   framed questions and the 8 course prompts through PagedQueue under
   the compile guard: non-empty answers, 0 new keys, captures, builds and
   layouts, launches by route through the replays as in 4c, every leaf
   the node serves against the file read by its format (float leaves
   equal, int8 leaves within one step of their scale) and the float32
   tree mapping back to the file exactly; a float32 witness of
   the file's first 4 layers whose kernel-path greedy tokens equal the
   plain path's; (c) the gate from [gate] with only --gate-checkpoint and
   --gate-vocab pointed at them, built as the LMS node builds it: its
   WordPiece ids equal to the plain tokenizer's, check p50 per bucket
   (64-512), a float32 gate's similarities within 1e-5 of its plain
   float64 version on the CPU and the deployment's bf16 within 2e-2 of
   float32's; (d) `tools/profile_decode.py` on those files: the device
   mode (batch 8, int8 weights and KV) with its module scopes (the
   port's kernels credited by the wrappers' counters) and the kernels it
   saw against those launched, and the dispatch-gap mode at
   K = 4 against the chunk loop. Nothing falls back: a failed build or
   load fails the run.

The last two lines of standard output are the `kernels` JSON record and
the `{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import hashlib
import json
import logging
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "distributed_lms_raft_llm_tpu_torch"

H100_HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TF32
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}
QUESTIONS = [
    "What is a binary search tree?",
    "How does Raft elect a leader?",
    "Explain the difference between a process and a thread.",
    "Why is quicksort O(n log n) on average?",
    "What does a hash table trade for constant-time lookup?",
    "How do I find a cycle in a linked list?",
    "What is dynamic programming?",
    "When should I use a heap instead of a sorted array?",
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields, sort_keys=True)}", flush=True)


@contextlib.contextmanager
def inventory_guard(eng, what: str):
    """Serve inside `compile_count_guard(expected_from_inventory(eng))`
    (`utils/guards.py`): no new program key, no graph capture, kernel build
    or layout validation, and every warmup-covered program's key count
    equal to the manifest's at the end. Yields a record that is filled, at
    the end, with {program: [keys, inventoried]} and the three counters
    before and after; a violation fails the phase."""
    from distributed_lms_raft_llm_tpu_torch.utils.guards import (
        RecompileError, card_counters, compile_count_guard,
        expected_from_inventory)

    expectation = expected_from_inventory(eng)
    record = dict(counters_before=card_counters())
    try:
        with compile_count_guard(expectation, what=what) as guard:
            yield record
    except RecompileError as exc:
        raise SmokeFailure(str(exc)) from exc
    finally:
        record.update(
            programs={k: list(v) for k, v in expectation.report().items()},
            counters_after=card_counters())
    record["new_program_keys"] = guard.new_compiles()


# ------------------------------------------------- decode attention


def attention_case(torch, attention, *, b, h, hkv, s, dh=64, n_layers=12,
                   layer=7, dtype="bfloat16", pad=None, s_alloc=None,
                   strided_q=False, seed=0):
    """Kernel vs plain version (and SDPA as a yardstick) at one shape.

    pad: per-row left padding (ragged mask); s_alloc: the cache holds
    s_alloc slots and the kernel reads a window of the first s; strided_q:
    q is a view of a [B, 1, 3*H*Dh] projection split into heads, as the
    model passes it. Returns the case record; raises if the kernel
    disagrees."""
    import torch.nn.functional as F

    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_alloc = s_alloc or s
    shape = (n_layers, b, hkv, s_alloc, dh)
    if strided_q:
        qkv = torch.randn((b, 1, 3 * h * dh), generator=gen,
                          device=dev).to(dt)
        q = qkv[..., :h * dh].reshape(b, 1, h, dh).transpose(1, 2)
    else:
        q = torch.randn((b, h, 1, dh), generator=gen, device=dev).to(dt)
    k_full = torch.randn(shape, generator=gen, device=dev).to(dt)
    v_full = torch.randn(shape, generator=gen, device=dev).to(dt)
    k_cache, v_cache = k_full[:, :, :, :s], v_full[:, :, :, :s]
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=dev)
    if pad is not None:
        for row, p in enumerate(pad):
            mask[row, ..., :p] = False
    bias = attention.mask_to_bias(mask)

    got = attention.decode_attention(q, k_cache, v_cache, layer, bias)
    want = attention.decode_attention_reference(q, k_cache, v_cache, layer,
                                                bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOLERANCE[dtype],
          f"decode_attention disagrees with its plain version: max abs "
          f"err {err} > {TOLERANCE[dtype]} (b={b} h={h} hkv={hkv} s={s} "
          f"{dtype})")
    es = torch.finfo(dt).bits // 8
    n_bytes = (2 * b * hkv * s * dh * es      # K and V of the layer
               + 2 * b * h * dh * es          # q in, out
               + b * s * 4)                   # bias
    n_ops = 4 * b * h * s * dh                # q.K and p.V multiply-adds
    bound_us = max(n_bytes / H100_HBM_BYTES_PER_S,
                   n_ops / PEAK_OPS_PER_S[dtype]) * 1e6
    plan = attention.launch_plan(b, hkv, s, dh, dt, group=h // hkv)
    rec = dict(b=b, h=h, hkv=hkv, s=s, s_alloc=s_alloc, dh=dh,
               dtype=dtype, layer=layer, ragged=pad is not None,
               padded_rows=sum(1 for p in pad or () if p),
               strided_q=strided_q, n_split=plan.n_split,
               split_keys=plan.split_keys, tile_keys=plan.tile_keys,
               max_abs_err=err, bound_us=bound_us,
               bound_by="bytes" if n_bytes / H100_HBM_BYTES_PER_S
               >= n_ops / PEAK_OPS_PER_S[dtype] else "operations")

    # Consecutive calls walk the layers, so each reads K/V that the last
    # call did not (the decode step streams other weights in between).
    def kernel(i):
        attention.decode_attention(q, k_cache, v_cache, i % n_layers, bias)

    def plain(i):
        attention.decode_attention_reference(q, k_cache, v_cache,
                                             i % n_layers, bias)

    sdpa_mask = bias[:, :, None, :].to(dt)

    def library(i):
        F.scaled_dot_product_attention(q, k_cache[i % n_layers],
                                       v_cache[i % n_layers],
                                       attn_mask=sdpa_mask,
                                       enable_gqa=hkv != h)

    rec.update(
        kernel_us=time_graph_us(kernel),
        kernel_eager_us=time_eager_us(kernel),
        plain_us=time_graph_us(plain),
        library_us=time_graph_us(library),
    )
    return rec


# ----------------------------------------------- paged-path kernels


def paged_attention_case(torch, attention, *, s, width, int8, s_alloc=384,
                         dtype="bfloat16", h=12, dh=64, n_layers=12,
                         lengths=None, pads=None, seed=0):
    """The paged decode step's attention: `s` slots, a window of `width`
    slots of an `s_alloc`-slot cache, per-row lengths (spread over [1,
    width] unless given), no bias, q strided, a float or int8 cache.
    With `pads` (each row's left padding) the bucketed engine's decode
    step instead: no lengths, every row's query at the window's last step
    (slot width - 2) and the bias the model builds (`causal_window_mask`
    and the key-validity mask through `mask_to_bias`). Kernel vs plain;
    SDPA with a boolean mask over the cache (dequantized beforehand,
    untimed, for int8) as the yardstick."""
    import torch.nn.functional as F

    from distributed_lms_raft_llm_tpu_torch.models.common import (
        causal_window_mask,
        quantize_kv,
    )
    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((s, 1, 3 * h * dh), generator=gen, device=dev).to(dt)
    q = qkv[..., :h * dh].reshape(s, 1, h, dh).transpose(1, 2)
    shape = (n_layers, s, h, s_alloc, dh)
    kf = torch.randn(shape, generator=gen, device=dev)
    vf = torch.randn(shape, generator=gen, device=dev)
    scales = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        scales = dict(k_scale=ks[..., :width], v_scale=vs[..., :width])
        kd = (k.float() * ks[..., None]).to(dt)[:, :, :, :width]
        vd = (v.float() * vs[..., None]).to(dt)[:, :, :, :width]
    else:
        k, v = kf.to(dt), vf.to(dt)
        kd, vd = k[:, :, :, :width], v[:, :, :, :width]
    del kf, vf
    k, v = k[:, :, :, :width], v[:, :, :, :width]
    bias = None
    if pads is not None:
        slots = torch.full((s, 1), width - 2, dtype=torch.long, device=dev)
        valid = (torch.arange(width, device=dev)[None, :]
                 >= torch.as_tensor(pads, device=dev)[:, None])
        bias = attention.mask_to_bias(causal_window_mask(slots, width)
                                      & valid[:, None, None, :])
        lengths = None
        mask = bias[:, :, None, :] == 0
        row_keys = mask.sum(dim=(1, 2, 3))
    else:
        if lengths is None:
            lengths = torch.randint(1, width + 1, (s,), generator=gen,
                                    device=dev)
            lengths[0], lengths[-1] = 1, width
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        mask = (torch.arange(width, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        row_keys = lengths

    got = attention.decode_attention(q, k, v, 5, bias, lengths=lengths,
                                     **scales)
    want = attention.decode_attention_reference(
        q, k, v, 5, bias, lengths, scales.get("k_scale"),
        scales.get("v_scale"))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # Relative to the output's magnitude where dequantized values pass 1.
    tol = TOLERANCE[dtype] * max(1.0, want.float().abs().max().item())
    check(math.isfinite(err) and err <= tol,
          f"paged decode_attention (int8={int8}) disagrees with its plain "
          f"version: max abs err {err} > {tol} (s={s} width={width} "
          f"{dtype})")
    keys = int(row_keys.sum().item())  # the keys this data needs
    es = torch.finfo(dt).bits // 8
    kv_bytes = (2 * h * keys * dh) * (1 if int8 else es)
    n_bytes = (kv_bytes + (2 * 4 * h * keys if int8 else 0)
               + 2 * s * h * dh * es
               + (4 * s if bias is None else 4 * s * width))
    n_ops = 4 * h * keys * dh
    t_bytes, t_ops = (n_bytes / H100_HBM_BYTES_PER_S,
                      n_ops / PEAK_OPS_PER_S[dtype])
    plan = attention.launch_plan(s, h, width, dh, k.dtype)
    rec = dict(slots=s, width=width, s_alloc=s_alloc, int8=int8,
               dtype=dtype, bias=bias is not None,
               lengths_min=int(row_keys.min().item()),
               lengths_max=int(row_keys.max().item()), keys=keys,
               n_split=plan.n_split, split_keys=plan.split_keys,
               tile_keys=plan.tile_keys, max_abs_err=err, tolerance=tol,
               bound_us=max(t_bytes, t_ops) * 1e6,
               bound_by="bytes" if t_bytes >= t_ops else "operations")

    def kernel(i):
        attention.decode_attention(q, k, v, i % n_layers, bias,
                                   lengths=lengths, **scales)

    def plain(i):
        attention.decode_attention_reference(
            q, k, v, i % n_layers, bias, lengths, scales.get("k_scale"),
            scales.get("v_scale"))

    def library(i):  # over the dequantized cache (int8): a yardstick
        F.scaled_dot_product_attention(q, kd[i % n_layers], vd[i % n_layers],
                                       attn_mask=mask)

    rec.update(kernel_us=time_graph_us(kernel),
               kernel_eager_us=time_eager_us(kernel),
               plain_us=time_graph_us(plain),
               library_us=time_graph_us(library),
               library_note="SDPA, boolean mask" + (
                   " over the cache dequantized beforehand (untimed)"
                   if int8 else ""))
    return rec


def append_attention_case(torch, attention, *, s, width, cache,
                          h=12, hkv=12, dh=64, n_layers=12, s_alloc=None,
                          lengths=None, seed=0):
    """The paged decode step's one kernel, `decode_attention_append`:
    `s` slots, a window of `width` slots of an `s_alloc`-slot cache
    (`cache` "int8" with bf16 q, "bfloat16" or "float32"), per-row lengths
    spread over [1, width] with a dead slot at the width (it writes slot
    width - 1, as the engine's clamp makes it), q, k_new and v_new strided
    views of one qkv row as the model passes them. Against its plain
    version on copies of the same cache: the output row by row within
    tolerance (`sweep_attention.window_error`: a query row's error over
    its own largest output, since a long row averages down near 0.1
    where a one-key row is a raw v row) and all four cache tensors
    `torch.equal` afterwards (the new rows, their scales, nothing else
    written). The same check must fail on a planted fault, the new key
    left out of the fold: what the kernel would give then, computed by the
    attend-only kernel over the long rows' (over half the longest) older
    keys; `caught_by_call_max_check` says whether a limit scaled by the
    call's largest output would have caught it too. Timed beside the
    kernel it replaces alone (`decode_attention` over the cache), the
    sequence it replaces in one CUDA graph (two `quantize_kv`, four row
    writes, that kernel), the plain version and SDPA (over the dequantized
    cache, untimed beforehand); the kernel launched as the model launches
    it (`dependent=True`: the launch before it writes another layer); the
    bound counts the append's bytes."""
    import torch.nn.functional as F

    from distributed_lms_raft_llm_tpu_torch.models.common import quantize_kv
    from distributed_lms_raft_llm_tpu_torch.models.common import write_rows as _write_rows
    from distributed_lms_raft_llm_tpu_torch.ops.sweep_attention import (
        WINDOW_ROW_TOLERANCE,
        window_error,
    )
    from distributed_lms_raft_llm_tpu_torch.ops.timing import (
        time_eager_us,
        time_graph_us,
    )

    int8 = cache == "int8"
    dtype = "bfloat16" if int8 else cache
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_alloc = s_alloc or max(width, 384)
    qkv = torch.randn((s, 1, (h + 2 * hkv) * dh), generator=gen,
                      device=dev).to(dt)
    q = qkv[..., :h * dh].reshape(s, 1, h, dh).transpose(1, 2)
    k_new = qkv[..., h * dh:(h + hkv) * dh].reshape(
        s, 1, hkv, dh).transpose(1, 2)
    v_new = qkv[..., (h + hkv) * dh:].reshape(s, 1, hkv, dh).transpose(1, 2)
    shape = (n_layers, s, hkv, s_alloc, dh)
    kf = torch.randn(shape, generator=gen, device=dev)
    vf = torch.randn(shape, generator=gen, device=dev)
    if int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(dt), vf.to(dt), None, None
    del kf, vf
    if lengths is None:
        lengths = torch.randint(1, width + 1, (s,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 1, width
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)

    def window(x):
        return None if x is None else x[..., :width, :] if x.dim() == 5 \
            else x[..., :width]

    def views(full):  # (k, v, ks, vs) windows of full tensors
        return [window(x) for x in full]

    full = [k, v, ks, vs]
    ref_full = [None if x is None else x.clone() for x in full]
    layer = 5
    rk, rv, rks, rvs = views(ref_full)
    want = attention.decode_attention_append_reference(
        q, k_new, v_new, rk, rv, layer, None, lengths=lengths, k_scale=rks,
        v_scale=rvs)
    kw, vw, ksw, vsw = views(full)
    got = attention.decode_attention_append(
        q, k_new, v_new, kw, vw, layer, None, lengths=lengths, k_scale=ksw,
        v_scale=vsw)
    torch.cuda.synchronize()
    what = (f"(s={s} width={width} cache={cache} h={h} hkv={hkv})")
    rows = window_error(got, want, dtype)
    check(rows["ok"], f"decode_attention_append disagrees with its plain "
          f"version: a row's error is {rows['max_row_rel_err']} of its "
          f"largest output > {WINDOW_ROW_TOLERANCE[dtype]} {what}")
    same = [x is None or bool(torch.equal(x, y))
            for x, y in zip(full, ref_full)]
    check(all(same), f"decode_attention_append's cache (k, v, ks, vs) is "
          f"not equal to its plain version's: {same} {what}")
    del ref_full, rk, rv, rks, rvs
    # The planted fault: the long rows' new keys left out of the fold. The
    # older keys are the slots below lengths - 1, which the append left as
    # they were.
    long = (lengths > lengths.max() // 2).to(lengths.dtype)
    dropped = window_error(attention.decode_attention(
        q, kw, vw, layer, None, lengths=lengths - long,
        k_scale=ksw, v_scale=vsw), want, dtype)
    check(not dropped["ok"], f"decode_attention_append: the planted fault "
          f"(the long rows' new key left out of the fold) passed the "
          f"check {what}")
    call_max = TOLERANCE[dtype] * max(1.0, want.float().abs().max().item())

    keys = int(lengths.sum().item())  # keys attended; s of them new
    es = torch.finfo(dt).bits // 8
    kvb = 1 if int8 else es
    n_bytes = (2 * hkv * (keys - s) * dh * kvb         # older K/V rows
               + (2 * 4 * hkv * (keys - s) if int8 else 0)   # their scales
               + 2 * s * hkv * dh * es                 # k_new, v_new in
               + 2 * s * hkv * dh * kvb                # the new rows out
               + (2 * 4 * s * hkv if int8 else 0)      # their scales out
               + 2 * s * h * dh * es + 4 * s)          # q in, out; lengths
    n_ops = 4 * h * keys * dh
    t_bytes, t_ops = (n_bytes / H100_HBM_BYTES_PER_S,
                      n_ops / PEAK_OPS_PER_S[dtype])
    plan = attention.launch_plan(s, hkv, width, dh, k.dtype, group=h // hkv,
                                 append=True)
    rec = dict(slots=s, width=width, s_alloc=s_alloc, cache=cache,
               int8=int8, dtype=dtype, h=h, hkv=hkv,
               lengths_min=int(lengths.min().item()),
               lengths_max=int(lengths.max().item()), keys=keys,
               n_split=plan.n_split, split_keys=plan.split_keys,
               tile_keys=plan.tile_keys, blocks=plan.blocks,
               max_abs_err=rows["max_abs_err"],
               max_row_rel_err=rows["max_row_rel_err"],
               row_tolerance=WINDOW_ROW_TOLERANCE[dtype], cache_equal=True,
               fault_new_key_dropped=dict(
                   max_row_rel_err=dropped["max_row_rel_err"],
                   caught_by_call_max_check=dropped["max_abs_err"]
                   > call_max),
               bound_us=max(t_bytes, t_ops) * 1e6,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    scales = dict(k_scale=ksw, v_scale=vsw) if int8 else {}

    def kernel(i):
        attention.decode_attention_append(
            q, k_new, v_new, kw, vw, i % n_layers, None, lengths=lengths,
            **scales, dependent=True)

    def old_kernel(i):
        attention.decode_attention(q, kw, vw, i % n_layers, None,
                                   lengths=lengths, **scales)

    batch_rows = torch.arange(s, device=dev)[:, None]
    slots = (lengths.long() - 1)[:, None]

    def old_sequence(i):  # models/gpt2.py's route before the append kernel
        layer = i % n_layers
        if int8:
            (k_w, k_s), (v_w, v_s) = quantize_kv(k_new), quantize_kv(v_new)
            news = [(kw, k_w), (vw, v_w), (ksw, k_s), (vsw, v_s)]
        else:
            news = [(kw, k_new), (vw, v_new)]
        for buf, val in news:
            _write_rows(buf, layer, batch_rows, slots, val.transpose(1, 2),
                        None)
        attention.decode_attention(q, kw, vw, layer, None, lengths=lengths,
                                   **scales)

    def plain(i):
        attention.decode_attention_append_reference(
            q, k_new, v_new, kw, vw, i % n_layers, None, lengths=lengths,
            **scales)

    kd = ((k.float() * ks[..., None]).to(dt) if int8 else k)[
        :, :, :, :width]
    vd = ((v.float() * vs[..., None]).to(dt) if int8 else v)[
        :, :, :, :width]
    mask = (torch.arange(width, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]

    def library(i):  # over the dequantized cache (int8): a yardstick
        F.scaled_dot_product_attention(q, kd[i % n_layers],
                                       vd[i % n_layers], attn_mask=mask,
                                       enable_gqa=hkv != h)

    rec.update(kernel_us=time_graph_us(kernel),
               kernel_eager_us=time_eager_us(kernel),
               old_kernel_us=time_graph_us(old_kernel),
               old_sequence_us=time_graph_us(old_sequence),
               plain_us=time_graph_us(plain),
               library_us=time_graph_us(library),
               library_note="SDPA, boolean mask, no append" + (
                   " over the cache dequantized beforehand (untimed)"
                   if int8 else ""))
    return rec


# ------------------------------------------------- production path

# A second wave of questions beside QUESTIONS: 24 requests in all.
MORE_QUESTIONS = [
    "What is the difference between TCP and UDP?",
    "How does garbage collection work?",
    "Explain recursion with an example.",
    "What is a deadlock?",
]


def paged_waves():
    """Wave 1: 12 bare questions (prompt buckets 32 and 64, cache widths
    160 and 192); wave 2: 12 framed prompts (bucket 256, width 384), so
    their admission widens the live cache mid-decode."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    questions = QUESTIONS + MORE_QUESTIONS
    return questions, [PROMPT_TEMPLATE.format(query=q) for q in questions]


# Phase 4c's wave 2: framed questions behind one shared course context
# (with the template's head, over 200 tokens of the byte tokenizer), all
# inside the 256-token prompt bucket.
COURSE_CONTEXT = ("Distributed systems, CS 451 notes, week 6: Raft keeps a "
                  "replicated log; a leader wins a term by a majority of "
                  "votes.\n")
COURSE_QUESTIONS = [
    "What is a term?", "Why a majority of votes?",
    "What makes a log entry committed?", "How do followers reject a leader?",
    "What is a heartbeat?", "When does an election start?",
    "What happens on a split vote?", "Why must terms only grow?",
]


def deployment_waves():
    """Phase 4c's traffic (24 requests): wave 1 is the first course
    question framed behind COURSE_CONTEXT, then phase 4b's 12 bare
    questions; wave 2 is the other 7 course questions, then 4 exact
    repeats of bare wave-1 questions. Wave 2 is sent once the first course
    prompt's blocks are in the radix tree (see `run_paged_waves`), so the
    course context is prefilled once and spliced into 7 staged slots."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    bare, _ = paged_waves()
    course = [COURSE_CONTEXT + PROMPT_TEMPLATE.format(query=q)
              for q in COURSE_QUESTIONS]
    return course[:1] + bare, course[1:] + bare[:4]


def f32_batches(wave1, wave2):
    """Phase 4c's float32 requests, which phase 7b's float32 spec run
    repeats: 12 of its 24, the 8 course prompts (the first drained alone,
    so the other 7 splice its context) and 4 bare questions."""
    return (wave1[:1], wave1[1:5] + wave2[:len(COURSE_QUESTIONS) - 1])


def engine_tokens(engine, *batches):
    """Submit each batch of prompts at once and drain it before the next;
    return each request's generated token ids in submit order."""
    out = []
    for prompts in batches:
        reqs = []
        for p in prompts:
            engine.submit(p)
            reqs.append(engine._pending[-1])
        engine.drain()
        out += [list(r.tokens) for r in reqs]
    return out


def first_divergence(a, b):
    """Index of the first differing token of two token lists (None if
    equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def run_paged_waves(engine, paged_queue_cls, metrics_cls, wave1, wave2,
                    ready=None):
    """Wave 1 through one PagedQueue; wave 2 submitted once `ready()` is
    true (default: the engine has dispatched wave 1's first decode step).
    Returns (answers in submit order, wall seconds, the queue's metrics
    snapshot)."""
    metrics = metrics_cls()
    if ready is None:
        steps0 = engine.decode_steps

        def ready():
            return engine.decode_steps != steps0

    async def go():
        queue = paged_queue_cls(engine, metrics=metrics)
        await queue.start()
        try:
            first = [asyncio.ensure_future(queue.submit(p)) for p in wave1]
            while not ready():
                await asyncio.sleep(0.002)
            second = [asyncio.ensure_future(queue.submit(p)) for p in wave2]
            return await asyncio.gather(*first, *second)
        finally:
            await queue.close()

    t0 = time.monotonic()
    answers = asyncio.run(go())
    return answers, time.monotonic() - t0, metrics.snapshot()


def device_events(torch, prof):
    """(name, µs) of every device event of a finished `torch.profiler`
    window (`tools/profile_decode.py`'s reader of the raw trace)."""
    from distributed_lms_raft_llm_tpu_torch.tools import profile_decode

    return profile_decode.device_events(torch, prof)


def counted_launches() -> dict:
    """The launch counters summed per route (`engine.graphs.ROUTES`)."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts)
    from distributed_lms_raft_llm_tpu_torch.ops import attention, quant_matmul

    return routes_of_counts({**attention.launch_counts,
                             **quant_matmul.launch_counts})


def int8_want(quant_matmul, calls, dense, experts=0, moe_cfg=None) -> dict:
    """The int8 matmul launches, in all and by route, that bf16 model calls
    make: `calls` pairs (count, rows), each model call running `dense`
    dense products and one unembedding over `rows` token rows and, with
    `experts`, that many expert products at `moe.capacity(moe_cfg, rows)`
    rows an expert. A product takes the wgmma route from WGMMA_MIN_ROWS
    rows (of each expert), the mma.sync one below it; none runs on the
    CUDA cores."""
    qm = quant_matmul
    want = {k: 0 for k in (qm.KERNEL, qm.MMA, qm.MMA_UNEMBED,
                           qm.MMA_EXPERTS, qm.WGMMA, qm.WGMMA_UNEMBED,
                           qm.WGMMA_EXPERTS, qm.FMA, qm.FMA_EXPERTS)}
    for count, rows in calls:
        wide = qm.uses_wgmma(rows)
        want[qm.WGMMA if wide else qm.MMA] += dense * count
        want[qm.WGMMA_UNEMBED if wide else qm.MMA_UNEMBED] += count
        if experts:
            from distributed_lms_raft_llm_tpu_torch.models import moe

            c = moe.capacity(moe_cfg, rows)
            want[qm.WGMMA_EXPERTS if qm.uses_wgmma(c)
                 else qm.MMA_EXPERTS] += experts * count
        want[qm.KERNEL] += (dense + 1 + experts) * count
    return want


def paged_calls(quant_matmul, eng, decode, admission, prefill,
                verify=False) -> list:
    """(count, rows) of a paged engine's model calls: decode calls over its
    slots (verify calls: slots x (spec + 1) rows), admission chunks of
    `prefill_chunk` prompt tokens, prefills over a prompt bucket (every
    bucket on one side of the wgmma crossover, checked, so the prefills'
    routes are exact without their buckets)."""
    sides = {quant_matmul.uses_wgmma(b) for b in eng.buckets}
    check(prefill == 0 or len(sides) == 1,
          f"prompt buckets {eng.buckets} straddle the wgmma crossover")
    rows = eng.slots * (eng.spec + 1 if verify else 1)
    return [(decode, rows), (admission, eng.prefill_chunk),
            (prefill, min(eng.buckets))]


def check_int8_routes(launches, want, what) -> None:
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"{what}: int8 matmul launches by route {got}, want "
          f"{want}")


def check_traced_launches(events, before: dict, what: str) -> dict:
    """The port's kernels the profiler saw on the card, counted by name,
    against the launch counters' deltas over the same window. The trace
    holds no more of them than were counted (a launch the counters missed
    fails here); it may hold fewer, since the profiler on the card loses
    kernel records (`ops/probe_trace_loss.py`), so the shortfall is
    reported as the trace's loss. What a replay adds to the counters is
    held exactly against the graph's kernel nodes at capture
    (`engine/graphs.py`)."""
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_names)

    names: dict = {}
    for name, _ in events:
        names[name] = names.get(name, 0) + 1
    traced = routes_of_names(names)
    after = counted_launches()
    counted = {route: after[route] - before[route] for route in after}
    check(all(traced[r] <= counted[r] for r in counted),
          f"{what}: the profiler trace holds more of the port's kernels "
          f"{traced} than the launch counters counted {counted}")
    return {"traced": traced,
            "lost": {r: counted[r] - traced[r] for r in counted}}


def profile_paged(torch, engine, prompts, steps=2) -> dict:
    """Where a steady paged step's time goes: the slots filled, the
    pipeline full, `steps` step() calls timed without the profiler, then
    `steps` more under `torch.profiler`. Device busy share = summed kernel
    time over the unprofiled wall of the same number of steps."""
    from torch.profiler import ProfilerActivity, profile

    def calls():
        return (engine.decode_steps + engine.prefill_calls
                + engine.admission_chunks)

    for p in prompts:
        engine.submit(p)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    calls0 = calls()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    wall_calls = calls() - calls0
    calls0, replays0 = calls(), engine.graph_replays
    counted0 = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    model_calls, replays = calls() - calls0, engine.graph_replays - replays0
    events = device_events(torch, prof)
    traced = check_traced_launches(events, counted0, "profile window")
    engine.drain()
    by_name: dict = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())

    def of(*parts):
        hits = [v for name, v in by_name.items()
                if any(part in name for part in parts)]
        return sum(us for us, _ in hits), sum(n for _, n in hits)

    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "steps": steps, "chunk": engine.chunk, "slots": engine.slots,
        "wall_us": wall_us, "profiled_wall_us": profiled_wall_us,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_launched": sum(n for _, n in by_name.values()),
        "model_calls": model_calls, "model_calls_unprofiled": wall_calls,
        "graph_replays": replays, "traced_launches": traced,
        "launches_per_model_call": (sum(n for _, n in by_name.values())
                                    / max(model_calls, 1)),
        # the tensor-core kernels (int8_mma_*) and the CUDA-core ones
        "int8_matmul_us_launches": of("int8_mma", "int8_matmul"),
        "decode_attention_us_launches": of("decode_attention"),
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def profile_drain(torch, engine, prompts) -> dict:
    """Device busy share over a whole workload: `prompts` submitted at once
    and drained, first without the profiler (the wall), then again under
    `torch.profiler` (the device time). Greedy decoding and the prefix
    tree cleared before each run make the two runs the same work; model
    calls are counted in both to show it."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        if engine.prefix_cache is not None:
            engine.prefix_cache.clear()
        c0 = (engine.decode_steps + engine.prefill_calls
              + engine.admission_chunks, engine.graph_replays,
              engine.host_decisions, engine.total_generated_tokens)
        for p in prompts:
            engine.submit(p)
        engine.drain()
        torch.cuda.synchronize()
        return (engine.decode_steps + engine.prefill_calls
                + engine.admission_chunks - c0[0],
                engine.graph_replays - c0[1], engine.host_decisions - c0[2],
                engine.total_generated_tokens - c0[3])

    t0 = time.monotonic()
    calls, replays, decisions, tokens = run()
    wall_us = (time.monotonic() - t0) * 1e6
    counted0 = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        calls_p, _, _, _ = run()
        profiled_wall_us = (time.monotonic() - t0) * 1e6
    events = device_events(torch, prof)
    traced = check_traced_launches(events, counted0, "profiled drain")
    busy_us, launched = 0.0, 0
    for _, us in events:
        busy_us += us
        launched += 1
    return {"requests": len(prompts), "tokens": tokens,
            "wall_us": wall_us, "profiled_wall_us": profiled_wall_us,
            "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "model_calls": calls, "model_calls_profiled": calls_p,
            "model_calls_per_token": calls / max(tokens, 1),
            "graph_replays": replays, "host_decisions": decisions,
            "kernels_launched": launched, "traced_launches": traced,
            "launches_per_model_call": launched / max(calls_p, 1)}


def paged_f32_check(torch, attention, engine_cls, config_cls, sampling_cls,
                    common, prompts, kv_quant) -> dict:
    """float32, int8 weights, an int8 (`kv_quant`) or a dense cache: the
    greedy tokens with attention through the kernel equal those through
    the plain attention path, request by request. The kernel run's
    launches of its variant are counted from zero."""
    import torch as _torch

    tokens = {}
    launches = steps = 0
    for fused in (True, False):
        eng = engine_cls(config_cls(
            dtype=_torch.float32, param_dtype=_torch.float32, quant="int8",
            kv_quant=kv_quant, fused_attention=fused,
            sampling=sampling_cls.greedy(max_new_tokens=32), **common),
            slots=16, chunk=16, inflight=3, cuda_graphs=False)
        finished = []
        decode = eng.tokenizer.decode
        eng.tokenizer.decode = lambda toks, _d=decode: (
            finished.append(list(toks)) or _d(toks))
        attention.reset_launch_counts()
        steps0 = eng.decode_steps
        for p in prompts:
            eng.submit(p)
        eng.drain()
        tokens[fused] = finished
        if fused:
            variant = (attention.APPEND_INT8KV if kv_quant
                       else attention.APPEND)
            launches = attention.launch_counts[variant]
            steps = eng.decode_steps - steps0
            others = {n: c for n, c in attention.launch_counts.items()
                      if c and n != variant}
            check(steps > 0 and launches == eng.cfg.num_layers * steps
                  and not others,
                  f"f32 paged run (kv_quant={kv_quant}): {variant} "
                  f"launches {launches} != {eng.cfg.num_layers} x {steps}, "
                  f"or other variants ran: {others}")
        del eng
    check(tokens[True] == tokens[False] and len(tokens[True]) == len(prompts),
          f"float32 paged greedy tokens differ between the kernel and the "
          f"plain attention paths (kv_quant={kv_quant})")
    return {"kv_quant": kv_quant, "equal": True, "requests": len(prompts),
            "tokens": sum(len(t) for t in tokens[True]),
            "launches": launches, "decode_steps": steps}


# ------------------------------------------------------- main path


def run_queue(engine, prompts, batching_queue_cls):
    """8 concurrent submits through one BatchingQueue; returns (answers,
    seconds)."""

    async def go():
        queue = batching_queue_cls(engine, max_batch=len(prompts),
                                   max_wait_ms=100.0)
        await queue.start()
        try:
            return await asyncio.gather(*[queue.submit(p) for p in prompts])
        finally:
            await queue.close()

    t0 = time.monotonic()
    answers = asyncio.run(go())
    return answers, time.monotonic() - t0


def phase5_tokenizer(args, directory: Path) -> tuple:
    """(vocab path, merges path, record) of phase 5's tokenizer, under
    which a random-weight GPT-2's sampled ids show in the text: the given
    --vocab/--merges, else the deployment's trained BPE where
    data/gpt2-local is present, else a full byte-level vocabulary of
    GPT-2's 50,257 ids built from the seed (the byte fallback would drop
    every id >= 256 and leave empty answers to compare)."""
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        BPETokenizer, full_byte_vocab)

    local = REPO / "data" / "gpt2-local"
    if args.vocab and args.merges:
        vocab, merges, which = args.vocab, args.merges, "--vocab/--merges"
    elif (local / "vocab.json").exists() and (local / "merges.txt").exists():
        vocab, merges = str(local / "vocab.json"), str(local / "merges.txt")
        which = "trained BPE, data/gpt2-local"
    else:
        vocab, merges = str(directory / "vocab.json"), str(
            directory / "merges.txt")
        Path(vocab).write_text(json.dumps(full_byte_vocab(50257, args.seed)))
        Path(merges).write_text("#version: 0.2\n")
        which = (f"full byte-level vocabulary from seed {args.seed} (no "
                 f"merges)")
    tok = BPETokenizer.from_files(vocab, merges)
    nonempty = sum(1 for i in range(50257) if tok.decode([i]))
    return vocab, merges, dict(tokenizer=which, vocab_size=tok.vocab_size,
                               ids_decoding_nonempty=nonempty)


def grpc_round_trip(engine, prompt_template) -> dict:
    """One GetLLMAnswer through the port's server on 127.0.0.1, held to the
    engine's direct answer: the same non-empty text and the same number of
    generated tokens (a dropped or extra token changes either)."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
        serve_async,
    )

    query = QUESTIONS[0]
    tok = engine.tokenizer
    ids, mask, _ = engine.encode_prompts([prompt_template.format(query=query)])
    res = engine.generate_ids(ids, mask)
    n = int(res.lengths[0])
    toks = [t for t in res.tokens[0, :n].tolist() if t != tok.eos_id]
    direct = tok.decode(toks).strip()

    async def go():
        server = await serve_async(0, engine, host="127.0.0.1",
                                   node_id="chip-smoke")
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server._port}") as channel:
                stub = rpc.TutoringStub(channel)
                call = stub.GetLLMAnswer(lms_pb2.QueryRequest(query=query),
                                         timeout=300)
                resp = await call
                trailer = dict(list(await call.trailing_metadata()))
            return resp, trailer
        finally:
            await server.stop(1)
            await server._queue.close()

    tok0 = engine.total_generated_tokens
    resp, trailer = asyncio.run(go())
    served = engine.total_generated_tokens - tok0
    check(resp.success and resp.response != "",
          "gRPC GetLLMAnswer returned no answer text")
    check(resp.response == direct and served == n,
          f"gRPC GetLLMAnswer differs from the engine's direct answer "
          f"({served} tokens served, {n} direct)")
    # The comparison can fail: the direct answer less one token that
    # decodes to text reads differently (under the byte-level vocabulary
    # every id does; a trained vocabulary smaller than the model's leaves
    # some ids empty, which the token count catches).
    k = next((i for i, t in enumerate(toks) if tok.decode([t])), None)
    check(k is not None
          and tok.decode(toks[:k] + toks[k + 1:]) != tok.decode(toks),
          "dropping a token leaves the answer's text unchanged")
    check(trailer.get("x-served-by") == "chip-smoke",
          "x-served-by trailer missing")
    return {"success": resp.success, "chars": len(resp.response),
            "tokens": n}


async def http_json(port: int, method: str, path: str, payload=None):
    """(status, JSON body) of one request to a health plane."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, resp = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(resp)


def stream_contract(chunks, start: int = 0) -> str:
    """Offsets monotone and gap-free from `start`, one final chunk, every
    chunk a success; returns the assembled text."""
    check(bool(chunks), "a stream yielded nothing")
    delivered = start
    for ch in chunks:
        check(ch.success and ch.offset == delivered,
              f"stream chunk at offset {ch.offset} after {delivered} "
              f"delivered (success {ch.success})")
        delivered += ch.count
    check([c.final for c in chunks].count(True) == 1 and chunks[-1].final,
          "a stream did not end in exactly one final chunk")
    return "".join(c.text for c in chunks)


def streaming_phase(torch, attention, quant_matmul, engine_cls, config_cls,
                    sampling_cls, prod, vocab, merges) -> dict:
    """Phase 5b: StreamLLMAnswer on the deployment config (phase 4c's) over
    gRPC on 127.0.0.1, under phase 5's tokenizer (see the module
    docstring)."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.engine import PagedQueue, graphs
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        FOLLOWUP_TEMPLATE, PROMPT_TEMPLATE)
    from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
        serve_async)
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    conf = dict(prod, vocab_path=vocab, merges_path=merges)
    eng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=128), **conf),
        **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and cfg.quant_kv
          and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.vocab_size == 50257 and cfg.dtype == torch.bfloat16
          and eng.widths == [160, 192, 256, 384],
          f"streaming: not the deployment configuration: {cfg}")
    warm_s = eng.warmup()
    tok = eng.tokenizer
    queries = list(QUESTIONS)
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in queries]
    # The engine's direct answers (no server), token ids included.
    rids = [eng.submit(p) for p in prompts]
    for rid in rids:
        eng.stream_watch(rid)
    eng.drain()
    finals = eng.pop_final_tokens()
    direct = [finals[r] for r in rids]
    check(all(direct), "streaming: an empty direct answer")
    # Every served run below is under the compile guard (`inventory_guard`).
    serving_guard = contextlib.ExitStack()
    stream_inventory = serving_guard.enter_context(
        inventory_guard(eng, "phase 5b streams"))

    async def serve(body, **kw):
        server = await serve_async(0, eng, host="127.0.0.1",
                                   node_id="chip-smoke-stream", **kw)
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server._port}") as channel:
                return await body(rpc.TutoringStub(channel), server)
        finally:
            await server.stop(1)
            await server._queue.close()

    def gauge(server, name):
        return server._queue.metrics.snapshot()["gauges"].get(name)

    async def unary_run(stub, server):
        t0 = time.monotonic()
        resps = await asyncio.gather(*[stub.GetLLMAnswer(
            lms_pb2.QueryRequest(query=q), timeout=300) for q in queries])
        return (resps, time.monotonic() - t0,
                gauge(server, "host_dispatches_per_token"))

    async def one_stream(stub, query, **kw):
        t0 = time.monotonic()
        chunks, first = [], None
        async for ch in stub.StreamLLMAnswer(
                lms_pb2.StreamRequest(query=query, **kw), timeout=300):
            if first is None:
                first = time.monotonic() - t0
            chunks.append(ch)
        return chunks, first

    async def stream_run(stub, server):
        t0 = time.monotonic()
        streams = await asyncio.gather(*[one_stream(stub, q)
                                         for q in queries])
        wall = time.monotonic() - t0
        hdpt = gauge(server, "host_dispatches_per_token")
        snap = server._queue.metrics.snapshot()
        resumed = []
        for i in (0, 3):
            n = len(direct[i])
            for k in (2, n // 2):
                chunks, _ = await one_stream(stub, queries[i],
                                             resume_offset=k)
                resumed.append((i, k, chunks))
        return streams, wall, hdpt, snap, resumed

    async def queue_run(watched):
        """The 8 prompts through a fresh PagedQueue, all in its inbox
        before its runner starts (the same admissions either way), as
        watched streams or as plain submissions: the queue's host
        dispatches per generated token."""
        eng.reset()  # the megastep controller's K back to its start
        eng.pop_dispatch_stats()  # counts left by earlier work
        metrics = Metrics()
        queue = PagedQueue(eng, metrics=metrics)

        async def consume(prompt):
            return [d async for d in queue.submit_stream(prompt)][-1]

        tasks = [asyncio.ensure_future(consume(p) if watched
                                       else queue.submit(p))
                 for p in prompts]
        await asyncio.sleep(0)
        decisions0, tokens0 = eng.host_decisions, eng.total_generated_tokens
        await queue.start()
        try:
            await asyncio.gather(*tasks)
        finally:
            await queue.close()
        return (metrics.snapshot()["gauges"]["host_dispatches_per_token"],
                (eng.host_decisions - decisions0)
                / (eng.total_generated_tokens - tokens0))

    hdpt_unwatched, decisions_unwatched = asyncio.run(queue_run(False))
    hdpt_watched, decisions_watched = asyncio.run(queue_run(True))
    eng.reset()
    eng.pop_dispatch_stats()
    resps, unary_wall, hdpt_unwatched_grpc = asyncio.run(serve(unary_run))
    eng.reset()
    eng.pop_dispatch_stats()
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
    streams, stream_wall, hdpt_watched_grpc, snap, resumed = asyncio.run(
        serve(stream_run))
    serving_guard.close()
    emit("inventory_5b_streams", **stream_inventory)
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    decode_calls = eng.decode_steps - c0[0]
    model_calls = decode_calls + eng.admission_chunks - c0[1] + (
        eng.prefill_calls - c0[2])
    for i, ((chunks, _), resp) in enumerate(zip(streams, resps)):
        text = tok.decode(direct[i])
        full = stream_contract(chunks)
        check(resp.success and resp.response and full.strip()
              == resp.response == text.strip(),
              f"streaming: stream {i} != unary != direct answer")
        check(chunks[-1].offset + chunks[-1].count == len(direct[i]),
              f"streaming: stream {i} counted "
              f"{chunks[-1].offset + chunks[-1].count} tokens, the direct "
              f"answer {len(direct[i])}")
        check(chunks[-1].digest == hashlib.sha256(
            full.strip().encode()).hexdigest(),
            f"streaming: stream {i}'s digest is not the answer's sha256")
    for i, k, chunks in resumed:
        tail = stream_contract(chunks, start=k)
        want = tok.decode(direct[i])
        check(tail == want[len(tok.decode(direct[i][:k])):]
              and chunks[-1].digest == streams[i][0][-1].digest,
              f"streaming: resume of stream {i} at {k} is not the token "
              f"suffix under the same digest")
    check(decode_calls > 0
          and launches[attention.APPEND_INT8KV]
          == cfg.num_layers * decode_calls,
          f"streaming: kernel launches {launches} for {decode_calls} decode "
          f"and {model_calls} model calls")
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, decode_calls, eng.admission_chunks - c0[1],
        eng.prefill_calls - c0[2]), 48), "streaming")
    check(hdpt_watched <= 1.1 * hdpt_unwatched,
          f"streaming: host dispatches per token {hdpt_watched} watched, "
          f"{hdpt_unwatched} unwatched")
    chunk_counts = [len(c) for c, _ in streams]
    ttfts = [f for _, f in streams]
    run = dict(
        tokens=sum(len(d) for d in direct), warmup_s=warm_s,
        unary_wall_s=unary_wall, stream_wall_s=stream_wall,
        stream_ttft_s=ttfts, stream_ttft_mean_s=sum(ttfts) / len(ttfts),
        engine_ttft_mean_s=snap["latency"]["ttft"]["mean_s"],
        chunks_per_answer=chunk_counts,
        chunks_per_answer_mean=sum(chunk_counts) / len(chunk_counts),
        first_chunk_tokens=[c[0].count for c, _ in streams],
        host_dispatches_per_token_watched=hdpt_watched,
        host_dispatches_per_token_unwatched=hdpt_unwatched,
        host_decisions_per_token_watched=decisions_watched,
        host_decisions_per_token_unwatched=decisions_unwatched,
        host_dispatches_per_token_grpc_streams=hdpt_watched_grpc,
        host_dispatches_per_token_grpc_unary=hdpt_unwatched_grpc,
        resumes=[(i, k, len(c)) for i, k, c in resumed],
        decode_model_calls=decode_calls, model_calls=model_calls,
        launches=launches, inventory=stream_inventory)
    del eng
    torch.cuda.empty_cache()

    # A session on the same config at 8 new tokens: turn 2's prompt holds
    # turn 1's answer as text, which the byte-level vocabulary re-encodes
    # into about six ids a token (random bytes, invalid UTF-8 replaced);
    # a 128-token answer would overflow the 256-id prompt bucket, whose
    # tail is kept, and lose turn 1's head.
    seng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=8), **conf), **deploy_kw)
    captures0 = graphs.captures
    seng.warmup()
    captures1 = graphs.captures
    q1, q2 = QUESTIONS[1], "Why does that matter?"

    async def session_and_drain(stub, server):
        hport = server._health.port
        one, _ = await one_stream(stub, q1, session_id="chip-smoke")
        full1 = stream_contract(one)
        hits0 = (await http_json(hport, "GET", "/metrics"))[1][
            "counters"].get("prefix_cache_hit_tokens", 0)
        two, _ = await one_stream(stub, q2, session_id="chip-smoke")
        stream_contract(two)
        metrics = (await http_json(hport, "GET", "/metrics"))[1]
        transcript = server._service._sessions["chip-smoke"][0]
        drained = await http_json(hport, "POST", "/admin/drain",
                                  {"drain": True})
        health = (await http_json(hport, "GET", "/healthz"))[1]
        codes = []
        for call in (lambda: stub.GetLLMAnswer(
                         lms_pb2.QueryRequest(query=q1), timeout=60),
                     lambda: stub.StreamLLMAnswer(
                         lms_pb2.StreamRequest(query=q1), timeout=60).read()):
            try:
                await call()
                codes.append("OK")
            except grpc.aio.AioRpcError as e:
                codes.append(e.code().name)
        await http_json(hport, "POST", "/admin/drain", {"drain": False})
        again = await stub.GetLLMAnswer(lms_pb2.QueryRequest(query=q1),
                                        timeout=300)
        final_metrics = (await http_json(hport, "GET", "/metrics"))[1]
        return (full1, hits0, metrics, transcript, drained, health, codes,
                again, final_metrics)

    with inventory_guard(seng, "phase 5b session and drain") as inventory:
        (full1, hits0, metrics, transcript, drained, health, codes, again,
         final_metrics) = asyncio.run(serve_session(serve_async, seng,
                                                    session_and_drain))
    emit("inventory_5b_session", **inventory)
    prompt1 = PROMPT_TEMPLATE.format(query=q1)
    prompt2 = prompt1 + full1 + FOLLOWUP_TEMPLATE.format(query=q2)
    ids1, ids2 = tok.encode(prompt1), tok.encode(prompt2)
    check(len(ids2) <= seng.bucket,
          f"session: turn 2's prompt ({len(ids2)} ids) overflows the "
          f"{seng.bucket}-id bucket")
    blk = seng.prefix_cache.block_tokens
    want_hits = len(os.path.commonprefix([ids1, ids2])) // blk * blk
    hits = metrics["counters"].get("prefix_cache_hit_tokens", 0) - hits0
    gauges = metrics["gauges"]
    check(transcript.startswith(prompt2),
          "session: turn 2 was not framed over turn 1's transcript")
    check(want_hits > 0 and hits >= want_hits,
          f"session: turn 2 admitted with {hits} prefix-hit tokens, turn "
          f"1's whole blocks are {want_hits}")
    check(gauges.get("session_active") == 1.0
          and gauges.get("session_pinned_blocks", 0) > 0,
          f"session: gauges {gauges}")
    check(drained[0] == 200 and drained[1]["draining"] is True
          and health["draining"] is True
          and codes == ["UNAVAILABLE", "UNAVAILABLE"],
          f"drain: {drained}, healthz {health}, RPC codes {codes}")
    check(again.success and again.response != "",
          "drain: no answer after the drain ended")
    check(final_metrics["counters"].get("stream_chunks", 0) > 0
          and "ttft" in final_metrics["latency"]
          and "session_active" in final_metrics["gauges"],
          f"/metrics lacks stream_chunks, ttft or session_active: "
          f"{sorted(final_metrics['counters'])}")
    check(captures1 - captures0 == len(seng._graphs) * 2,
          f"session: warmup captured {captures1 - captures0} graphs for "
          f"{len(seng._graphs)} widths")
    run.update(
        session=dict(turn2_prefix_hit_tokens=hits,
                     turn1_whole_block_tokens=want_hits,
                     turn2_prompt_ids=len(ids2),
                     session_active=gauges.get("session_active"),
                     session_pinned_blocks=gauges.get(
                         "session_pinned_blocks")),
        drain=dict(rpc_codes=codes, healthz_draining=health["draining"],
                   answered_after=again.success),
        graph_captures_while_serving=graphs.captures - captures1,
        session_inventory=inventory)
    del seng
    torch.cuda.empty_cache()
    return run


async def serve_session(serve_async, engine, body):
    """`body(stub, server)` against a server with its health plane."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.proto import rpc

    server = await serve_async(0, engine, host="127.0.0.1", metrics_port=0,
                               node_id="chip-smoke-session")
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{server._port}") as channel:
            return await body(rpc.TutoringStub(channel), server)
    finally:
        await server.stop(1)
        await server._queue.close()


def flip_logits_witness(torch, eng, prompts, factor=2.0) -> dict:
    """The fused admission's flip against the cold prefill, in bf16 on an
    idle engine's weights: each prompt's last-position logits through
    `prefill_chunk`-token admission chunks (`_admission_chunk`'s forward:
    M=32 int8 products on the tensor cores, the cache row chosen by
    `rows`, the pad tail masked out of the cache writes) and through one
    cold prefill of its bucket (`_prefill_program`'s forward), each held
    against the cold prefill in float32 on the same int8 weights (the
    CUDA-core int8 route). Holds: the admission route's largest error is
    at most `factor` x the cold route's (a wrong admission-chunk tile
    would err far above the cold route's own bf16 rounding)."""
    import dataclasses

    from distributed_lms_raft_llm_tpu_torch.engine.generate import pick_bucket

    def to_f32(x):
        if isinstance(x, dict):
            return {k: to_f32(v) for k, v in x.items()}
        return x.float() if torch.is_floating_point(x) else x

    cfg, model, c, dev = eng.cfg, eng.family, eng.prefill_chunk, eng.device
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    params32 = to_f32(eng.params)
    per_prompt = []
    with torch.inference_mode():
        for p in prompts:
            toks = eng.tokenizer.encode(p)[-eng.bucket:]  # as submit() cuts
            tl = len(toks)
            bucket = min(pick_bucket(tl, eng.config.length_buckets),
                         eng.bucket)
            width = eng._required_width(tl)
            row = torch.full((1, width), eng.tokenizer.pad_id,
                             dtype=torch.long, device=dev)
            row[0, :tl] = torch.tensor(toks, device=dev)
            steps = torch.arange(bucket, device=dev)

            def cold(params, cfg_):
                kv = model.init_cache(cfg_, 1, bucket, device=dev)
                logits, _ = model.forward(
                    params, cfg_, row[:, :bucket], cache=kv,
                    positions=torch.clamp(steps, max=tl - 1)[None, :],
                    kv_mask=(steps < tl)[None, :])
                return logits[0, tl - 1].float()

            want, got_cold = cold(params32, cfg32), cold(eng.params, cfg)
            kv = model.init_cache(cfg, 1, width, device=dev)
            first_row = torch.zeros((1,), dtype=torch.long, device=dev)
            for cur in range(0, tl, c):
                q = cur + torch.arange(c, device=dev)
                logits, _ = model.forward(
                    eng.params, cfg,
                    row[:, torch.clamp(q, max=width - 1)],
                    cache=dataclasses.replace(
                        kv, lengths=torch.tensor([cur], dtype=torch.int32,
                                                 device=dev),
                        rows=first_row),
                    positions=torch.clamp(torch.minimum(q, torch.tensor(
                        tl - 1, device=dev)), min=0)[None, :],
                    write_mask=((q < tl) & (q < width))[None, :])
            got_chunk = logits[0, tl - 1 - cur].float()
            top2 = torch.topk(want, 2).values
            per_prompt.append(dict(
                tokens=tl, chunks=-(-tl // c),
                err_cold=(got_cold - want).abs().max().item(),
                err_admission=(got_chunk - want).abs().max().item(),
                admission_vs_cold=(got_chunk - got_cold).abs().max().item(),
                scale=want.abs().max().item(),
                top2_margin=(top2[0] - top2[1]).item(),
                argmax_equal=bool(got_chunk.argmax() == got_cold.argmax())))
    err_cold = max(r["err_cold"] for r in per_prompt)
    err_adm = max(r["err_admission"] for r in per_prompt)
    rec = dict(prompts=len(per_prompt), factor=factor, err_cold=err_cold,
               err_admission=err_adm,
               admission_vs_cold=max(r["admission_vs_cold"]
                                     for r in per_prompt),
               scale=max(r["scale"] for r in per_prompt),
               argmax_equal=sum(r["argmax_equal"] for r in per_prompt),
               per_prompt=per_prompt)
    check(math.isfinite(err_adm) and err_adm <= factor * err_cold,
          f"bf16 flip logits through the admission chunks err {err_adm} "
          f"against float32, above {factor} x the cold prefill's {err_cold}")
    return rec


# Kernel names of the torch append that the paged decode step ran before
# the append kernel (models/common.py `write_rows`, `quantize_kv`'s round).
TORCH_APPEND_KERNELS = ("index_put", "round_kernel")


def torch_append_nodes(kernels: dict) -> int:
    """A captured graph's kernel nodes (by name) of the torch append."""
    return sum(n for name, n in kernels.items()
               if any(k in name for k in TORCH_APPEND_KERNELS))


def guard_witness(torch, quant_matmul, eng) -> dict:
    """The compile guard's negative witness on the card: a guarded region
    that captures one more pair of chunk graphs (at the live width, over
    the same planes), and one that runs an int8 product at a layout no
    path ran, must each raise `RecompileError` naming its counter."""
    from distributed_lms_raft_llm_tpu_torch.models import quant
    from distributed_lms_raft_llm_tpu_torch.utils.guards import (
        RecompileError, compile_count_guard, expected_from_inventory)

    gen = torch.Generator(device="cuda").manual_seed(23)
    w = quant.quantize_array(torch.randn((768, 256), generator=gen,
                                         device="cuda") * 0.02)
    x = torch.randn((3, 768), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    regions = (
        ("captures", lambda: eng._capture(eng.state.cache.max_len)),
        ("layouts", lambda: quant_matmul.int8_matmul(x, w["q"], w["s"])),
    )
    out = {}
    for counter, body in regions:
        t0 = time.monotonic()
        raised = None
        try:
            with compile_count_guard(expected_from_inventory(eng),
                                     what=f"witness ({counter})"):
                body()
                torch.cuda.synchronize()
        except RecompileError as exc:
            raised = str(exc)
        out[counter] = dict(raised=raised, ms=1e3 * (time.monotonic() - t0))
        check(raised is not None and f"{counter} +" in raised,
              f"guard witness: a region that moves {counter} did not raise "
              f"RecompileError naming it: {raised}")
    return out


def strict_dispatch_check(torch, eng, prompts) -> dict:
    """`utils/guards.py` on the card: under `strict_dispatch()` the
    deployment engine admits `prompts` (fused staging) and runs its
    megasteps to the end without raising; an unmarked `.item()` of a CUDA
    tensor in the scope raises `HostSyncError`, the same read inside
    `intended_transfer()` does not, nor one on a thread outside the
    scope; the sync debug mode is off again after it."""
    import threading

    from distributed_lms_raft_llm_tpu_torch.utils import guards

    c0 = (eng.admission_chunks, eng.graph_replays, eng.host_decisions,
          eng.total_generated_tokens)
    t0 = time.monotonic()
    with guards.strict_dispatch():
        rids = [eng.submit(p) for p in prompts]
        done = eng.drain()
    served_s = time.monotonic() - t0
    adm, replays, decisions, tokens = (
        eng.admission_chunks - c0[0], eng.graph_replays - c0[1],
        eng.host_decisions - c0[2], eng.total_generated_tokens - c0[3])
    check(set(rids) <= set(done) and tokens >= len(rids) and adm > 0
          and replays > 0,
          f"strict dispatch: the engine did not admit and answer under the "
          f"scope ({len(done)} answers, {tokens} tokens, {adm} admission "
          f"chunks, {replays} replays)")
    x = torch.arange(4, device="cuda", dtype=torch.float32)
    raised = False
    with guards.strict_dispatch():
        try:
            x.sum().item()
        except guards.HostSyncError:
            raised = True
        with guards.intended_transfer():
            marked = x.sum().item()
        other = {}

        def elsewhere():
            try:
                other["value"] = x.sum().item()
            except guards.HostSyncError as e:
                other["error"] = str(e)

        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
    mode = torch.cuda.get_sync_debug_mode()
    check(raised and marked == 6.0 and other == {"value": 6.0} and mode == 0,
          f"strict dispatch: unmarked .item() raised {raised}, marked "
          f"{marked}, another thread {other}, mode after {mode}")
    return dict(requests=len(rids), tokens=tokens, admission_chunks=adm,
                graph_replays=replays, host_decisions=decisions,
                served_s=served_s, unmarked_item_raised=raised,
                marked_item=marked, other_thread=other,
                sync_debug_mode_after=mode)


def approx_topk_check(torch) -> dict:
    """Two nodes' engines from the node's flags (`resolve_args`,
    `engine_from_args`: GPT-2 small, bf16, seeded random weights, the
    reference sampling, 24 new tokens), one with `--approx-topk`: for the
    same seed they sample the same tokens (the port's approximate top-k
    is the exact top-k)."""
    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    t0 = time.monotonic()
    runs = {}
    for name, extra in (("exact", []), ("approx", ["--approx-topk"])):
        args = tutoring_server.resolve_args(
            ["--max-new-tokens", "24", "--seed", "0"] + extra)
        eng = tutoring_server.engine_from_args(args)
        ids, mask, _ = eng.encode_prompts(
            [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS])
        res = eng.generate_ids(ids, mask)
        runs[name] = (eng.config.sampling, res.tokens, res.lengths)
        del eng
    (s0, t_exact, l_exact), (s1, t_approx, l_approx) = (runs["exact"],
                                                         runs["approx"])
    distinct = len(np.unique(t_exact))
    check(not s0.approx_top_k and s1.approx_top_k
          and s0.temperature > 0 and s0.top_k == 50
          and np.array_equal(t_exact, t_approx)
          and np.array_equal(l_exact, l_approx) and distinct > 8,
          f"approx top-k: the --approx-topk node sampled other tokens "
          f"(flags {s0.approx_top_k}/{s1.approx_top_k}, {distinct} "
          f"distinct ids)")
    return dict(requests=len(QUESTIONS), tokens=int(l_exact.sum()),
                distinct_ids=distinct, equal=True,
                seconds=time.monotonic() - t0)


def deployment_phase(torch, attention, quant_matmul, engine_cls, queue_cls,
                     metrics_cls, config_cls, sampling_cls, prod,
                     profile_4b, drain_4b) -> tuple:
    """Phase 4c: the deployment config through `PagedQueue`, its kernel
    routes counted through the graph replays, its profile window beside
    phase 4b's, and its exactness checks (see the module docstring).
    Returns (its record, what phase 7 holds speculation against: the
    answers, the greedy tokens of the same 24 requests in bf16 at 128
    tokens and in float32 at 32, the readings and a decode model call's
    device ms)."""
    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    eng = engine_cls(config_cls(
        sampling=sampling_cls.greedy(max_new_tokens=128), **prod),
        **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and eng.prefill_chunk == 32
          and eng.prefix_cache is not None
          and eng.prefix_cache.max_blocks == 512
          and eng.prefix_cache.block_tokens == 16
          and eng.megastep_ks == [1, 2, 4, 8] and eng.megastep_k == 4
          and cfg.quant_kv and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.dtype == torch.bfloat16
          and eng.widths == [160, 192, 256, 384],
          f"not the deployment configuration: {cfg}, widths {eng.widths}")
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts, routes_of_names)

    warm_s = eng.warmup()
    # Each graph's counted launches beside its kernel nodes by route (the
    # capture raises where the two differ; recorded to show them), its
    # programmatic edges (the append kernel's launch attribute, kept under
    # capture) and its torch append kernels (row writes, quantize_kv's
    # rounding), which the decode chunk no longer runs.
    captured = {w: {kind: {"counted": routes_of_counts(
                               g.captured_launches()),
                           "graph_kernel_nodes": routes_of_names(g.kernels),
                           "all_kernel_nodes": sum(g.kernels.values()),
                           "programmatic_edges": g.programmatic_edges,
                           "torch_append_nodes": torch_append_nodes(
                               g.kernels)}
                    for kind, g in zip(("decode", "admission"), pair)}
                for w, pair in eng._graphs.items()}
    for w, graphs in captured.items():
        dec, adm = graphs["decode"], graphs["admission"]
        appends = dec["counted"]["decode_attention_append"]
        check(appends == cfg.num_layers * eng.chunk
              and dec["programmatic_edges"] == appends
              and dec["torch_append_nodes"] == 0
              and adm["torch_append_nodes"] > 0,
              f"deployment: width {w}'s decode chunk graph holds {appends} "
              f"append kernels ({cfg.num_layers} x {eng.chunk} wanted), "
              f"{dec['programmatic_edges']} programmatic edges and "
              f"{dec['torch_append_nodes']} torch append kernels (the "
              f"admission graph, which still appends in torch: "
              f"{adm['torch_append_nodes']})")
    wave1, wave2 = deployment_waves()
    course = [eng.tokenizer.encode(p)
              for p in wave1[:1] + wave2[:len(COURSE_QUESTIONS) - 1]]
    shared = len(os.path.commonprefix(course))
    lens = [len(t) for t in course]
    check(max(lens) <= eng.bucket,
          f"a course prompt exceeds the prompt bucket: {lens}")
    blk = eng.prefix_cache.block_tokens
    # A staged course slot splices the context's whole blocks (the last
    # prompt token is always prefilled): 7 slots after the first.
    want_hits = (len(course) - 1) * (min(shared, min(lens) - 1) // blk) * blk
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.graph_replays, eng.host_decisions, eng.total_generated_tokens)
    blocks0 = eng.prefix_cache.blocks_used
    # Wave 2 goes once the first course prompt (staged first, so served
    # and flipped first) has published its blocks. The served waves run
    # under the compile guard: no program key, capture, build or layout
    # that warmup did not pay for, and the manifest's key counts exactly.
    with inventory_guard(eng, "phase 4c served waves") as inventory:
        answers, wall, snap = run_paged_waves(
            eng, queue_cls, metrics_cls, wave1, wave2,
            ready=lambda: (eng.prefix_cache.blocks_used - blocks0
                           >= lens[0] // blk))
    emit("inventory", **inventory)
    decode_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    model_calls = decode_calls + adm_calls + eng.prefill_calls - c0[2]
    replays = eng.graph_replays - c0[3]
    decisions = eng.host_decisions - c0[4]
    tokens = eng.total_generated_tokens - c0[5]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    lat, counters, gauges = snap["latency"], snap["counters"], snap["gauges"]
    check(len(answers) == 24 and all(isinstance(a, str) for a in answers),
          "deployment: expected 24 string answers")
    check(counters.get("decode_stalled_tokens", 0) == 0
          and counters.get("prefill_stall_ms", 0) == 0,
          f"deployment: fused admission stalled decode: {counters}")
    check(counters.get("prefix_cache_hit_tokens", 0) >= want_hits,
          f"deployment: prefix-cache hit tokens below the {want_hits} of "
          f"the shared course context in 7 slots: {counters}")
    check(eng.prefill_calls == c0[2] and adm_calls > 0,
          "deployment: admission did not run inside the megasteps")
    check(decode_calls > 0
          and launches[attention.APPEND_INT8KV]
          == cfg.num_layers * decode_calls,
          f"deployment: decode_attention_append_int8kv launches "
          f"{launches[attention.APPEND_INT8KV]} != {cfg.num_layers} x "
          f"{decode_calls} decode model calls (counted through replays)")
    # by route: a decode call's 49 products on the mma.sync tiles (16
    # slots), an admission chunk's 49 (32 prompt tokens) on the wgmma ones
    int8_routes = int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, decode_calls, adm_calls,
        eng.prefill_calls - c0[2]), 48)
    check_int8_routes(launches, int8_routes, "deployment")
    check(all(launches[n] == 0 for n in (
        attention.KERNEL, attention.RAGGED, attention.INT8KV,
        attention.APPEND)),
          "deployment: a one-row attention variant other than the int8 "
          "append kernel ran")
    run = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_max_s=lat["ttft"]["max_s"], decode_model_calls=decode_calls,
        admission_chunks=adm_calls, model_calls=model_calls,
        graph_replays=replays, host_decisions=decisions,
        replays_per_token=replays / tokens,
        host_decisions_per_token=decisions / tokens,
        megastep_k_final=gauges.get("megastep_k"),
        dead_lane_tokens=counters.get("megastep_dead_lane_tokens", 0),
        decode_stalled_tokens=counters.get("decode_stalled_tokens", 0),
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        prefix_hit_rate=gauges.get("prefix_cache_hit_rate"),
        prefix_blocks_used=gauges.get("prefix_cache_blocks_used"),
        shared_context_tokens=shared, course_prompt_tokens=lens,
        prefix_hit_tokens_wanted=want_hits,
        host_dispatches_per_token=gauges.get("host_dispatches_per_token"),
        launches=launches, warmup_s=warm_s, captured=captured,
        inventory=inventory)
    emit("deployment_path", **run)
    prof = profile_paged(torch, eng, wave1[1:] + wave2[:4])
    emit("profile_deployment_step", **prof)
    drain = profile_drain(torch, eng, wave1 + wave2)
    emit("profile_deployment_drain", **drain)
    # Two step() calls are phase 4b's steady window; a megastep of up to 8
    # x 16 tokens can cover a whole answer, so the two windows may hold
    # different work: the drains (the same 24 requests) compare alike.
    emit("profile_busy_share", phase_4b=profile_4b["device_busy_share"],
         phase_4c=prof["device_busy_share"],
         phase_4c_same_window=prof["device_busy_us"]
         / prof["profiled_wall_us"],
         drain_4b=drain_4b["device_busy_share"],
         drain_4c=drain["device_busy_share"],
         launches_per_model_call_4b=profile_4b["launches_per_model_call"],
         launches_per_model_call_4c=prof["launches_per_model_call"])
    run["profile"] = prof
    run["drain"] = drain
    batches = (wave1[:1], wave1[1:] + wave2)
    refs = dict(answers=answers, bf16_tokens=engine_tokens(eng, *batches),
                decode_call_ms=graph_call_ms(torch, eng, eng.widths[-1]),
                tokens_per_s=run["tokens_per_s"],
                ttft_mean_s=run["ttft_mean_s"], ttft_p50_s=run["ttft_p50_s"],
                model_calls_per_token=model_calls / tokens)
    run["decode_call_ms_idle"] = refs["decode_call_ms"]
    run["strict_dispatch"] = strict_dispatch_check(torch, eng, wave2[4:6])
    emit("strict_dispatch", **run["strict_dispatch"])
    run["guard_witness"] = guard_witness(torch, quant_matmul, eng)
    emit("guard_witness", **run["guard_witness"])
    del eng
    torch.cuda.empty_cache()
    run["approx_top_k"] = approx_topk_check(torch)
    emit("approx_top_k", **run["approx_top_k"])

    # float32: the deployment config's greedy tokens equal the sequential
    # config's (megastep 1, no prefix cache, no fused admission),
    # with an int8 and with a dense cache. The first course prompt is
    # drained before the rest are sent, so the deployment config splices
    # the course context into the other 7. In bf16 the two sum prefill
    # products in other orders (a 32-row admission chunk against a whole
    # prompt), so there the share that agrees and where the others
    # diverge are reported, not held; the flip logits witness below holds
    # the admission route to the cold prefill's accuracy instead.
    f32_checks = []
    # The float32 runs take 12 of the 24 requests: the 8 course prompts
    # (their prefix hits) and 4 bare questions.
    batches32 = f32_batches(wave1, wave2)
    for dtype, kv_quant in ((torch.float32, True), (torch.float32, False),
                            (torch.bfloat16, True)):
        toks = {}
        for name, kw in (("deployment", deploy_kw),
                         ("sequential", dict(slots=16, chunk=16, inflight=3,
                                             cuda_graphs=False))):
            e = engine_cls(config_cls(
                sampling=sampling_cls.greedy(max_new_tokens=32),
                **dict(prod, dtype=dtype, param_dtype=dtype,
                       kv_quant=kv_quant)), **kw)
            if e.cuda_graphs:
                e.warmup()
            toks[name] = engine_tokens(
                e, *(batches32 if dtype == torch.float32 else batches))
            if name == "deployment":
                hits = e.pop_prefix_stats()
                if dtype == torch.bfloat16:
                    witness = flip_logits_witness(torch, e, wave1 + wave2)
            del e
        firsts = [first_divergence(a, b) for a, b in
                  zip(toks["deployment"], toks["sequential"])]
        diverged = [i for i, f in enumerate(firsts) if f is not None]
        rec = dict(dtype=str(dtype).split(".")[-1], kv_quant=kv_quant,
                   requests=len(firsts), equal=len(firsts) - len(diverged),
                   tokens=sum(len(t) for t in toks["sequential"]),
                   diverged=diverged,
                   first_divergence=[firsts[i] for i in diverged],
                   prefix_stats=hits)
        check(hits is not None and hits[0] >= want_hits,
              f"{rec['dtype']} deployment run (kv_quant={kv_quant}): prefix "
              f"hit tokens below {want_hits}: {hits}")
        if dtype == torch.bfloat16:
            rec["flip_logits"] = witness
            emit("bf16_deployment_vs_sequential", **rec)
            run["bf16_deployment_vs_sequential"] = rec
            continue
        emit("f32_deployment_vs_sequential", **rec)
        f32_checks.append(rec)
        if kv_quant:
            refs["f32_tokens"] = toks["deployment"]
        check(not diverged,
              f"float32 deployment greedy tokens differ from the "
              f"sequential config's (kv_quant={kv_quant}) at requests "
              f"{diverged}")
    run["f32_checks"] = f32_checks
    torch.cuda.empty_cache()

    # bf16: graph replays at K=4 equal the eager chunk loop (megastep 1,
    # same shapes, no prefix cache, no fused admission), greedy and with
    # the reference sampling from the same seed. 16 requests fill the 16
    # slots at once, so both admit at the same boundary. 64 new tokens
    # (four chunks of 16: one K=4 megastep a request) keep every width's
    # graphs and the comparison at half the decode of 128.
    prompts16 = wave1[1:] + wave2[:4]
    bf16_checks = []
    for name, sampling in (
            ("greedy", sampling_cls.greedy(max_new_tokens=BF16_CHECK_TOKENS)),
            ("sampled", sampling_cls.reference_defaults(
                max_new_tokens=BF16_CHECK_TOKENS))):
        toks = {}
        for mode, kw in (("graphs_k4", dict(megastep=4, megastep_max=4)),
                         ("eager_chunk_loop", dict(cuda_graphs=False))):
            e = engine_cls(config_cls(sampling=sampling, **prod), slots=16,
                           chunk=16, inflight=3, **kw)
            e.warmup()
            toks[mode] = engine_tokens(e, prompts16)
            if mode == "graphs_k4":
                check(e.graph_replays > 0 and e.megastep_k == 4,
                      "bf16 K=4 engine did not replay graphs at K=4")
            del e
        firsts = [first_divergence(a, b) for a, b in
                  zip(toks["graphs_k4"], toks["eager_chunk_loop"])]
        rec = dict(run=name, requests=len(prompts16),
                   equal=sum(f is None for f in firsts),
                   first_divergence=[f for f in firsts if f is not None],
                   tokens=sum(len(t) for t in toks["graphs_k4"]))
        emit("bf16_graphs_vs_eager_chunk_loop", **rec)
        bf16_checks.append(rec)
        check(rec["equal"] == len(prompts16),
              f"bf16 K=4 graph replays differ from the eager chunk loop "
              f"({name}): first divergences {rec['first_divergence']}")
    run["bf16_checks"] = bf16_checks
    torch.cuda.empty_cache()
    return run, refs


# Phase 4c's bf16 graphs-against-eager comparison's new tokens a request.
BF16_CHECK_TOKENS = 64


# ------------------------------------------- phase 6: the relevance gate

GATE_THRESHOLD = 0.6                   # configs/cluster.toml [gate]
GATE_BF16_TOL = TOLERANCE["bfloat16"]  # bf16 similarity vs float32's
GATE_INT8_TOL = 0.05                   # tests/test_quant.py's bound
GATE_CACHE_TOL = 1e-5                  # a float32 hit vs the joint miss
# float32 on the card against float64 on the CPU, of the largest
# magnitude: summation order only. TF32 products keep ~3 decimal digits.
GATE_F64_OF_SCALE = 1e-4
GATE_TIMED_CALLS = 20
GATE_NOTES = ("Distributed systems, CS 451 notes, week 6: Raft keeps a "
              "replicated log consistent across servers. A leader is elected "
              "for a term by a majority of votes, appends client commands to "
              "its log and replicates them to the followers; an entry "
              "commits once a majority stores it. ")


def gate_contexts(tokenizer, buckets) -> dict:
    """Assignment texts by the bucket a miss lands in: words of the course
    notes, as many as fill 7/8 of each length bucket (with [CLS] and
    [SEP]) under the gate's tokenizer; one of 700 tokens, cut at the 512
    positions; and the empty text the LMS passes for an assignment with no
    text."""
    words = (GATE_NOTES * 40).split()

    def sized(target):
        lo, hi = 1, len(words)
        while lo < hi:  # fewest words that reach `target` tokens
            mid = (lo + hi) // 2
            n = len(tokenizer.encode(" ".join(words[:mid]),
                                     add_special_tokens=True))
            lo, hi = (mid + 1, hi) if n < target else (lo, mid)
        return " ".join(words[:lo])

    contexts = {str(b): sized(b - b // 8) for b in buckets}
    contexts["over_512"] = sized(700)
    contexts["empty"] = ""
    return contexts


def to_cpu_f64(torch, tree):
    """A parameter tree of dense tensors, in float64 on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu_f64(torch, v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float64)


def gate_latency(torch, gate, query, contexts) -> dict:
    """`check` latency on the host clock (a check ends in a device-to-host
    copy), p50 and mean over GATE_TIMED_CALLS calls: a miss (the context's
    cache entry dropped before each call, outside the timing) and a hit,
    at each bucket."""
    out = {}
    for label, ctx in contexts.items():
        times = {"miss": [], "hit": []}
        for _ in range(GATE_TIMED_CALLS):
            gate._ctx_cache.pop(ctx, None)
            t0 = time.monotonic()
            gate.check(query, ctx)
            times["miss"].append(time.monotonic() - t0)
        for _ in range(GATE_TIMED_CALLS):
            t0 = time.monotonic()
            gate.check(query, ctx)
            times["hit"].append(time.monotonic() - t0)
        bucket = gate._encode([query, ctx])[0].shape[1]
        out[label] = {"bucket": bucket, **{
            f"{kind}_{stat}_ms": fn(ts) * 1e3 for kind, ts in times.items()
            for stat, fn in (("p50", statistics.median),
                             ("mean", statistics.mean))}}
    return out


def profile_gate(torch, gate, query, ctx, calls=10) -> dict:
    """Where a miss's time goes: `calls` misses timed without the profiler,
    then under `torch.profiler`. Kernels per forward from the trace (a
    lower bound: the profiler on the card loses records), the device busy
    share = summed kernel time over the unprofiled wall, kernel time by
    name; the trace holds no more of the port's kernels than counted."""
    from torch.profiler import ProfilerActivity, profile

    def misses():
        for _ in range(calls):
            gate._ctx_cache.pop(ctx, None)
            gate.check(query, ctx)
        torch.cuda.synchronize()

    misses()
    t0 = time.monotonic()
    misses()
    wall_us = (time.monotonic() - t0) * 1e6
    before = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        misses()
    events = device_events(torch, prof)
    traced = check_traced_launches(events, before, "phase 6 profile")
    by_name: dict = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for _, us in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "bucket": gate._encode([query, ctx])[0].shape[1], "calls": calls,
        "wall_us": wall_us, "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_forward": len(events) / calls,
        "device_us_per_forward": busy_us / calls,
        "traced_port_kernels": traced,
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def gate_phase(torch, attention, quant_matmul, args, streaming) -> dict:
    """Phase 6: the relevance gate at bert-base-uncased width (see the
    module docstring); `streaming` is phase 5's record, for the gate's
    share of a student's wait."""
    import dataclasses

    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig,
        RelevanceGate,
    )
    from distributed_lms_raft_llm_tpu_torch.models import bert

    common = dict(model="bert-base-uncased", checkpoint=args.gate_checkpoint,
                  vocab_path=args.gate_vocab, seed=args.seed,
                  threshold=GATE_THRESHOLD, device="cuda")
    run = {"weights": args.gate_checkpoint or f"seeded random (seed "
           f"{args.seed}), no checkpoint",
           "tokenizer": args.gate_vocab or "byte fallback (no vocab)"}
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls may run on TF32")
    gates = {}
    for name, dtype, quant in (("float32", torch.float32, None),
                               ("bfloat16", torch.bfloat16, None),
                               ("int8", torch.bfloat16, "int8")):
        t0 = time.monotonic()
        gate = RelevanceGate(GateConfig(dtype=dtype, quant=quant, **common))
        cfg = gate.cfg
        check((cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim,
               cfg.vocab_size, cfg.max_position_embeddings)
              == (12, 768, 12, 3072, 30522, 512) and cfg.dtype == dtype
              and gate.config.length_buckets == (64, 128, 256, 512),
              f"gate {name}: not bert-base-uncased at full width: {cfg}")
        wi = gate.params["blocks"]["mlp"]["wi"]
        check((isinstance(wi, dict) and wi["q"].dtype == torch.int8)
              if quant else wi.dtype == dtype,
              f"gate {name}: products not in {quant or dtype}")
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        gate.warmup()
        warm_s = time.monotonic() - t0
        gates[name] = gate
        run[name] = {"load_s": load_s, "warmup_s": warm_s}
    contexts = gate_contexts(gates["float32"].tokenizer, (64, 128, 256, 512))
    query = QUESTIONS[1]
    for name, gate in gates.items():  # the first check after warmup()
        t0 = time.monotonic()
        gate.check(query, contexts["64"])
        run[name]["first_check_ms"] = (time.monotonic() - t0) * 1e3
        gate._ctx_cache.clear()

    # The pairs through each gate, launches counted from zero.
    pairs = [(q, c) for q in QUESTIONS for c in contexts.values()]
    buckets = sorted({gates["float32"]._encode([q, c])[0].shape[1]
                      for q, c in pairs})
    check(buckets == [64, 128, 256, 512],
          f"phase 6 pairs land in buckets {buckets}")
    results = {}
    for name, gate in gates.items():
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        forwards0 = gate.forwards
        results[name] = [gate.check(q, c) for q, c in pairs]
        forwards = gate.forwards - forwards0
        mm = dict(quant_matmul.launch_counts)
        attn = sum(attention.launch_counts.values())
        # a forward's rows, texts x length bucket (64 or more), take the
        # wgmma route
        want = {k: 0 for k in mm}
        if name == "int8":
            want[quant_matmul.KERNEL] = want[quant_matmul.WGMMA] = (
                48 * forwards)
        check(forwards == len(pairs) and mm == want and attn == 0,
              f"gate {name}: int8_matmul launches {mm}, attention {attn}, "
              f"for {forwards} forwards (want {want})")
        run[name].update(forwards=forwards, int8_matmul_launches=mm)
    sims = {name: [s for _, s in res] for name, res in results.items()}
    check(all(math.isfinite(s) and -1.0 - 1e-6 <= s <= 1.0 + 1e-6
              for res in sims.values() for s in res),
          "gate similarities are not finite cosines")
    f32 = sims["float32"]
    bf16_err = max(abs(a - b) for a, b in zip(sims["bfloat16"], f32))
    int8_err = max(abs(a - b) for a, b in zip(sims["int8"], f32))
    clear = [i for i, s in enumerate(f32)
             if abs(s - GATE_THRESHOLD) > GATE_BF16_TOL]
    decisions_equal = all(results["bfloat16"][i][0] == results["float32"][i][0]
                          for i in clear)
    check(bf16_err <= GATE_BF16_TOL,
          f"bf16 gate similarities err {bf16_err} > {GATE_BF16_TOL} "
          "against float32's")
    check(decisions_equal, "bf16 gate decisions differ from float32's away "
          "from the threshold")
    check(int8_err < GATE_INT8_TOL,
          f"int8 gate similarities err {int8_err} >= {GATE_INT8_TOL}")
    run["pairs"] = dict(
        count=len(pairs), buckets=buckets,
        context_tokens={k: len(gates["float32"].tokenizer.encode(
            c, add_special_tokens=True)) for k, c in contexts.items()},
        bf16_max_abs_err=bf16_err, int8_max_abs_err=int8_err,
        bf16_tol=GATE_BF16_TOL, int8_tol=GATE_INT8_TOL,
        decisions_compared=len(clear), decisions_equal=decisions_equal,
        passes={name: sum(p for p, _ in res) for name, res in results.items()},
        sim_range_float32=[min(f32), max(f32)])

    # A cache hit against the joint miss (short query, the widest context).
    cache = {}
    for name, gate in gates.items():
        ctx = contexts["512"]
        emb = gate.embed_texts([query, ctx])
        check(emb.shape == (2, 768) and bool(np.isfinite(emb).all()),
              f"gate {name}: embeddings {emb.shape} not finite")
        joint = float(np.dot(emb[0], emb[1]) / max(float(
            np.linalg.norm(emb[0]) * np.linalg.norm(emb[1])), 1e-12))
        gate._ctx_cache.pop(ctx, None)
        miss = gate.check(query, ctx)[1]
        hit = gate.check(query, ctx)[1]
        tol = GATE_CACHE_TOL if name == "float32" else GATE_BF16_TOL
        check(abs(miss - joint) <= tol and abs(hit - joint) <= tol,
              f"gate {name}: cache hit {hit} / miss {miss} against the "
              f"joint {joint} (tol {tol})")
        cache[name] = dict(joint=joint, miss_err=abs(miss - joint),
                           hit_err=abs(hit - joint), tol=tol)
    run["cache_hit_vs_joint"] = cache

    # float32 on the card against float64 on the CPU: no TF32.
    gate = gates["float32"]
    texts = [query, contexts["128"]]
    ids, mask = gate._encode(texts)
    with torch.inference_mode():
        ref = bert.embed(to_cpu_f64(torch, gate.params),
                         dataclasses.replace(gate.cfg, dtype=torch.float64),
                         torch.as_tensor(ids),
                         attention_mask=torch.as_tensor(mask)).numpy()
    scale = float(np.abs(ref).max())
    f32_err = float(np.abs(gate.embed_texts(texts) - ref).max()) / scale
    torch.backends.cuda.matmul.allow_tf32 = True  # the witness's control
    try:
        tf32_err = float(np.abs(gate.embed_texts(texts) - ref).max()) / scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(f32_err <= GATE_F64_OF_SCALE,
          f"float32 gate errs {f32_err} of scale against float64 (TF32?)")
    run["float32_vs_float64"] = dict(err_of_scale=f32_err,
                                     tf32_err_of_scale=tf32_err,
                                     bound=GATE_F64_OF_SCALE)

    # Latency per bucket, a miss and a hit; the trace of a miss.
    for name, gate in gates.items():
        run[name]["latency"] = gate_latency(torch, gate, query, contexts)
        gate._ctx_cache.clear()
    quant_matmul.reset_launch_counts()
    run["profile"] = {
        f"{name}_{label}": profile_gate(torch, gates[name], query,
                                        contexts[label])
        for name in ("bfloat16", "int8") for label in ("64", "512")}

    # What the gate adds to a student's wait (phase 5's TTFT, same run).
    lat = run["bfloat16"]["latency"]
    ttft = streaming["stream_ttft_mean_s"] * 1e3
    run["beside_phase5"] = dict(
        stream_ttft_mean_ms=ttft,
        engine_ttft_mean_ms=streaming["engine_ttft_mean_s"] * 1e3,
        gate_bf16_miss_p50_ms={k: v["miss_p50_ms"] for k, v in lat.items()},
        gate_bf16_hit_p50_ms=lat["64"]["hit_p50_ms"],
        miss_share_of_stream_ttft={k: v["miss_p50_ms"] / ttft
                                   for k, v in lat.items()},
        hit_share_of_stream_ttft=lat["64"]["hit_p50_ms"] / ttft)
    del gates
    torch.cuda.empty_cache()
    return run


# ------------------------------------ phase 7: speculative decoding

SPEC_TOKENS = 8  # configs/cluster.toml [tutoring] spec_tokens (commented out)
# Of 4c's 24 requests, how many phase 7's exactness, drain, token and
# n-gram runs take (the first course prompt, then the next 11 in order):
# one wave of the 16 slots, not two (phase 11b pays for itself).
SPEC_REQUESTS = 12
# Phase 7 (c)'s profiled drain takes the first of those; (d) and (e) run
# GPT-2 small's width cut to SPEC_CUT_LAYERS layers (their preset
# registered for the phase): the whole script has to leave room for
# phase 14.
SPEC_DRAIN_REQUESTS = 4
SPEC_CUT_LAYERS = 4
SPEC_CUT = "gpt2-4-layers"


def graph_call_ms(torch, eng, width, reps=4) -> float:
    """Device ms of one model call of `eng`'s captured decode (or verify)
    chunk at `width`, by CUDA-event timing of `reps` replays on an idle
    state (every slot inactive at length 0: the products and the whole
    program run, attention reads a key or a window a slot)."""
    graph, _ = eng._graphs[width]
    eng.state = eng._init_state(width)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    eng.reset()
    return start.elapsed_time(end) / (reps * eng.chunk)


def prompt_logits(torch, eng, prompt):
    """One full-sequence forward of `prompt` on `eng`'s weights: its
    logits, [T, V] float32 on the host (under tp every rank runs it)."""
    ids = eng.tokenizer.encode(prompt)[-eng.bucket:]
    with torch.inference_mode():
        logits, _ = eng.family.forward(
            eng.params, eng.cfg, torch.tensor([ids], device=eng.device))
    return logits[0].float().cpu()


def divergence_margin(torch, eng, prompt, toks, i) -> float:
    """top-1 minus top-2 logit where a greedy answer `toks` takes token i:
    one full-sequence forward of the prompt and toks[:i] on `eng`'s
    weights."""
    ids = eng.tokenizer.encode(prompt)[-eng.bucket:] + list(toks[:i])
    with torch.inference_mode():
        logits, _ = eng.family.forward(
            eng.params, eng.cfg, torch.tensor([ids], device=eng.device))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return (top2[0] - top2[1]).item()


def spec_phase(torch, attention, quant_matmul, prod, common, refs, args,
               kernel_cases) -> dict:
    """Phase 7: speculative decoding on the deployment config (see the
    module docstring). `refs` holds phase 4c's answers, its float32 and
    bf16 tokens and its decode call's device ms; `kernel_cases` collects
    the window cases for the kernels line."""
    import grpc

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        PagedQueue,
        SamplingParams,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.spec import verify_width
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_attention
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    k = SPEC_TOKENS
    deploy_kw = dict(slots=16, chunk=16, inflight=3, megastep=4,
                     megastep_max=8, prefix_cache=True,
                     prefix_cache_blocks=512, prefill_chunk_tokens=32)
    run = {}

    # (a) The window kernel against its plain version, row by row, each
    # case with its planted faults caught: T = 2, k + 1 and 16 at widths
    # 384 and 640; the main paths' own shapes follow in (b) and (c). A bf16
    # window runs on the tensor cores, one block a (slot, head, split), so
    # K and V are read once a (slot, head); a float32 one on the CUDA cores.
    cases = []

    def window_case(**kw):
        case = sweep_attention.window_attention_case(**kw)
        emit("window_attention_case", **case)
        bf16 = case["dtype"] == "bfloat16"
        check(case["route"] == ("tensor_cores" if bf16 else "cuda_cores")
              and (not bf16 or case["blocks"]
                   == case["slots"] * 12 * case["n_split"]),
              f"window case on the wrong route or cut: {case}")
        cases.append(case)
        return case

    for int8 in (True, False):
        for t in (2, k + 1, 16):
            for width in (384, 640):
                window_case(s=16, width=width, t=t, int8=int8,
                            seed=width + t + int8)
    run["window_cases"] = cases

    # (b) Exactness. The bucketed engine: spec 8 through the window kernel
    # with the padding bias, bf16 (its launches) and float32 (its tokens
    # equal the plain decoder's). The kernel first, against its plain
    # version at this engine's own rows and cache width, with the bias.
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    bucketed = {}
    for dtype in (torch.bfloat16, torch.float32):
        conf = dict(common, dtype=dtype, param_dtype=dtype,
                    sampling=SamplingParams.greedy(max_new_tokens=32))
        spec_eng = TutoringEngine(EngineConfig(spec_tokens=k, **conf))
        check(spec_eng.cfg.fused_decode_attention,
              "bucketed spec engine without the kernel")
        ids, mask, bucket = spec_eng.encode_prompts(prompts)
        width = verify_width(ids.shape[1], conf["sampling"].max_new_tokens,
                             k)
        name = str(dtype).split(".")[-1]
        case = window_case(s=ids.shape[0], width=width, t=k + 1, int8=False,
                           with_bias=True, dtype=name, seed=11)
        if dtype == torch.bfloat16:
            kernel_cases["bucketed"] = case
        spec_eng.generate_ids(ids[:1], mask[:1])  # first calls, builds
        attention.reset_launch_counts()
        w0 = spec_eng.decode_steps
        got = spec_eng.generate_ids(ids, mask)
        windows = spec_eng.decode_steps - w0
        launched = dict(attention.launch_counts)
        check(windows > 0
              and launched[attention.WINDOW] == 12 * windows
              and launched[attention.KERNEL] == 0,
              f"bucketed spec: window launches {launched} != 12 x "
              f"{windows} verify windows")
        plain = TutoringEngine(EngineConfig(**conf))
        want = plain.generate_ids(ids, mask)
        equal = [bool((got.tokens[i, :got.lengths[i]]
                       == want.tokens[i, :want.lengths[i]]).all()
                      and got.lengths[i] == want.lengths[i])
                 for i in range(len(prompts))]
        bucketed[name] = dict(
            bucket=bucket, rows=ids.shape[0], cache_width=width,
            windows=windows,
            plain_decode_steps=plain.decode_steps,
            window_launches=launched[attention.WINDOW], equal=sum(equal),
            requests=len(prompts),
            tokens_per_window=spec_eng.last_spec_tokens_per_window)
        if dtype == torch.float32:
            check(all(equal), f"float32 bucketed spec tokens differ from "
                  f"the plain decoder's: {equal}")
        del spec_eng, plain
    emit("spec_bucketed", **bucketed)
    run["bucketed"] = bucketed
    main_window_launches = bucketed["bfloat16"]["window_launches"]

    # The float32 deployment with spec 8 against phase 4c's float32
    # deployment (int8 cache) on the same SPEC_REQUESTS requests (a
    # request's float32 tokens do not depend on its companions).
    wave1, wave2 = deployment_waves()
    batches = (wave1[:1], (wave1[1:] + wave2)[:SPEC_REQUESTS - 1])
    e = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=32), spec_tokens=k,
        **dict(prod, dtype=torch.float32, param_dtype=torch.float32)),
        **deploy_kw)
    e.warmup()
    toks32 = engine_tokens(e, *f32_batches(wave1, wave2))
    firsts = [first_divergence(a, b)
              for a, b in zip(toks32, refs["f32_tokens"])]
    f32 = dict(requests=len(firsts), equal=sum(f is None for f in firsts),
               diverged=[i for i, f in enumerate(firsts) if f is not None],
               tokens=sum(len(t) for t in toks32), spec=e.pop_spec_stats())
    emit("spec_f32_vs_deployment", **f32)
    check(f32["equal"] == len(firsts) == SPEC_REQUESTS,
          f"float32 spec deployment differs from the float32 deployment "
          f"without spec at requests {f32['diverged']}")
    run["f32_exactness"] = f32
    del e
    torch.cuda.empty_cache()

    # (c) The bf16 deployment with spec 8 through PagedQueue, as phase 4c.
    eng = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=128), spec_tokens=k,
        **prod), **deploy_kw)
    cfg = eng.cfg
    check(eng.cuda_graphs and eng.fused and eng.spec == k
          and eng.widths == [167, 199, 263, 391] and cfg.quant_kv
          and cfg.dtype == torch.bfloat16 and cfg.num_layers == 12,
          f"not the deployment configuration with spec {k}: {cfg}, "
          f"widths {eng.widths}")
    # The window kernel against its plain version at every cache width of
    # this engine, its slots and window (int8 cache, bf16 q); the widest
    # is the kernels line's.
    for width in eng.widths:
        kernel_cases["int8"] = window_case(s=eng.slots, width=width, t=k + 1,
                                           int8=True, seed=width)
    warm_s = eng.warmup()
    captured = {w: {"counted": routes_of_counts(g.captured_launches()),
                    "graph_kernel_nodes": routes_of_names(g.kernels),
                    "tensor_core_window_nodes": sum(
                        n for name, n in g.kernels.items()
                        if "decode_attention_window_mma_kernel" in name),
                    "all_kernel_nodes": sum(g.kernels.values())}
                for w, (g, _) in eng._graphs.items()}
    # Every window node of a captured graph is the tensor-core kernel (the
    # graph's nodes equal its counted launches route by route, or the
    # capture raised).
    check(all(c["tensor_core_window_nodes"]
              == c["graph_kernel_nodes"]["decode_attention_window"]
              == c["counted"]["decode_attention_window"]
              for c in captured.values())
          and any(c["tensor_core_window_nodes"] for c in captured.values()),
          f"spec deployment: window graph nodes not all on the tensor "
          f"cores: {captured}")
    kernels_per_call = {w: c["all_kernel_nodes"] / eng.chunk
                        for w, c in captured.items()}
    course = [eng.tokenizer.encode(p)
              for p in wave1[:1] + wave2[:len(COURSE_QUESTIONS) - 1]]
    lens = [len(c) for c in course]
    blk = eng.prefix_cache.block_tokens
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.graph_replays, eng.host_decisions, eng.total_generated_tokens)
    blocks0 = eng.prefix_cache.blocks_used
    with inventory_guard(eng, "phase 7c served waves") as inventory:
        answers, wall, snap = run_paged_waves(
            eng, PagedQueue, Metrics, wave1, wave2,
            ready=lambda: (eng.prefix_cache.blocks_used - blocks0
                           >= lens[0] // blk))
    emit("inventory_7c", **inventory)
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    verify_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    model_calls = verify_calls + adm_calls + eng.prefill_calls - c0[2]
    tokens = eng.total_generated_tokens - c0[5]
    lat, counters, gauges = snap["latency"], snap["counters"], snap["gauges"]
    check(len(answers) == 24 and all(isinstance(a, str) for a in answers),
          "spec deployment: expected 24 string answers")
    check(verify_calls > 0
          and launches[attention.WINDOW_INT8KV] == 12 * verify_calls,
          f"spec deployment: decode_attention_window_int8kv launches "
          f"{launches[attention.WINDOW_INT8KV]} != 12 x {verify_calls} "
          f"verify model calls (counted through replays)")
    check(all(launches[n] == 0 for n in (attention.KERNEL, attention.RAGGED,
                                         attention.INT8KV, attention.WINDOW,
                                         attention.APPEND,
                                         attention.APPEND_INT8KV)),
          f"spec deployment: another attention variant ran: {launches}")
    # by route: a verify call's 16 x 9 rows and an admission chunk's 32 on
    # the wgmma tiles
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, verify_calls, adm_calls,
        eng.prefill_calls - c0[2], verify=True), 48), "spec deployment")
    check(counters.get("decode_stalled_tokens", 0) == 0,
          f"spec deployment: admission stalled decode: {counters}")
    tpw = gauges.get("spec_tokens_per_window")
    check(tpw is not None and 1.0 <= tpw <= k + 1,
          f"spec deployment: spec_tokens_per_window {tpw}")
    same = sum(a == b for a, b in zip(answers, refs["answers"]))
    spec_run = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        tokens_per_s_4c=refs["tokens_per_s"],
        ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_mean_s_4c=refs["ttft_mean_s"], ttft_p50_s_4c=refs["ttft_p50_s"],
        spec_tokens_per_window=tpw,
        spec_accepted_tokens=counters.get("spec_accepted_tokens", 0),
        verify_model_calls=verify_calls, admission_chunks=adm_calls,
        model_calls=model_calls, model_calls_per_token=model_calls / tokens,
        model_calls_per_token_4c=refs["model_calls_per_token"],
        host_decisions_per_token=(eng.host_decisions - c0[4]) / tokens,
        graph_replays=eng.graph_replays - c0[3],
        megastep_k_final=gauges.get("megastep_k"),
        dead_lane_tokens=counters.get("megastep_dead_lane_tokens", 0),
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        answers_equal_4c=same, launches=launches,
        inventory=inventory, warmup_s=warm_s,
        kernels_per_verify_call=kernels_per_call)
    emit("spec_deployment_path", **spec_run)
    drain = profile_drain(torch, eng, (batches[0] + batches[1])[
        :SPEC_DRAIN_REQUESTS])
    spec_run["drain"] = drain
    spec_run["device_ms_per_model_call"] = (drain["device_busy_us"] / 1e3
                                            / drain["model_calls_profiled"])
    emit("profile_spec_drain", **drain)
    # Greedy tokens beside phase 4c's (its first SPEC_REQUESTS, 128 tokens):
    # the first divergence of each differing answer, with the top-2 margin
    # of the logits there (a near-tie flips between two orders of sums).
    toks = engine_tokens(eng, *batches)
    windows, emitted = eng.pop_spec_stats()
    diverged = []
    for i, (a, b) in enumerate(zip(toks, refs["bf16_tokens"])):
        j = first_divergence(a, b)
        if j is not None:
            prompt = (batches[0] + batches[1])[i]
            diverged.append(dict(
                request=i, token=j,
                top2_margin=divergence_margin(torch, eng, prompt, b, j)))
    spec_run.update(
        tokens_equal_4c=len(toks) - len(diverged), diverged=diverged,
        verify_call_ms_idle=graph_call_ms(torch, eng, eng.widths[-1]),
        decode_call_ms_idle_4c=refs["decode_call_ms"],
        drain_tokens_per_window=emitted / max(windows, 1))
    emit("spec_vs_deployment", tokens_equal=spec_run["tokens_equal_4c"],
         diverged=diverged, answers_equal=same,
         verify_call_ms_idle=spec_run["verify_call_ms_idle"],
         decode_call_ms_idle_4c=refs["decode_call_ms"],
         device_ms_per_model_call=spec_run["device_ms_per_model_call"],
         busy_share=drain["device_busy_share"])
    run["deployment"] = spec_run
    del eng
    torch.cuda.empty_cache()

    # (d) The n-gram drafter under the reference sampling, at GPT-2
    # small's width cut to SPEC_CUT_LAYERS layers; (e) serves the same cut.
    import functools

    from distributed_lms_raft_llm_tpu_torch.models import gpt2, registry

    registry.PRESETS[SPEC_CUT] = (registry.GPT2_FAMILY, functools.partial(
        gpt2.GPT2Config.small, num_layers=SPEC_CUT_LAYERS))
    cut = dict(prod, model=SPEC_CUT, checkpoint=None)  # seeded weights
    e = PagedEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=128),
        spec_tokens=k, draft_source="ngram", **cut), **deploy_kw)
    check(e.cfg.num_layers == SPEC_CUT_LAYERS and e.cfg.hidden_size == 768,
          f"phase 7 (d): not GPT-2 small's width at {SPEC_CUT_LAYERS} "
          f"layers: {e.cfg}")
    e.warmup()
    attention.reset_launch_counts()
    steps0 = e.decode_steps
    toks = engine_tokens(e, *batches)
    windows, emitted = e.pop_spec_stats()
    ngram = dict(requests=len(toks), nonempty=sum(bool(t) for t in toks),
                 tokens=sum(len(t) for t in toks), windows=windows,
                 tokens_per_window=emitted / max(windows, 1),
                 window_launches=attention.launch_counts[
                     attention.WINDOW_INT8KV],
                 verify_calls=e.decode_steps - steps0,
                 layers=SPEC_CUT_LAYERS)
    emit("spec_ngram_sampled", **ngram)
    check(ngram["nonempty"] == SPEC_REQUESTS and ngram["window_launches"]
          == SPEC_CUT_LAYERS * ngram["verify_calls"],
          f"ngram drafter, reference sampling: {ngram}")
    run["ngram_sampled"] = ngram
    del e
    torch.cuda.empty_cache()

    # (e) gRPC: the server's flags build the spec engine; served greedy
    # under phase 5's tokenizer, 4 unary answers and 4 streams equal the
    # engine's direct answers.
    with tempfile.TemporaryDirectory() as tmp:
        vocab, merges, _ = phase5_tokenizer(args, Path(tmp))
        flags = tutoring_server.build_parser().parse_args([
            "--model", "gpt2", "--paged", "--quant", "int8", "--kv-quant",
            "--slots", "16", "--chunk", "16", "--inflight", "3",
            "--megastep", "4", "--megastep-max", "8", "--prefix-cache",
            "--prefix-cache-blocks", "512", "--prefill-chunk-tokens", "32",
            "--spec-tokens", str(k), "--draft-source", "prompt_lookup",
            "--vocab", vocab, "--merges", merges])
        built = tutoring_server.engine_from_args(flags)
        check(built.spec == k and built.fused and built.cuda_graphs
              and built.config.draft_source == "prompt_lookup",
              "--spec-tokens did not build the spec engine")
        del built
        eng = PagedEngine(EngineConfig(
            sampling=SamplingParams.greedy(max_new_tokens=128),
            spec_tokens=k, **dict(cut, vocab_path=vocab,
                                  merges_path=merges)), **deploy_kw)
        eng.warmup()
        queries = QUESTIONS[:4]
        rids = [eng.submit(PROMPT_TEMPLATE.format(query=q)) for q in queries]
        for rid in rids:
            eng.stream_watch(rid)
        eng.drain()
        finals = eng.pop_final_tokens()
        direct = [eng.tokenizer.decode(finals[r]).strip() for r in rids]
        check(all(direct), "spec gRPC: an empty direct answer")

        async def go():
            server = await tutoring_server.serve_async(
                0, eng, host="127.0.0.1", metrics_port=0,
                node_id="chip-smoke-spec")
            try:
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{server._port}") as channel:
                    stub = rpc.TutoringStub(channel)

                    async def stream(q):
                        return [c async for c in stub.StreamLLMAnswer(
                            lms_pb2.StreamRequest(query=q), timeout=300)]

                    unary = await asyncio.gather(*[stub.GetLLMAnswer(
                        lms_pb2.QueryRequest(query=q), timeout=300)
                        for q in queries])
                    streams = await asyncio.gather(*[stream(q)
                                                     for q in queries])
                _, health = await http_json(server._health.port, "GET",
                                            "/healthz")
                return unary, streams, health
            finally:
                await server.stop(1)
                await server._queue.close()

        with inventory_guard(eng, "phase 7e gRPC") as grpc_inventory:
            unary, streams, health = asyncio.run(go())
        for i, (resp, chunks) in enumerate(zip(unary, streams)):
            full = stream_contract(chunks)
            check(resp.success and resp.response == direct[i]
                  and full.strip() == direct[i],
                  f"spec gRPC: request {i}: unary, stream and direct "
                  f"answers differ")
        check(health.get("spec_tokens") == k
              and health.get("draft_source") == "prompt_lookup",
              f"spec gRPC: /healthz {health}")
        grpc_rec = dict(requests=len(queries), unary_equal=len(queries),
                        streams_equal=len(queries),
                        chunks=[len(c) for c in streams],
                        healthz_spec_tokens=health.get("spec_tokens"),
                        layers=SPEC_CUT_LAYERS, inventory=grpc_inventory)
        emit("spec_grpc", **grpc_rec)
        run["grpc"] = grpc_rec
        del eng
    registry.PRESETS.pop(SPEC_CUT, None)
    torch.cuda.empty_cache()
    run["main_window_launches"] = main_window_launches
    return run


# ------------------------------- phase 8: the bulk-scoring tenant

SCORE_TEXTS, SCORE_TEXT_TOKENS = 128, 48      # the bulk corpus (bench.py's)
INTERACTIVE_ARRIVAL_S = 0.03                  # 24 questions this far apart
# bf16 logprobs through the kernels against the same run with the int8
# matmul's plain version swapped in, per text, relative to |logprob| (tens
# of nats a token at random weights; the two round bf16 products apart).
SCORE_BF16_REL_TOLERANCE = 5e-3
# float32, a text's logprob batched against the same text scored alone
# (the JAX package's pad-invariance tolerance).
SCORE_F32_PAD_RTOL, SCORE_F32_PAD_ATOL = 1e-4, 1e-4


@contextlib.contextmanager
def plain_int8_products(quant_matmul):
    """Both int8 wrappers (the dense and transposed products, and the
    experts') swapped for their plain versions inside the block, for the
    comparisons that hold a path against plain PyTorch."""
    kernels = (quant_matmul.int8_matmul, quant_matmul.int8_matmul_experts)
    quant_matmul.int8_matmul = (
        lambda x, q, s, b=None, transposed=False:
        quant_matmul.int8_matmul_reference(x, q, s, b, transposed))
    quant_matmul.int8_matmul_experts = (
        quant_matmul.int8_matmul_experts_reference)
    try:
        yield
    finally:
        quant_matmul.int8_matmul, quant_matmul.int8_matmul_experts = kernels


def score_corpus(tokenizer, n, tokens, seed) -> list:
    """`n` texts of about `tokens` tokens each (exactly under the byte
    tokenizer): random lowercase words, cut at `tokens` ids."""
    import random

    rng = random.Random(seed)
    out = []
    for _ in range(n):
        words = " ".join(
            "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(2, 9)))
            for _ in range(tokens))
        out.append(tokenizer.decode(tokenizer.encode(words)[:tokens]))
    return out


async def admin_http(port, method, path, body=None):
    """(status, JSON) of one request to a node's admin plane, as the JAX
    package's fleet router sends it."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload or b"null")


def two_tenant_run(torch, tutoring_server, lms_pb2, node_args, engine,
                   queries, corpus, scoring) -> dict:
    """One node on the warmed engine (`serve_args`, the flags resolved from
    the deployment file), 24 interactive questions through its
    `GetLLMAnswer` at INTERACTIVE_ARRIVAL_S, and with `scoring` the bulk
    corpus POSTed to /admin/score first and polled to done (bench.py's
    two-tenant scenario on the node). Returns the run's readings."""
    import argparse

    args = argparse.Namespace(**dict(vars(node_args), scoring=scoring))
    # Both runs start cold: no prefix blocks of the other run's prompts,
    # the megastep controller at its starting rung.
    engine.prefix_cache.clear()
    engine.megastep_k = engine._megastep_initial

    async def run():
        server = await tutoring_server.serve_args(args, engine,
                                                  host="127.0.0.1")
        service, port = server._service, server._health.port
        try:
            tok0 = engine.total_generated_tokens
            t0 = time.monotonic()
            job = None
            if scoring:
                code, job = await admin_http(
                    port, "POST", "/admin/score",
                    {"texts": corpus, "purpose": "grading",
                     "job_id": "phase8"})
                check(code == 200 and job["job_id"] == "phase8",
                      f"phase 8: POST /admin/score answered {code} {job}")
            tasks = []
            for q in queries:
                # The first question too lands 0.03 s in: with the tenant
                # on, while a quantum runs.
                await asyncio.sleep(INTERACTIVE_ARRIVAL_S)
                tasks.append(asyncio.ensure_future(service.GetLLMAnswer(
                    lms_pb2.QueryRequest(query=q), None)))
            answers = await asyncio.gather(*tasks)
            interactive_s = time.monotonic() - t0
            interactive_tokens = engine.total_generated_tokens - tok0
            if scoring:
                while True:
                    code, job = await admin_http(port, "GET",
                                                 "/admin/score/phase8")
                    if code != 200 or job["status"] in ("done", "failed"):
                        break
                    await asyncio.sleep(0.01)
            elapsed = time.monotonic() - t0
            await asyncio.sleep(0.25)  # the watchdog's last heartbeats
            _, health = await admin_http(port, "GET", "/healthz")
            snap = service.metrics.snapshot()
            queue = server._queue
            return dict(
                answers=[a.response for a in answers],
                ok=[a.success for a in answers], job=job, health=health,
                interactive_s=interactive_s, elapsed_s=elapsed,
                interactive_tokens=interactive_tokens,
                ttft_p90_ms=1e3 * (service.metrics.hist("ttft")
                                   .percentile(90) or 0.0),
                ttft_mean_ms=1e3 * snap["latency"]["ttft"]["mean_s"],
                counters=snap["counters"],
                tick_lag=snap["latency"].get("serving_tick_lag", {}),
                quantum_walls=snap["latency"].get("engine_prog_score", {}),
                max_preempt_wait_ms=1e3 * queue.max_preempt_wait_s,
                max_quantum_window_ms=1e3 * queue.max_quantum_window_s,
                scorer=(None if server._scorer is None
                        else server._scorer.stats()))
        finally:
            await server.stop(0)
            await server._queue.close()

    return asyncio.run(run())


def profile_quantum(torch, engine, texts, calls=5) -> dict:
    """Where a quantum's time goes: `calls` quanta (`engine.score` of one
    batch) timed without the profiler, then under `torch.profiler`.
    Kernels per quantum from the trace (a lower bound: the profiler on the
    card loses records), the device busy share = summed kernel time over
    the unprofiled wall, kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    def quanta():
        for _ in range(calls):
            engine.score(texts)
        torch.cuda.synchronize()

    quanta()
    t0 = time.monotonic()
    quanta()
    wall_us = (time.monotonic() - t0) * 1e6
    before = counted_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        quanta()
    events = device_events(torch, prof)
    traced = check_traced_launches(events, before, "phase 8 profile")
    by_name: dict = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    busy_us = sum(us for _, us in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "texts": len(texts), "calls": calls,
        "wall_us_per_quantum": wall_us / calls,
        "device_busy_us_per_quantum": busy_us / calls,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_quantum": len(events) / calls,
        "traced_port_kernels": traced,
        "top": [{"name": name[:90], "us": us, "count": n}
                for name, (us, n) in top],
    }


def scoring_phase(torch, attention, quant_matmul, args) -> dict:
    """Phase 8: the bulk-scoring tenant on the deployment config, the node
    started from configs/cluster.toml (see the module docstring)."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        SamplingParams,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.scoring import (
        ScoringManager)
    from distributed_lms_raft_llm_tpu_torch.ops import build
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server

    # The node's flags from the deployment file; the checkpoint and its
    # vocabulary cannot ride to the card, so seeded random weights and the
    # byte tokenizer unless they are given.
    node_args = tutoring_server.resolve_args([
        "--config", str(REPO / "configs" / "cluster.toml"),
        "--checkpoint", args.checkpoint or "", "--vocab", args.vocab or "",
        "--merges", args.merges or "", "--seed", str(args.seed),
        "--port", "0", "--metrics-port", "0", "--node-id", "phase8"])
    check(node_args.paged and node_args.quant == "int8"
          and node_args.kv_quant and node_args.slots == 16
          and node_args.inflight == 3 and node_args.megastep == 4
          and node_args.megastep_max == 8 and node_args.prefix_cache
          and node_args.prefix_cache_blocks == 512
          and node_args.prefill_chunk_tokens == 32 and node_args.scoring
          and node_args.scoring_max_job_texts == 4096
          and node_args.telemetry,
          f"phase 8: configs/cluster.toml did not resolve to the deployment "
          f"config: {vars(node_args)}")
    eng = tutoring_server.engine_from_args(node_args)
    check(isinstance(eng, PagedEngine) and eng.config.scoring
          and eng.cuda_graphs and eng.fused and eng.cfg.quant_kv
          and eng.cfg.dtype == torch.bfloat16 and eng.cfg.num_layers == 12
          and eng.score_shapes == [(b, t) for b in (1, 2, 4, 8)
                                   for t in (32, 64, 128, 256)],
          f"phase 8: not the deployment engine with the scoring tenant: "
          f"{eng.cfg}, score shapes {eng.score_shapes}")
    t0 = time.monotonic()
    warm_s = eng.warmup()
    score_warm_t0 = time.monotonic()
    eng._warm_score()  # timed alone (warmup ran it once already)
    score_warm_s = time.monotonic() - score_warm_t0
    torch.cuda.synchronize()
    builds0, reserved0 = build.builds, torch.cuda.memory_reserved()
    # From here to (d)'s end the node serves under the compile guard, its
    # score-pairs domain included (`inventory_guard`).
    serving_guard = contextlib.ExitStack()
    inventory = serving_guard.enter_context(
        inventory_guard(eng, "phase 8 tenant and node"))
    corpus = score_corpus(eng.tokenizer, SCORE_TEXTS, SCORE_TEXT_TOKENS,
                          args.seed)
    corpus_tokens = [len(eng.tokenizer.encode(t)) for t in corpus]

    # (a) The first bulk job on the warmed node, the tenant alone: no
    # kernel built, no allocator segment added.
    scorer = ScoringManager(eng)
    scorer.submit(corpus, job_id="alone")
    t_alone = time.monotonic()
    while scorer.run_quantum():
        pass
    torch.cuda.synchronize()
    alone_s = time.monotonic() - t_alone
    alone = scorer.job("alone")
    builds1, reserved1 = build.builds, torch.cuda.memory_reserved()
    check(alone["status"] == "done" and len(alone["results"]) == SCORE_TEXTS,
          f"phase 8: the bulk job alone did not complete: {alone['status']}")
    check(builds1 == builds0 and reserved1 == reserved0,
          f"phase 8: the first bulk job after warmup built {builds1 - builds0}"
          f" kernels and moved memory_reserved {reserved0} -> {reserved1}")

    # (b) One quantum's launches by route, then its time and busy share.
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    eng.score(corpus[:eng.score_batch_cap])
    torch.cuda.synchronize()
    q_launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    # 8 texts x a length bucket of 32 or more: the wgmma route
    check_int8_routes(q_launches, int8_want(quant_matmul, [(1, 8 * 32)], 48),
                      "phase 8 quantum")
    check(not any(attention.launch_counts.values()),
          f"phase 8: a quantum launched attention kernels: {q_launches}")
    quantum_profile = profile_quantum(torch, eng,
                                      corpus[:eng.score_batch_cap])
    emit("scoring_quantum", launches=q_launches, **quantum_profile)

    # (c) The card's scoring saturation: the widest shape (8 x 256) alone.
    long_texts = score_corpus(eng.tokenizer, eng.score_batch_cap, 300,
                              args.seed + 1)
    eng.score(long_texts)
    torch.cuda.synchronize()
    reps, t_sat = 10, time.monotonic()
    scored = sum(r["tokens"] for _ in range(reps)
                 for r in eng.score(long_texts))
    sat_s = time.monotonic() - t_sat
    saturation = dict(shape=[eng.score_batch_cap, 256], reps=reps,
                      tokens=scored, wall_s=sat_s,
                      tokens_per_s=scored / sat_s,
                      ms_per_quantum=1e3 * sat_s / reps)
    emit("scoring_saturation", **saturation)

    # (d) Two tenants on one warmed node, in turns: OFF, ON, ON, OFF (the
    # host's speed drifts within a call).
    queries = QUESTIONS * 3
    runs = {}
    # Whether the engine's stream had finished all its work when each
    # quantum started: the queue starts one only once `has_work` is False,
    # which must mean no dispatch is in flight (inflight 3).
    stream_idle = []
    engine_score = eng.score

    def witnessed_score(texts):
        stream_idle.append(torch.cuda.current_stream().query())
        return engine_score(texts)

    eng.score = witnessed_score
    for name, on in (("off_1", False), ("on_1", True), ("on_2", True),
                     ("off_2", False)):
        runs[name] = two_tenant_run(torch, tutoring_server, lms_pb2,
                                    node_args, eng, queries, corpus, on)
        check(all(runs[name]["ok"]) and len(runs[name]["ok"]) == 24,
              f"phase 8 {name}: an interactive question failed")
    del eng.score
    check(len(stream_idle) == 2 * SCORE_TEXTS // eng.score_batch_cap
          and all(stream_idle),
          f"phase 8: {stream_idle.count(False)} of {len(stream_idle)} "
          f"quanta started while the engine's stream still had work")
    ons = [runs["on_1"], runs["on_2"]]
    offs = [runs["off_1"], runs["off_2"]]
    for name in ("on_1", "on_2"):
        on = runs[name]
        job, stats = on["job"], on["scorer"]
        check(job["status"] == "done" and len(job["results"]) == SCORE_TEXTS
              and stats["jobs_completed"] == 1,
              f"phase 8 {name}: the two-tenant job did not complete: "
              f"{job['status']} {stats}")
        check(stats["quanta_with_pending"] == 0,
              f"phase 8 {name}: {stats['quanta_with_pending']} quanta ran "
              f"while interactive work waited")
        check(0 < on["max_preempt_wait_ms"] <= on["max_quantum_window_ms"],
              f"phase 8 {name}: the first question (0.03 s into the job) "
              f"waited {on['max_preempt_wait_ms']:.2f} ms behind a quantum: "
              f"none, or past the longest quantum "
              f"{on['max_quantum_window_ms']:.2f} ms")
        check(on["health"]["scoring"]["jobs_completed"] == 1,
              f"phase 8 {name}: /healthz scoring block "
              f"{on['health'].get('scoring')}")
        check([r["tokens"] for r in job["results"]]
              == [r["tokens"] for r in alone["results"]],
              f"phase 8 {name}: the two-tenant job's token counts differ "
              f"from the tenant alone's")
    stalls = {k: r["counters"].get("serving_tick_stalls", 0)
              for k, r in runs.items()}
    check(max(stalls["on_1"], stalls["on_2"])
          <= max(stalls["off_1"], stalls["off_2"]),
          f"phase 8: the serving loop stalled more with the tenant on: "
          f"{stalls}")
    check(all("scoring" not in r["health"] for r in offs),
          "phase 8: a node without the tenant reports a scoring block")
    serving_guard.close()
    emit("inventory_8", **inventory)
    check(inventory["programs"]["_score"] == [len(eng.score_shapes)] * 2,
          f"phase 8: the score program's keys {inventory['programs']} are "
          f"not its {len(eng.score_shapes)} score pairs")
    job = runs["on_1"]["job"]

    # (e) bf16 logprobs through the kernels against the int8 matmul's plain
    # version swapped in, on the same engine and texts.
    with plain_int8_products(quant_matmul):
        plain = eng.score(corpus)
    rel = [abs(g["logprob"] - w["logprob"]) / max(abs(w["logprob"]), 1e-9)
           for g, w in zip(job["results"], plain)]
    check(all(math.isfinite(r["logprob"]) for r in job["results"])
          and [r["tokens"] for r in plain]
          == [r["tokens"] for r in job["results"]]
          and max(rel) <= SCORE_BF16_REL_TOLERANCE,
          f"phase 8: bf16 logprobs through the kernels differ from the "
          f"plain version's by {max(rel):.3g} of |logprob| (tolerance "
          f"{SCORE_BF16_REL_TOLERANCE})")
    served = [r["logprob"] for r in job["results"]]
    alone_lp = [r["logprob"] for r in alone["results"]]
    del eng
    torch.cuda.empty_cache()

    # (f) float32 (int8 weights, the CUDA-core route): a text batched
    # equals the text alone.
    f32 = TutoringEngine(EngineConfig(
        model=node_args.model, quant="int8", dtype=torch.float32,
        param_dtype=torch.float32, seed=args.seed, device=node_args.device,
        sampling=SamplingParams.greedy(max_new_tokens=8),
        vocab_path=node_args.vocab or None,
        merges_path=node_args.merges or None,
        checkpoint=node_args.checkpoint or None))
    mixed = [t[:n] for t, n in zip(long_texts, (12, 40, 100, 230))]
    batched = f32.score(mixed)
    f32_err = 0.0
    for text, got in zip(mixed, batched):
        [one] = f32.score([text])
        err = abs(got["logprob"] - one["logprob"])
        f32_err = max(f32_err, err / max(abs(one["logprob"]), 1e-9))
        check(one["tokens"] == got["tokens"]
              and err <= SCORE_F32_PAD_ATOL
              + SCORE_F32_PAD_RTOL * abs(one["logprob"]),
              f"phase 8: float32 batched logprob {got} != alone {one}")
    del f32
    torch.cuda.empty_cache()

    def reading(r):
        scored = r["scorer"]["scored_tokens"] if r["scorer"] else 0
        return dict(
            total_tokens_per_s=(r["interactive_tokens"] + scored)
            / r["elapsed_s"],
            interactive_tokens_per_s=r["interactive_tokens"]
            / (r["interactive_s"] if r["scorer"] else r["elapsed_s"]),
            ttft_p90_ms=r["ttft_p90_ms"], ttft_mean_ms=r["ttft_mean_ms"],
            elapsed_s=r["elapsed_s"], interactive_s=r["interactive_s"],
            interactive_tokens=r["interactive_tokens"], scored_tokens=scored,
            quanta=r["scorer"]["quanta"] if r["scorer"] else 0,
            max_quantum_wall_ms=(r["scorer"]["max_quantum_wall_ms"]
                                 if r["scorer"] else None),
            max_quantum_window_ms=r["max_quantum_window_ms"],
            max_preempt_wait_ms=r["max_preempt_wait_ms"],
            score_preempt_wait_ms=r["counters"].get(
                "score_preempt_wait_ms", 0),
            quantum_walls_ms={k: 1e3 * v for k, v in
                              r["quantum_walls"].items() if k.endswith("_s")},
            quanta_with_pending=(r["scorer"]["quanta_with_pending"]
                                 if r["scorer"] else None))

    readings = {k: reading(r) for k, r in runs.items()}

    def median(side, key):
        return statistics.median(readings[k][key] for k in side)

    on_names, off_names = ("on_1", "on_2"), ("off_1", "off_2")
    total_on = median(on_names, "total_tokens_per_s")
    record = dict(
        metric="paged_score_tenant_total_tokens_per_sec_per_chip",
        value=total_on, unit="tokens/sec/chip",
        total_tokens_per_s_off=median(off_names, "total_tokens_per_s"),
        total_tokens_per_s_on=total_on,
        interactive_tokens_per_s_off=median(off_names,
                                            "interactive_tokens_per_s"),
        interactive_tokens_per_s_on=median(on_names,
                                           "interactive_tokens_per_s"),
        ttft_p90_ms_off=median(off_names, "ttft_p90_ms"),
        ttft_p90_ms_on=median(on_names, "ttft_p90_ms"),
        quanta=readings["on_1"]["quanta"],
        scored_tokens=readings["on_1"]["scored_tokens"],
        max_quantum_wall_ms=max(readings[k]["max_quantum_wall_ms"]
                                for k in on_names),
        max_preempt_wait_ms=max(readings[k]["max_preempt_wait_ms"]
                                for k in on_names),
        quanta_with_pending=sum(readings[k]["quanta_with_pending"]
                                for k in on_names),
        runs=readings, serving_tick_stalls=stalls,
        quanta_started_on_an_idle_stream=sum(stream_idle),
        serving_tick_lag_max_ms={k: 1e3 * r["tick_lag"].get("max_s", 0.0)
                                 for k, r in runs.items()},
        corpus_texts=SCORE_TEXTS, corpus_tokens_mean=statistics.mean(
            corpus_tokens),
        tenant_alone_s=alone_s,
        tenant_alone_tokens_per_s=alone["scored_tokens"] / alone_s,
        quantum_launches=q_launches, quantum=quantum_profile,
        saturation=saturation, warmup_s=warm_s, score_warm_s=score_warm_s,
        builds_after_warmup=build.builds - builds0, inventory=inventory,
        memory_reserved_bytes=reserved0,
        memory_reserved_after_job_bytes=reserved1,
        bf16_vs_plain_max_rel=max(rel),
        bf16_vs_plain_tolerance=SCORE_BF16_REL_TOLERANCE,
        served_vs_alone_max_abs=max(abs(a - b)
                                    for a, b in zip(served, alone_lp)),
        f32_batched_vs_alone_max_rel=f32_err,
        node_config=str(REPO / "configs" / "cluster.toml"))
    emit("scoring_tenant", **{k: v for k, v in record.items()
                              if k not in ("quantum", "saturation", "runs")})
    for name, r in readings.items():
        emit("scoring_two_tenant_run", run=name, **r)
    return record


# ------------------------------------------- phase 9: Llama-3-8B

LLAMA = "llama3-8b"          # models/registry.py; Meta-Llama-3-8B's shape
LLAMA_WITNESS_LAYERS = 4     # the float32 witness's depth (of 32)
LLAMA_WITNESS = "llama3-8b-4-layers"  # its preset, registered by phase 9
LLAMA_DENSE = ("llama.wq", "llama.wk", "llama.wv", "llama.wo", "llama.wg",
               "llama.wu", "llama.wd")
LLAMA_DENSE_ROWS = (16, 32, 512, 2048)  # decode, admission, score quanta
LLAMA_UNEMBED_ROWS = (16, 512)
# The spec-8 run's requests, of QUESTIONS: a verify call takes ~42 ms, so
# 4 keep the whole script near half its time limit.
LLAMA_SPEC_REQUESTS = 4
# Phase 9's spec-8 run is cut to this depth (of 32; full width), its
# preset registered for the run: the whole script has to leave room for
# phase 13's semester and phase 16's trainer.
LLAMA_SPEC_LAYERS = 4
LLAMA_SPEC = "llama3-8b-4-layers-spec"


def llama_kernel_cases(torch, attention, quant_matmul) -> dict:
    """Phase 9 (a): each kernel of the Llama path against its plain version
    at Llama-3-8B's shapes, timed beside its bound and library call (each
    helper raises where the kernel disagrees beyond its tolerance)."""
    from distributed_lms_raft_llm_tpu_torch.ops import (
        sweep_attention,
        sweep_int8,
    )

    mm = []
    for name in LLAMA_DENSE:
        for m in LLAMA_DENSE_ROWS:
            mm.append(sweep_int8.int8_matmul_case(name=name, m=m,
                                                  dtype="bfloat16"))
            emit("llama_int8_matmul_case", **mm[-1])
    for m in LLAMA_UNEMBED_ROWS:
        mm.append(sweep_int8.int8_matmul_case(name="llama.lm_head", m=m,
                                              dtype="bfloat16"))
        emit("llama_int8_matmul_case", **mm[-1])
    for case in mm:
        k, n, transposed = sweep_int8.PRODUCTS[case["name"]]
        case["x_staged"] = quant_matmul.launch_plan(
            case["m"], k, n, transposed).x_staged
    check(all(c["x_staged"] == (c["name"] == "llama.lm_head"
                                or (c["name"] == "llama.wd" and c["m"] > 16))
              for c in mm),
          "phase 9: the deep products did not take the x-staged plans")
    # The paged step's append kernel at 16 slots, 32 query heads over 8 KV
    # heads of 128, lengths over [1, 384] (the widest paged width), int8
    # and bf16 caches; the verify window (T = 9) over the int8 cache at the
    # spec deployment's widest width; the bucketed kernel, batch 8.
    append = [append_attention_case(torch, attention, s=16, width=384,
                                    cache=cache, h=32, hkv=8, dh=128,
                                    seed=90 + i)
              for i, cache in enumerate(("int8", "bfloat16"))]
    for case in append:
        emit("llama_append_attention_case", **case)
    window = sweep_attention.window_attention_case(
        s=16, width=391, t=9, int8=True, h=32, hkv=8, dh=128, seed=93)
    emit("llama_window_attention_case", **window)
    check(window["route"] == "tensor_cores"
          and window["blocks"] == 16 * 8 * window["n_split"],
          f"phase 9: the window ran on the wrong route or cut: {window}")
    bucketed = attention_case(torch, attention, b=8, h=32, hkv=8, s=384,
                              dh=128, strided_q=True, seed=94)
    emit("llama_attention_case", **bucketed)
    return dict(int8_matmul=mm, append=append, window=window,
                bucketed=bucketed)


def llama_witness(torch, attention, quant_matmul, args) -> dict:
    """Phase 9 (b): float32 at full width, cut to LLAMA_WITNESS_LAYERS
    layers: the paged engine with int8 weights and an int8 KV cache gives
    the same greedy tokens on 8 prompts with fused attention off (plain
    attention), on (the append kernel) and on with spec 8 (the window
    kernel); every int8 product on the float32 CUDA-core route."""
    import functools

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        SamplingParams,
    )
    from distributed_lms_raft_llm_tpu_torch.models import llama, registry
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    registry.PRESETS[LLAMA_WITNESS] = (registry.LLAMA_FAMILY, functools.partial(
        llama.LlamaConfig.llama3_8b, num_layers=LLAMA_WITNESS_LAYERS))
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    base = dict(model=LLAMA_WITNESS, quant="int8", kv_quant=True,
                dtype=torch.float32, param_dtype=torch.float32,
                seed=args.seed, device="cuda",
                sampling=SamplingParams.greedy(max_new_tokens=32))
    toks, runs = {}, {}
    try:
        for name, kw in (("plain", dict(fused_attention=False)),
                         ("fused", dict(fused_attention=True)),
                         ("fused_spec8", dict(fused_attention=True,
                                              spec_tokens=SPEC_TOKENS))):
            eng = PagedEngine(EngineConfig(**base, **kw), slots=8, chunk=16,
                              inflight=3, cuda_graphs=False)
            cfg = eng.cfg
            check(cfg.hidden_size == 4096 and cfg.num_heads == 32
                  and cfg.num_kv_heads == 8 and cfg.vocab_size == 128256
                  and cfg.intermediate_size == 14336
                  and cfg.num_layers == LLAMA_WITNESS_LAYERS
                  and cfg.dtype == torch.float32 and cfg.quant_kv
                  and isinstance(eng.params["lm_head"], dict),
                  f"phase 9 witness: not Llama-3-8B's width in float32 "
                  f"with int8 weights and KV: {cfg}")
            attention.reset_launch_counts()
            quant_matmul.reset_launch_counts()
            calls0 = (eng.decode_steps, eng.prefill_calls)
            toks[name] = engine_tokens(eng, prompts)
            decode = eng.decode_steps - calls0[0]
            model = decode + eng.prefill_calls - calls0[1]
            launches = {**attention.launch_counts,
                        **quant_matmul.launch_counts}
            runs[name] = dict(decode_model_calls=decode, model_calls=model,
                              tokens=sum(len(t) for t in toks[name]),
                              launches={k: v for k, v in launches.items()
                                        if v})
            products = 7 * LLAMA_WITNESS_LAYERS + 1
            check(launches[quant_matmul.FMA] == products * model
                  and launches[quant_matmul.KERNEL] == products * model,
                  f"phase 9 witness {name}: int8 launches {launches} != "
                  f"{products} x {model} model calls on the CUDA cores")
            want = {"plain": {}, "fused": {
                attention.APPEND_INT8KV: LLAMA_WITNESS_LAYERS * decode},
                    "fused_spec8": {
                attention.WINDOW_INT8KV: LLAMA_WITNESS_LAYERS * decode}}
            got = {k: v for k, v in launches.items()
                   if k in attention.launch_counts and v}
            check(decode > 0 and got == want[name],
                  f"phase 9 witness {name}: attention launches {got} != "
                  f"{want[name]}")
            del eng
            torch.cuda.empty_cache()
    finally:
        registry.PRESETS.pop(LLAMA_WITNESS, None)
    firsts = {name: [first_divergence(a, b)
                     for a, b in zip(toks[name], toks["plain"])]
              for name in ("fused", "fused_spec8")}
    rec = dict(layers=LLAMA_WITNESS_LAYERS, requests=len(prompts),
               equal={n: sum(f is None for f in fs)
                      for n, fs in firsts.items()},
               first_divergence={n: [f for f in fs if f is not None]
                                 for n, fs in firsts.items()},
               runs=runs)
    emit("llama_f32_witness", **rec)
    check(all(v == len(prompts) for v in rec["equal"].values()),
          f"phase 9 witness: float32 greedy tokens differ between plain, "
          f"fused and spec 8: {rec['first_divergence']}")
    return rec


def llama_node(tutoring_server, args, *extra, model=LLAMA):
    """The node's flags from configs/cluster.toml with `model` set to
    llama3-8b (or a registered cut of it): seeded random weights and the
    byte tokenizer (the real checkpoint and tokenizer.json cannot ride to
    the card)."""
    node_args = tutoring_server.resolve_args([
        "--config", str(REPO / "configs" / "cluster.toml"),
        "--model", model, "--checkpoint", "", "--vocab", "", "--merges", "",
        "--seed", str(args.seed), "--port", "0", *extra])
    check(node_args.model == model and node_args.paged
          and node_args.quant == "int8" and node_args.kv_quant
          and node_args.slots == 16 and node_args.chunk == 16
          and node_args.inflight == 3 and node_args.megastep == 4
          and node_args.megastep_max == 8 and node_args.prefix_cache
          and node_args.prefix_cache_blocks == 512
          and node_args.prefill_chunk_tokens == 32
          and node_args.max_new_tokens == 128,
          f"phase 9: configs/cluster.toml did not resolve to the deployment "
          f"config: {vars(node_args)}")
    return node_args


def int8_weight_bytes(params, lookup) -> int:
    """Bytes a decode model call must read of an int8 tree: every int8
    product weight and its scales once, every dense leaf (the norm scales,
    biases, a router), but the table at path `lookup`, of which the call
    looks up 16 rows (Llama's embedding; GPT-2's position table)."""
    total = 0

    def walk(tree, path=()):
        nonlocal total
        if path == lookup:
            return
        if isinstance(tree, dict) and set(tree) == {"q", "s"}:
            total += tree["q"].numel() + 4 * tree["s"].numel()
            return
        if isinstance(tree, dict):
            for key, value in tree.items():
                walk(value, path + (key,))
            return
        total += tree.numel() * tree.element_size()

    walk(params)
    return total


def llama_deployment(torch, attention, quant_matmul, args) -> tuple:
    """Phase 9 (c) and (d): the deployment config at full depth (see the
    module docstring). Returns (its record, its launches)."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        PagedQueue,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )
    from distributed_lms_raft_llm_tpu_torch.ops.sweep_int8 import (
        H100_HBM_BYTES_PER_S,
    )
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    node_args = llama_node(tutoring_server, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = tutoring_server.engine_from_args(node_args)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    cfg = eng.cfg
    check(isinstance(eng, PagedEngine) and eng.cuda_graphs and eng.fused
          and cfg.num_layers == 32 and cfg.hidden_size == 4096
          and cfg.num_heads == 32 and cfg.num_kv_heads == 8
          and cfg.head_dim == 128 and cfg.intermediate_size == 14336
          and cfg.vocab_size == 128256 and cfg.rope_theta == 500000.0
          and cfg.dtype == torch.bfloat16 and cfg.quant_kv
          and isinstance(eng.params["lm_head"], dict)
          and eng.state.cache.k.dtype == torch.int8
          and eng.state.cache.k.shape[2] == 8
          and eng.slots == 16 and eng.prefill_chunk == 32
          and eng.megastep_ks == [1, 2, 4, 8]
          and eng.prefix_cache.max_blocks == 512
          and eng.widths == [160, 192, 256, 384] and eng.config.scoring,
          f"phase 9: not Llama-3-8B on the deployment config: {cfg}, "
          f"widths {eng.widths}")
    weight_bytes = int8_weight_bytes(eng.params, ("embed",))
    t0 = time.monotonic()
    warm_s = eng.warmup()
    captured = {}
    for w, (dec, adm) in eng._graphs.items():
        counted = routes_of_counts(dec.captured_launches())
        captured[w] = dict(
            decode_counted=counted,
            decode_kernel_nodes=routes_of_names(dec.kernels),
            decode_all_kernel_nodes=sum(dec.kernels.values()),
            admission_all_kernel_nodes=sum(adm.kernels.values()),
            programmatic_edges=dec.programmatic_edges)
        check(counted["decode_attention_append"] == 32 * eng.chunk
              == dec.programmatic_edges
              and counted["int8_matmul_mma"] == 224 * eng.chunk
              and counted["int8_matmul_mma_unembed"] == eng.chunk,
              f"phase 9: width {w}'s decode chunk graph: {captured[w]}")
    kernels_per_call = (captured[eng.widths[-1]]["decode_all_kernel_nodes"]
                        / eng.chunk)
    # Logits of a full-width forward: finite, the vocabulary's width.
    with torch.inference_mode():
        ids = torch.tensor([eng.tokenizer.encode(q)[:8] for q in
                            QUESTIONS[:2]], device=eng.device)
        logits, _ = eng.family.forward(eng.params, cfg, ids)
    check(tuple(logits.shape) == (2, 8, 128256)
          and bool(torch.isfinite(logits).all()),
          "phase 9: full-width logits are not finite [2, 8, 128256]")
    del logits

    wave1 = list(QUESTIONS)
    wave2 = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.graph_replays, eng.total_generated_tokens)
    answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics, wave1,
                                          wave2)
    decode_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    model_calls = decode_calls + adm_calls + eng.prefill_calls - c0[2]
    tokens = eng.total_generated_tokens - c0[4]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    lat, counters = snap["latency"], snap["counters"]
    check(len(answers) == 16 and all(isinstance(a, str) for a in answers),
          "phase 9: expected 16 string answers")
    check(decode_calls > 0 and adm_calls > 0
          and launches[attention.APPEND_INT8KV] == 32 * decode_calls,
          f"phase 9: append-kernel launches "
          f"{launches[attention.APPEND_INT8KV]} != 32 x {decode_calls} "
          f"decode model calls")
    # by route: decode calls (16 slots) on the mma.sync tiles, admission
    # chunks (32 tokens) on the wgmma ones
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, decode_calls, adm_calls,
        eng.prefill_calls - c0[2]), 224), "phase 9")
    check(all(launches[n] == 0 for n in (
        attention.KERNEL, attention.RAGGED, attention.INT8KV,
        attention.APPEND, attention.WINDOW, attention.WINDOW_INT8KV)),
          "phase 9: an attention variant other than the int8 append ran")
    width = eng.widths[-1]
    call_ms = graph_call_ms(torch, eng, width)
    # The KV cache a decode call reads at the widest width, every slot
    # full: int8 K and V and their float32 scales.
    kv_bytes = 32 * 16 * 8 * width * (2 * 128 + 2 * 4)
    bound_ms = weight_bytes / H100_HBM_BYTES_PER_S * 1e3
    run = dict(
        init_s=init_s, warmup_s=warm_s, requests=16, wall_s=wall,
        tokens=tokens, tokens_per_s=tokens / wall,
        ttft_p50_s=lat["ttft"]["p50_s"], ttft_p90_s=lat["ttft"]["p90_s"],
        ttft_mean_s=lat["ttft"]["mean_s"], decode_model_calls=decode_calls,
        admission_chunks=adm_calls, model_calls=model_calls,
        decode_call_ms_idle=call_ms, weight_bytes=weight_bytes,
        weight_bound_ms=bound_ms, kv_bytes_full_width=kv_bytes,
        kv_bound_ms_full_width=kv_bytes / H100_HBM_BYTES_PER_S * 1e3,
        kernels_per_decode_call=kernels_per_call,
        launches={k: v for k, v in launches.items() if v},
        launches_per_decode_call={
            "decode_attention_append_int8kv":
                launches[attention.APPEND_INT8KV] / decode_calls,
            "int8_matmul_mma": 224, "int8_matmul_mma_unembed": 1},
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        decode_stalled_tokens=counters.get("decode_stalled_tokens", 0),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        captured=captured)
    emit("llama_deployment", **{k: v for k, v in run.items()
                                if k != "captured"})

    # (d) One scoring quantum, 8 texts at the 256 bucket (M = 2,048),
    # through the kernels and against the int8 matmul's plain version.
    texts = score_corpus(eng.tokenizer, 8, 300, args.seed)
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = eng.score(texts)
    quantum_s = time.monotonic() - t0
    q_launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    check_int8_routes(q_launches, int8_want(quant_matmul, [(1, 8 * 256)],
                                            224), "phase 9 quantum")
    check(sum(attention.launch_counts.values()) == 0,
          f"phase 9: a quantum launched attention kernels: {q_launches}")
    with plain_int8_products(quant_matmul):
        plain = eng.score(texts)
    rel = [abs(g["logprob"] - w["logprob"]) / max(abs(w["logprob"]), 1e-9)
           for g, w in zip(got, plain)]
    check(all(r["truncated"] and r["tokens"] == 255 for r in got)
          and all(math.isfinite(r["logprob"]) for r in got)
          and [r["tokens"] for r in got] == [r["tokens"] for r in plain]
          and max(rel) <= SCORE_BF16_REL_TOLERANCE,
          f"phase 9: the 8 x 256 quantum's bf16 logprobs differ from the "
          f"plain version's by {max(rel):.3g} of |logprob| (tolerance "
          f"{SCORE_BF16_REL_TOLERANCE}), or its texts were not 256 tokens")
    run["score_quantum"] = dict(texts=8, bucket=256, rows=2048,
                                wall_s=quantum_s, launches={
                                    k: v for k, v in q_launches.items() if v},
                                bf16_vs_plain_max_rel=max(rel),
                                tolerance=SCORE_BF16_REL_TOLERANCE)
    emit("llama_score_quantum", **run["score_quantum"])
    del eng
    torch.cuda.empty_cache()
    return run, launches


def llama_spec(torch, attention, quant_matmul, args) -> tuple:
    """Phase 9 (c), its short spec-8 run: the deployment config at full
    width cut to LLAMA_SPEC_LAYERS layers with spec_tokens 8 (prompt
    lookup), LLAMA_SPEC_REQUESTS requests through PagedQueue. Returns
    (its record, its launches)."""
    import functools

    from distributed_lms_raft_llm_tpu_torch.engine import PagedQueue
    from distributed_lms_raft_llm_tpu_torch.models import llama, registry
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    registry.PRESETS[LLAMA_SPEC] = (registry.LLAMA_FAMILY, functools.partial(
        llama.LlamaConfig.llama3_8b, num_layers=LLAMA_SPEC_LAYERS))
    try:
        return _llama_spec_run(torch, attention, quant_matmul, args,
                               tutoring_server, PagedQueue, Metrics)
    finally:
        registry.PRESETS.pop(LLAMA_SPEC, None)


def _llama_spec_run(torch, attention, quant_matmul, args, tutoring_server,
                    PagedQueue, Metrics) -> tuple:
    layers = LLAMA_SPEC_LAYERS
    node_args = llama_node(tutoring_server, args, "--spec-tokens",
                           str(SPEC_TOKENS), model=LLAMA_SPEC)
    eng = tutoring_server.engine_from_args(node_args)
    check(eng.spec == SPEC_TOKENS and eng.cfg.num_layers == layers
          and eng.cfg.hidden_size == 4096 and eng.cfg.vocab_size == 128256
          and eng.widths == [167, 199, 263, 391],
          f"phase 9: not the spec-8 deployment cut to {layers} layers: "
          f"spec {eng.spec}, widths {eng.widths}, {eng.cfg}")
    warm_s = eng.warmup()
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.total_generated_tokens)
    answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics,
                                          QUESTIONS[:LLAMA_SPEC_REQUESTS],
                                          [])
    verify_calls = eng.decode_steps - c0[0]
    model_calls = (verify_calls + eng.admission_chunks - c0[1]
                   + eng.prefill_calls - c0[2])
    tokens = eng.total_generated_tokens - c0[3]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    check(len(answers) == LLAMA_SPEC_REQUESTS and verify_calls > 0
          and launches[attention.WINDOW_INT8KV] == layers * verify_calls,
          f"phase 9 spec 8: launches {launches} for {verify_calls} verify "
          f"and {model_calls} model calls ({layers} windows a verify call)")
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, verify_calls, eng.admission_chunks - c0[1],
        eng.prefill_calls - c0[2], verify=True), 7 * layers),
        "phase 9 spec 8")
    run = dict(warmup_s=warm_s, requests=LLAMA_SPEC_REQUESTS, wall_s=wall,
               layers=layers,
               tokens=tokens,
               tokens_per_s=tokens / wall,
               ttft_p50_s=snap["latency"]["ttft"]["p50_s"],
               verify_model_calls=verify_calls, model_calls=model_calls,
               spec_tokens_per_window=snap["gauges"].get(
                   "spec_tokens_per_window"),
               verify_call_ms_idle=graph_call_ms(torch, eng, eng.widths[-1]),
               launches={k: v for k, v in launches.items() if v})
    emit("llama_spec8", **run)
    del eng
    torch.cuda.empty_cache()
    return run, launches


def llama_phase(torch, attention, quant_matmul, args) -> dict:
    """Phase 9: Llama-3-8B (see the module docstring)."""
    t0 = time.monotonic()
    rec = dict(kernels=llama_kernel_cases(torch, attention, quant_matmul))
    rec["witness"] = llama_witness(torch, attention, quant_matmul, args)
    rec["deployment"], rec["launches"] = llama_deployment(
        torch, attention, quant_matmul, args)
    rec["spec"], rec["spec_launches"] = llama_spec(
        torch, attention, quant_matmul, args)
    rec["seconds"] = time.monotonic() - t0
    emit("llama_phase", seconds=rec["seconds"])
    return rec


# ------------------------------------------------ phase 10: gpt2-moe

MOE = "gpt2-moe"            # models/registry.py: GPT-2 small's trunk, E = 8
MOE_WITNESS_LAYERS = 4      # the float32 witness's depth (of 12)
MOE_WITNESS = "gpt2-moe-4-layers"  # its preset, registered by phase 10


def moe_witness(torch, attention, quant_matmul, args) -> dict:
    """Phase 10 (b): float32 at gpt2-moe's full width, cut to
    MOE_WITNESS_LAYERS layers, int8 weights and KV, the paged engine
    eagerly: the kernel path (the append kernel, the int8 products and the
    expert kernel on the CUDA cores) gives the same greedy tokens on 8
    prompts as the plain path (plain attention, both int8 wrappers' plain
    versions swapped in)."""
    import functools

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        SamplingParams,
    )
    from distributed_lms_raft_llm_tpu_torch.models import moe, registry
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    registry.PRESETS[MOE_WITNESS] = (registry.MOE_FAMILY, functools.partial(
        moe.GPT2MoEConfig.moe_small, num_layers=MOE_WITNESS_LAYERS))
    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    base = dict(model=MOE_WITNESS, quant="int8", kv_quant=True,
                dtype=torch.float32, param_dtype=torch.float32,
                seed=args.seed, device="cuda",
                sampling=SamplingParams.greedy(max_new_tokens=32))
    toks, runs = {}, {}
    layers = MOE_WITNESS_LAYERS
    try:
        for name, fused in (("plain", False), ("kernels", True)):
            eng = PagedEngine(EngineConfig(fused_attention=fused, **base),
                              slots=8, chunk=16, inflight=3,
                              cuda_graphs=False)
            cfg = eng.cfg
            check(cfg.hidden_size == 768 and cfg.num_experts == 8
                  and cfg.experts_per_token == 2
                  and cfg.capacity_factor == 1.25
                  and cfg.num_layers == layers
                  and cfg.dtype == torch.float32 and cfg.quant_kv
                  and isinstance(eng.params["blocks"]["moe"]["wi"], dict),
                  f"phase 10 witness: not gpt2-moe's width in float32 with "
                  f"int8 weights and KV: {cfg}")
            attention.reset_launch_counts()
            quant_matmul.reset_launch_counts()
            calls0 = (eng.decode_steps, eng.prefill_calls)
            if fused:
                toks[name] = engine_tokens(eng, prompts)
            else:
                with plain_int8_products(quant_matmul):
                    toks[name] = engine_tokens(eng, prompts)
            decode = eng.decode_steps - calls0[0]
            model = decode + eng.prefill_calls - calls0[1]
            launches = {**attention.launch_counts,
                        **quant_matmul.launch_counts}
            runs[name] = dict(decode_model_calls=decode, model_calls=model,
                              tokens=sum(len(t) for t in toks[name]),
                              launches={k: v for k, v in launches.items()
                                        if v})
            want = ({} if not fused else {
                attention.APPEND_INT8KV: layers * decode,
                quant_matmul.FMA: (2 * layers + 1) * model,
                quant_matmul.FMA_EXPERTS: 2 * layers * model,
                quant_matmul.KERNEL: (4 * layers + 1) * model})
            check(decode > 0 and runs[name]["launches"] == want,
                  f"phase 10 witness {name}: launches "
                  f"{runs[name]['launches']} != {want}")
            del eng
            torch.cuda.empty_cache()
    finally:
        registry.PRESETS.pop(MOE_WITNESS, None)
    firsts = [first_divergence(a, b)
              for a, b in zip(toks["kernels"], toks["plain"])]
    rec = dict(layers=layers, requests=len(prompts),
               equal=sum(f is None for f in firsts),
               first_divergence=[f for f in firsts if f is not None],
               runs=runs)
    emit("moe_f32_witness", **rec)
    check(rec["equal"] == len(prompts),
          f"phase 10 witness: float32 greedy tokens differ between the "
          f"kernel and the plain path: {rec['first_divergence']}")
    return rec


def moe_node(tutoring_server, args, *extra):
    """The node's flags from configs/cluster.toml with `model` set to
    gpt2-moe: seeded random weights and the byte tokenizer (no MoE
    checkpoint exists)."""
    node_args = tutoring_server.resolve_args([
        "--config", str(REPO / "configs" / "cluster.toml"),
        "--model", MOE, "--checkpoint", "", "--vocab", "", "--merges", "",
        "--seed", str(args.seed), "--port", "0", *extra])
    check(node_args.model == MOE and node_args.paged
          and node_args.quant == "int8" and node_args.kv_quant
          and node_args.slots == 16 and node_args.chunk == 16
          and node_args.inflight == 3 and node_args.megastep == 4
          and node_args.megastep_max == 8 and node_args.prefix_cache
          and node_args.prefix_cache_blocks == 512
          and node_args.prefill_chunk_tokens == 32
          and node_args.max_new_tokens == 128,
          f"phase 10: configs/cluster.toml did not resolve to the "
          f"deployment config: {vars(node_args)}")
    return node_args


def profile_decode_call(torch, eng, width, reps=2) -> dict:
    """Where an idle decode call's device time goes: `reps` replays of the
    decode chunk graph at `width` (every slot inactive, as
    `graph_call_ms`) under `torch.profiler`, kernel time a model call by
    kind: the expert products, the trunk's dense int8 products, the
    unembedding, the append kernel (its record spans its wait under the
    qkv product) and everything else (the eager torch kernels: norms,
    casts, residual adds, the router, top-k, dispatch and combine), with
    the largest of those by name. The profiler may lose records: a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile

    graph, _ = eng._graphs[width]
    eng.state = eng._init_state(width)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    events = device_events(torch, prof)
    eng.reset()
    calls = reps * eng.chunk
    kinds = {"experts": ("int8_mma_experts",), "dense": ("int8_mma_dense",),
             "unembed": ("int8_mma_rows",),
             "append": ("decode_attention_append",)}
    out = {k: [0.0, 0] for k in (*kinds, "other")}
    others: dict = {}
    for name, us in events:
        kind = next((k for k, parts in kinds.items()
                     if any(part in name for part in parts)), "other")
        out[kind][0] += us / calls
        out[kind][1] += 1 / calls
        if kind == "other":
            total, n = others.get(name, (0.0, 0))
            others[name] = (total + us / calls, n + 1 / calls)
    top = sorted(others.items(), key=lambda kv: -kv[1][0])[:10]
    return {"us_per_call": {k: v[0] for k, v in out.items()},
            "kernels_per_call": {k: v[1] for k, v in out.items()},
            "traced_us_per_call": sum(v[0] for v in out.values()),
            "other_top": [{"name": name[:90], "us_per_call": us,
                           "per_call": n} for name, (us, n) in top]}


def moe_deployment(torch, attention, quant_matmul, args) -> tuple:
    """Phase 10 (c) and (d): the deployment config at gpt2-moe's full width
    and depth (see the module docstring). Returns (its record, its
    launches)."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        PagedQueue,
    )
    from distributed_lms_raft_llm_tpu_torch.engine.graphs import (
        routes_of_counts,
        routes_of_names,
    )
    from distributed_lms_raft_llm_tpu_torch.ops.sweep_int8 import (
        H100_HBM_BYTES_PER_S,
    )
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    node_args = moe_node(tutoring_server, args)
    sampled_args = moe_node(tutoring_server, args)
    node_args.sampling_overrides = dict(temperature=0.0, top_k=0, top_p=1.0,
                                        repetition_penalty=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = tutoring_server.engine_from_args(node_args)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    cfg = eng.cfg
    check(isinstance(eng, PagedEngine) and eng.cuda_graphs and eng.fused
          and eng.family.name == "gpt2_moe"
          and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.num_heads == 12 and cfg.num_experts == 8
          and cfg.experts_per_token == 2 and cfg.capacity_factor == 1.25
          and cfg.mlp_dim == 3072 and cfg.vocab_size == 50257
          and cfg.dtype == torch.bfloat16 and cfg.quant_kv
          and isinstance(eng.params["blocks"]["moe"]["wi"], dict)
          and not isinstance(eng.params["blocks"]["moe"]["wr"], dict)
          and eng.state.cache.k.dtype == torch.int8
          and eng.slots == 16 and eng.prefill_chunk == 32
          and eng.megastep_ks == [1, 2, 4, 8]
          and eng.prefix_cache.max_blocks == 512
          and eng.widths == [160, 192, 256, 384] and eng.config.scoring
          and eng.config.sampling.temperature == 0.0,
          f"phase 10: not gpt2-moe on the deployment config: {cfg}, "
          f"widths {eng.widths}")
    weight_bytes = int8_weight_bytes(eng.params, ("wpe",))
    warm_s = eng.warmup()
    captured = {}
    for w, (dec, adm) in eng._graphs.items():
        counted = routes_of_counts(dec.captured_launches())
        captured[w] = dict(
            decode_counted=counted,
            decode_kernel_nodes=routes_of_names(dec.kernels),
            admission_counted=routes_of_counts(adm.captured_launches()),
            decode_all_kernel_nodes=sum(dec.kernels.values()),
            admission_all_kernel_nodes=sum(adm.kernels.values()),
            programmatic_edges=dec.programmatic_edges)
        check(counted["decode_attention_append"] == 12 * eng.chunk
              == dec.programmatic_edges
              and counted["int8_matmul_mma_experts"] == 24 * eng.chunk
              and counted["int8_matmul_mma"] == 24 * eng.chunk
              and counted["int8_matmul_mma_unembed"] == eng.chunk
              and counted["int8_matmul_fma"] == 0
              and counted["int8_matmul_fma_experts"] == 0
              and captured[w]["admission_counted"][
                  "int8_matmul_mma_experts"] == 24,
              f"phase 10: width {w}'s graphs: {captured[w]}")
    kernels_per_call = (captured[eng.widths[-1]]["decode_all_kernel_nodes"]
                        / eng.chunk)
    with torch.inference_mode():
        ids = torch.tensor([eng.tokenizer.encode(q)[:8] for q in
                            QUESTIONS[:2]], device=eng.device)
        logits, _ = eng.family.forward(eng.params, cfg, ids)
    check(tuple(logits.shape) == (2, 8, 50257)
          and bool(torch.isfinite(logits).all()),
          "phase 10: full-width logits are not finite [2, 8, 50257]")
    del logits

    wave1 = list(QUESTIONS)
    wave2 = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    # Greedy twice on one schedule. With capacity 1.25 < 8 experts a
    # token's output depends on the rows that share its forward (the JAX
    # package's capacity caveat), so two runs must give the forwards the
    # same rows to give the same answers: wave 1 drained, then wave 2, the
    # engine reset (its megastep K) and the prefix tree emptied before
    # each run. The queue run below lets wave 2 land mid-decode wherever
    # the host's timing puts it: its answers are not held to these.
    same_schedule = []
    for _ in range(2):
        eng.reset()  # the slot planes and megastep K at their start
        eng.prefix_cache.clear()
        same_schedule.append(engine_tokens(eng, wave1, wave2))
    firsts = [first_divergence(a, b) for a, b in zip(*same_schedule)]
    check(all(f is None for f in firsts)
          and all(len(t) > 0 for t in same_schedule[0]),
          f"phase 10: greedy tokens changed between two runs on one "
          f"schedule (first divergences {firsts})")
    eng.reset()
    eng.prefix_cache.clear()
    runs, name = {}, "greedy"
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.total_generated_tokens)
    answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics,
                                          wave1, wave2)
    decode_calls = eng.decode_steps - c0[0]
    model_calls = (decode_calls + eng.admission_chunks - c0[1]
                   + eng.prefill_calls - c0[2])
    tokens = eng.total_generated_tokens - c0[3]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    check(len(answers) == 16
          and all(isinstance(a, str) for a in answers),
          f"phase 10 {name}: expected 16 string answers")
    check(decode_calls > 0
          and launches[attention.APPEND_INT8KV] == 12 * decode_calls,
          f"phase 10 {name}: launches {launches} for {decode_calls} "
          f"decode and {model_calls} model calls (12 append a decode "
          f"call)")
    # 24 expert, 24 dense and 1 unembedding int8 products a model
    # call: a decode call's (16 rows, 5 an expert) and an admission
    # chunk's experts (10 an expert) on the mma.sync tiles, the
    # chunk's dense products and unembedding (32 rows) on the wgmma
    # ones
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, decode_calls, eng.admission_chunks - c0[1],
        eng.prefill_calls - c0[2]), 24, experts=24, moe_cfg=eng.cfg),
        f"phase 10 {name}")
    check(all(launches[n] == 0 for n in (
        attention.KERNEL, attention.RAGGED, attention.INT8KV,
        attention.APPEND, attention.WINDOW, attention.WINDOW_INT8KV)),
          f"phase 10 {name}: an attention variant other than the int8 "
          f"append ran")
    lat = snap["latency"]
    runs[name] = dict(
        answers=answers, wall_s=wall, tokens=tokens,
        tokens_per_s=tokens / wall, ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_p90_s=lat["ttft"]["p90_s"],
        decode_model_calls=decode_calls, model_calls=model_calls,
        prefix_hit_tokens=snap["counters"].get(
            "prefix_cache_hit_tokens", 0))
    width = eng.widths[-1]
    call_ms = graph_call_ms(torch, eng, width)
    call_profile = profile_decode_call(torch, eng, width)
    emit("moe_decode_call_profile", width=width, **call_profile)

    # (d) One scoring quantum, 8 texts at the 256 bucket (S = 2,048, C =
    # 640), through the kernels and against both int8 wrappers' plain
    # versions.
    texts = score_corpus(eng.tokenizer, 8, 300, args.seed)
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = eng.score(texts)
    quantum_s = time.monotonic() - t0
    q_launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    check_int8_routes(q_launches, int8_want(
        quant_matmul, [(1, 8 * 256)], 24, experts=24, moe_cfg=eng.cfg),
        "phase 10 quantum")
    check(sum(attention.launch_counts.values()) == 0,
          f"phase 10: a quantum launched attention kernels: {q_launches}")
    with plain_int8_products(quant_matmul):
        plain = eng.score(texts)
    rel = [abs(g["logprob"] - w["logprob"]) / max(abs(w["logprob"]), 1e-9)
           for g, w in zip(got, plain)]
    check(all(r["truncated"] and r["tokens"] == 255 for r in got)
          and all(math.isfinite(r["logprob"]) for r in got)
          and [r["tokens"] for r in got] == [r["tokens"] for r in plain]
          and max(rel) <= SCORE_BF16_REL_TOLERANCE,
          f"phase 10: the 8 x 256 quantum's bf16 logprobs differ from the "
          f"plain version's by {max(rel):.3g} of |logprob| (tolerance "
          f"{SCORE_BF16_REL_TOLERANCE}), or its texts were not 256 tokens")
    quantum = dict(texts=8, bucket=256, rows=2048, capacity=640,
                   wall_s=quantum_s,
                   launches={k: v for k, v in q_launches.items() if v},
                   bf16_vs_plain_max_rel=max(rel),
                   tolerance=SCORE_BF16_REL_TOLERANCE)
    emit("moe_score_quantum", **quantum)
    run = dict(
        init_s=init_s, warmup_s=warm_s, requests=16,
        **{f"{k}_{name}": v for name, r in runs.items()
           for k, v in r.items() if k != "answers"},
        greedy_same_schedule_equal=len(same_schedule[0]),
        decode_call_ms_idle=call_ms, decode_call_profile=call_profile,
        weight_bytes=weight_bytes,
        weight_bound_ms=weight_bytes / H100_HBM_BYTES_PER_S * 1e3,
        kernels_per_decode_call=kernels_per_call,
        launches={k: v for k, v in launches.items() if v},
        launches_per_decode_call={
            "decode_attention_append_int8kv": 12,
            "int8_matmul_mma_experts": 24, "int8_matmul_mma": 24,
            "int8_matmul_mma_unembed": 1},
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        score_quantum=quantum, captured=captured)
    del eng
    torch.cuda.empty_cache()

    # The file's sampling settings, once.
    eng = tutoring_server.engine_from_args(sampled_args)
    check(eng.config.sampling.temperature == 0.7,
          f"phase 10: not the file's sampling: {eng.config.sampling}")
    eng.warmup()
    c0 = eng.total_generated_tokens
    answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics, wave1,
                                          wave2)
    check(len(answers) == 16 and all(isinstance(a, str) for a in answers),
          "phase 10 sampled: expected 16 string answers")
    tokens = eng.total_generated_tokens - c0
    run["sampled"] = dict(wall_s=wall, tokens=tokens,
                          tokens_per_s=tokens / wall,
                          ttft_p50_s=snap["latency"]["ttft"]["p50_s"],
                          ttft_p90_s=snap["latency"]["ttft"]["p90_s"])
    emit("moe_deployment", **{k: v for k, v in run.items()
                              if k != "captured"})
    del eng
    torch.cuda.empty_cache()
    return run, launches


def moe_phase(torch, attention, quant_matmul, args) -> dict:
    """Phase 10: gpt2-moe (see the module docstring)."""
    t0 = time.monotonic()
    rec = dict(witness=moe_witness(torch, attention, quant_matmul, args))
    rec["deployment"], rec["launches"] = moe_deployment(
        torch, attention, quant_matmul, args)
    rec["seconds"] = time.monotonic() - t0
    emit("moe_phase", seconds=rec["seconds"])
    return rec


# ------------------------------------------ phase 11: the LMS main path

LMS_NODES = 5                # configs/cluster.toml [cluster.nodes]
# The assignment the student posts (as a PDF): a course text that names
# the topics of the 8 QUESTIONS.
LMS_COURSE_TEXT = (
    "CS 201, assignment 3. Data structures and systems: binary search "
    "trees, how Raft elects a leader, processes and threads, why "
    "quicksort is O(n log n) on average, hash tables and constant-time "
    "lookup, finding a cycle in a linked list, dynamic programming, and "
    "when to use a heap instead of a sorted array.")
# Off-topic queries, tried in order until one sits GATE_GAP_MIN below the
# lowest similarity of the 8 QUESTIONS under the in-process gate.
OFF_TOPIC_QUERIES = [
    "zzzz ???? 0000 #### qqqq",
    "~~~~ ^^^^ |||| %%%% @@@@ ~~~~ ^^^^ |||| %%%% @@@@",
    "0000000000 1111111111 2222222222 3333333333",
    "QQQQQQQQ XXXXXXXX ZZZZZZZZ JJJJJJJJ KKKKKKKK",
    "!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!",
    ";;;; :::: ,,,, .... '''' ;;;; :::: ,,,, ....",
    "9 8 7 6 5 4 3 2 1 0 9 8 7 6 5 4 3 2 1 0",
    "{{{{ }}}} [[[[ ]]]] <<<< >>>> {{{{ }}}}",
    "zzzz",
    "xxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxx",
]
GATE_GAP_MIN = 4e-2          # twice phase 6's bf16 tolerance
GATE_SIM_TOL = 2e-2          # the refusal's similarity vs the in-process gate
LMS_LIMIT_S = 10.0           # election, failover and catch-up bounds
LMS_BOOT_LIMIT_S = 180.0     # five processes importing torch, gates on the card
LMS_STREAMED = 2             # of QUESTIONS, also over StreamLLMAnswer
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0)
REFUSAL = re.compile(r"^Your query does not appear related to your assignment "
                     r"\(similarity (-?[0-9.]+)\); please ask your "
                     r"instructor instead\.$")


class ServingThread:
    """The in-process tutoring node served on an event loop of its own
    thread, so this thread can drive the LMS processes and the blocking
    client."""

    def __init__(self, serve):
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = self.run(serve(), 300)

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop(self):
        async def down():
            await self.server.stop(0)
            await self.server._queue.close()
        try:
            self.run(down(), 60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)


def percentiles(xs) -> dict:
    xs = sorted(xs)

    def p(q):
        return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]
    return {"p50_ms": 1e3 * p(50), "p90_ms": 1e3 * p(90),
            "n": len(xs)}


def find_spans(spans, name):
    out = []
    for sp in spans:
        if sp["name"] == name:
            out.append(sp)
        out += find_spans(sp.get("children", []), name)
    return out


def lms_threshold(torch, args, context) -> dict:
    """The gate threshold for the run: the midpoint between the lowest
    similarity of the 8 QUESTIONS and an off-topic query's, under an
    in-process gate on the nodes' seed and dtype."""
    from distributed_lms_raft_llm_tpu_torch.config import load_config
    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig,
        RelevanceGate,
    )

    section = load_config(str(REPO / "configs" / "cluster.toml")).gate
    gate = RelevanceGate(GateConfig(
        model=section.model, checkpoint=args.gate_checkpoint,
        vocab_path=args.gate_vocab, quant=section.quant, device="cuda"))
    check(gate.cfg.dtype == torch.bfloat16 and gate.cfg.num_layers == 12
          and gate.cfg.hidden_size == 768,
          f"phase 11: the gate is not bert-base in bf16: {gate.cfg}")
    gate.warmup()
    on = {q: gate.check(q, context)[1] for q in QUESTIONS}
    lowest = min(on.values())
    tried = []
    for off in OFF_TOPIC_QUERIES:
        sim = gate.check(off, context)[1]
        tried.append((off, sim))
        if lowest - sim >= GATE_GAP_MIN:
            break
    else:
        raise SmokeFailure(
            f"phase 11: no off-topic query sits {GATE_GAP_MIN} below the "
            f"lowest on-topic similarity {lowest}: {tried}")
    del gate
    torch.cuda.empty_cache()
    return dict(threshold=(lowest + sim) / 2, on_topic=on, lowest=lowest,
                off_topic=off, off_topic_sim=sim, gap=lowest - sim,
                off_topic_tried=len(tried),
                gate_weights=("--gate-checkpoint" if args.gate_checkpoint
                              else "seeded random (seed 1)"),
                gate_tokenizer=("--gate-vocab" if args.gate_vocab
                                else "byte fallback"))


def lms_phase(torch, attention, quant_matmul, args, card) -> dict:
    """Phase 11: five port LMS processes started from a copy of
    configs/cluster.toml, the port's gate on the card in each, the port's
    tutoring node in-process on the deployment config (see the module
    docstring)."""
    import concurrent.futures
    import shutil

    import grpc

    from distributed_lms_raft_llm_tpu_torch.client import LMSClient
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving import (
        lms_cluster,
        tutoring_server,
    )
    from distributed_lms_raft_llm_tpu_torch.utils import pdf

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lms_")
    log_dir = (str(Path(args.out).parent / "phase11_logs") if args.out
               else os.path.join(tmp, "logs"))
    record = {}
    procs, group_procs, node, clients = [], [], None, []
    ok = False
    try:
        context = pdf.extract_text(pdf.make_pdf(LMS_COURSE_TEXT))
        record["gate"] = lms_threshold(torch, args, context)
        emit("lms_gate_threshold", **record["gate"])

        # (1) The deployment file, with what one machine forces changed;
        # phase 11b's grouped copy beside it (its group ports probed free
        # with the rest).
        group_bases, stride, ports = lms_cluster.free_group_ports(
            LMS_NODES, LMS_GROUPS, 3 * LMS_NODES + 2)
        lms_ports = ports[:LMS_NODES]
        metrics_ports = ports[LMS_NODES:2 * LMS_NODES]
        tut_port, tut_metrics = ports[2 * LMS_NODES:2 * LMS_NODES + 2]
        group_metrics = ports[2 * LMS_NODES + 2:]
        tut_address = f"127.0.0.1:{tut_port}"
        changes = {("cluster", "data_dir"): os.path.join(tmp, "lms_data")}
        for i in range(1, LMS_NODES + 1):
            changes[("cluster.nodes", str(i))] = (
                f"127.0.0.1:{lms_ports[i - 1]}")
        changes.update({
            ("tutoring", "address"): tut_address,
            ("tutoring_fleet", "addresses"): [tut_address],
            ("tutoring_fleet", "health_addresses"): [
                f"127.0.0.1:{tut_metrics}"],
            ("gate", "checkpoint"): args.gate_checkpoint or lms_cluster.REMOVE,
            ("gate", "vocab"): args.gate_vocab or lms_cluster.REMOVE,
            ("gate", "threshold"): record["gate"]["threshold"],
        })
        path, applied = lms_cluster.deployment_copy(
            str(REPO / "configs" / "cluster.toml"), tmp, changes)
        for line in applied:
            print(f"phase 11 config change: {line}", flush=True)
        record.update(config_changes=applied,
                      lms_metrics_ports=metrics_ports)
        group_changes = dict(changes)
        group_changes[("cluster", "data_dir")] = os.path.join(
            tmp, "lms_data_groups")
        for i in range(1, LMS_NODES + 1):
            group_changes[("cluster.nodes", str(i))] = (
                f"127.0.0.1:{group_bases[i - 1]}")
        group_changes.update({
            ("groups", "count"): LMS_GROUPS,
            ("groups", "port_stride"): stride,
            ("groups", "secret"): hashlib.sha256(
                f"chip-smoke-{args.seed}".encode()).hexdigest()[:32]})
        group_path, group_applied = lms_cluster.deployment_copy(
            str(REPO / "configs" / "cluster.toml"), tmp, group_changes,
            name="cluster_groups.toml")
        for line in group_applied:
            print(f"phase 11b config change: {line}", flush=True)

        # (2) The five LMS nodes, each its own process; they build their
        # gates on the card while this process warms the tutoring node.
        addresses = [f"127.0.0.1:{p}" for p in lms_ports]
        t_launch = time.monotonic()
        procs = [lms_cluster.LMSProcess(
            path, i, metrics_port=metrics_ports[i - 1], log_dir=log_dir,
            device="cuda").start() for i in range(1, LMS_NODES + 1)]
        # Phase 11b's five boot now too, beside these (idle until then).
        group_procs = [lms_cluster.LMSProcess(
            group_path, i, metrics_port=group_metrics[i - 1],
            log_dir=os.path.join(os.path.dirname(log_dir), "phase11b_logs"),
            device="cuda").start()
            for i in range(1, LMS_NODES + 1)]

        # (3) The tutoring node in-process, on the copy: the deployment
        # config, greedy, seeded random weights under phase 5's tokenizer.
        vocab, merges, tok_record = phase5_tokenizer(args, Path(tmp))
        node_args = tutoring_server.resolve_args([
            "--config", path, "--checkpoint", args.checkpoint or "",
            "--vocab", vocab, "--merges", merges, "--seed", str(args.seed),
            "--metrics-port", str(tut_metrics), "--node-id", "phase11"])
        node_args.sampling_overrides = dict(GREEDY)
        node_args.scoring = False  # the tenant is phase 8's
        check(node_args.port == tut_port and node_args.paged
              and node_args.quant == "int8" and node_args.kv_quant
              and node_args.slots == 16 and node_args.megastep == 4
              and node_args.megastep_max == 8 and node_args.prefix_cache
              and node_args.prefill_chunk_tokens == 32,
              f"phase 11: the copy did not resolve to the deployment "
              f"config: {vars(node_args)}")
        eng = tutoring_server.engine_from_args(node_args)
        check(isinstance(eng, PagedEngine) and eng.cuda_graphs and eng.fused
              and eng.cfg.quant_kv and eng.cfg.dtype == torch.bfloat16
              and eng.cfg.num_layers == 12 and eng.cfg.hidden_size == 768
              and eng.config.sampling.temperature == 0.0,
              f"phase 11: not the deployment engine: {eng.cfg}")
        warm_s = eng.warmup()
        node = ServingThread(lambda: tutoring_server.serve_args(
            node_args, eng, host="127.0.0.1"))
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
        serving_guard = contextlib.ExitStack()
        inventory = serving_guard.enter_context(
            inventory_guard(eng, "phase 11 node"))

        # (4) The node's own answers to the 8 questions (concurrent).
        def direct(query):
            t0 = time.monotonic()
            with grpc.insecure_channel(tut_address) as ch:
                resp = rpc.TutoringStub(ch).GetLLMAnswer(
                    lms_pb2.QueryRequest(query=query), timeout=120)
            return resp, time.monotonic() - t0

        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            direct_runs = list(ex.map(direct, QUESTIONS))
        for (resp, _), q in zip(direct_runs, QUESTIONS):
            check(resp.success and resp.response.strip(),
                  f"phase 11: the node's direct answer to {q!r} is empty")
        answers = {q: r.response for (r, _), q in zip(direct_runs,
                                                      QUESTIONS)}

        # (5) The nodes serving, one leader named by all five.
        lms_cluster.wait_for(
            lambda: all(lms_cluster.health(p.metrics_port) for p in procs),
            LMS_BOOT_LIMIT_S, alive=procs)
        all_up = time.monotonic()

        def named_leader(live):
            named = {lms_cluster.who_is_leader(addresses[p.node_id - 1])
                     for p in live}
            return named.pop() if len(named) == 1 and None not in named \
                else None

        leader, election_s = lms_cluster.wait_for(
            lambda: named_leader(procs), LMS_LIMIT_S, alive=procs)
        record.update(boot_s=all_up - t_launch, election_s=election_s,
                      leader=leader, warm_s=warm_s, tokenizer=tok_record)

        # (6) One student: Register, Login, Post the assignment PDF.
        client = LMSClient(addresses, discovery_backoff_s=0.2)
        clients.append(client)
        check(client.register("ana", "pw", "student").success
              and client.login("ana", "pw")
              and client.upload_assignment(
                  "assignment3.pdf", pdf.make_pdf(LMS_COURSE_TEXT)),
              "phase 11: Register / Login / Post failed")

        def ask(query):
            c = LMSClient(addresses, discovery_backoff_s=0.2)
            clients.append(c)
            c.token, c.role = client.token, client.role
            rid = f"phase11-{QUESTIONS.index(query)}"
            t0 = time.monotonic()
            resp = c.ask_llm(query, request_id=rid)
            return resp, time.monotonic() - t0, rid

        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            lms_runs = list(ex.map(ask, QUESTIONS))
        for (resp, _, _), q in zip(lms_runs, QUESTIONS):
            check(resp.success and resp.response == answers[q],
                  f"phase 11: the LMS answer to {q!r} is not the node's "
                  f"direct answer: {resp.response[:200]!r}")
        off = record["gate"]["off_topic"]
        refusal = client.ask_llm(off, request_id="phase11-off").response
        m = REFUSAL.match(refusal)
        check(m is not None, f"phase 11: the off-topic query was not "
              f"refused with the reference's text: {refusal!r}")
        refused_sim = float(m.group(1))
        # The text gives 2 decimals: up to 5e-3 of the gap is rounding.
        check(abs(refused_sim - record["gate"]["off_topic_sim"])
              <= GATE_SIM_TOL + 5e-3,
              f"phase 11: the leader's gate reported {refused_sim}, the "
              f"in-process gate {record['gate']['off_topic_sim']}")
        check(named_leader(procs) == leader,
              "phase 11: the leader changed under the questions")
        lead_port = metrics_ports[leader - 1]
        _, metrics = lms_cluster.http_json(lead_port, "/metrics")
        counters = metrics["counters"]
        record["leader_tick_lag"] = {
            k: metrics.get("latency", {}).get(k)
            for k in ("raft_tick_lag", "serving_tick_lag")}
        check(counters.get("gate_pass") == len(QUESTIONS)
              and counters.get("gate_reject") == 1
              and not counters.get("tutoring_degraded"),
              f"phase 11: the leader's gate counted "
              f"{counters.get('gate_pass')} passes, "
              f"{counters.get('gate_reject')} rejects, "
              f"{counters.get('tutoring_degraded')} degraded")
        gate_spans = []
        for rid in [r for _, _, r in lms_runs] + ["phase11-off"]:
            code, trace = lms_cluster.http_json(lead_port,
                                                f"/admin/trace/{rid}")
            check(code == 200, f"phase 11: no trace of {rid} on the leader")
            spans = find_spans(trace["trace"]["spans"], "gate.check")
            check(len(spans) == 1, f"phase 11: {len(spans)} gate.check "
                  f"spans in the trace of {rid}")
            gate_spans.append(spans[0]["duration_s"])
        # The node's direct calls again, the prefix tree now as warm as
        # the LMS run found it: the latency beside the LMS run's.
        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            warm_runs = list(ex.map(direct, QUESTIONS))
        for (resp, _), q in zip(warm_runs, QUESTIONS):
            check(resp.success and resp.response == answers[q],
                  f"phase 11: the node's second direct answer to {q!r} "
                  f"differs from its first")

        # Two questions also over StreamLLMAnswer.
        streamed = []
        for q in QUESTIONS[:LMS_STREAMED]:
            s = client.ask_llm_stream(q)
            check(s.success and s.response == answers[q].strip()
                  and s.resumes == 0 and s.digest_ok,
                  f"phase 11: the stream of {q!r} is not the unary answer "
                  f"(resumes {s.resumes}, digest ok {s.digest_ok})")
            streamed.append(dict(chunks=s.chunks, ttft_s=s.ttft_s))

        # (7) Failover: SIGKILL the leader's process.
        t_kill = time.monotonic()
        procs[leader - 1].kill()
        live = [p for p in procs if p.node_id != leader]
        new_leader, failover_s = lms_cluster.wait_for(
            lambda: (lambda n: n if n not in (None, leader) else None)(
                named_leader(live)), LMS_LIMIT_S, alive=live)
        client.discover_leader(force=True)
        resp = client.ask_llm(QUESTIONS[0])
        check(resp.success and resp.response == answers[QUESTIONS[0]],
              f"phase 11: after failover the session's answer was "
              f"{resp.response[:200]!r}")
        after_kill_s = time.monotonic() - t_kill
        procs[leader - 1].start()
        _, reboot_s = lms_cluster.wait_for(
            lambda: lms_cluster.health(procs[leader - 1].metrics_port),
            LMS_BOOT_LIMIT_S, alive=procs)
        new_port = metrics_ports[new_leader - 1]

        def caught_up():
            mine = lms_cluster.health(procs[leader - 1].metrics_port)
            theirs = lms_cluster.health(new_port)
            return (mine and theirs and mine["leader_id"] == new_leader
                    and mine["applied_index"] >= theirs["applied_index"])

        _, catchup_s = lms_cluster.wait_for(caught_up, LMS_LIMIT_S,
                                            alive=procs)

        # (8) Launches over the phase, through the node's counters.
        launches = {**attention.launch_counts, **quant_matmul.launch_counts}
        decode_calls = eng.decode_steps - c0[0]
        model_calls = decode_calls + eng.admission_chunks - c0[1] + (
            eng.prefill_calls - c0[2])
        others = {k: v for k, v in attention.launch_counts.items()
                  if k != attention.APPEND_INT8KV and v}
        check(decode_calls > 0
              and launches[attention.APPEND_INT8KV] == 12 * decode_calls
              and not others,
              f"phase 11: launches {launches} for {decode_calls} decode "
              f"and {model_calls} model calls")
        check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
            quant_matmul, eng, decode_calls, eng.admission_chunks - c0[1],
            eng.prefill_calls - c0[2]), 48), "phase 11")
        serving_guard.close()
        emit("inventory_11", **inventory)
        record.update(inventory=inventory,
            lms_answer=percentiles([t for _, t, _ in lms_runs]),
            direct_answer_cold=percentiles([t for _, t in direct_runs]),
            direct_answer=percentiles([t for _, t in warm_runs]),
            gate_check=percentiles(gate_spans[:-1]),
            gate_check_alone_ms=1e3 * gate_spans[-1],
            refused_similarity=refused_sim, streams=streamed,
            failover_s=failover_s, first_answer_after_kill_s=after_kill_s,
            new_leader=new_leader, restart_boot_s=reboot_s,
            catchup_s=catchup_s, decode_model_calls=decode_calls,
            model_calls=model_calls, launches=launches,
            answer_tokens=sum(len(eng.tokenizer.encode(a))
                              for a in answers.values()),
            card=card, seconds=time.monotonic() - t_phase)
        for p in procs:
            p.stop()
        record["groups"] = grouped_lms_phase(
            torch, attention, quant_matmul, argparse.Namespace(
                procs=group_procs, addresses=[
                    f"127.0.0.1:{b}" for b in group_bases],
                metrics_ports=group_metrics, bases=group_bases,
                stride=stride, applied=group_applied, eng=eng,
                answers=answers, direct=direct, tmp=tmp, card=card,
                off_topic=record["gate"]["off_topic"],
                off_topic_sim=record["gate"]["off_topic_sim"]))
        ok = True
        return record
    finally:
        for c in clients:
            c.close()
        for p in procs + group_procs:
            p.stop()
        if node is not None:
            node.stop()
        if not ok:
            for p in procs + group_procs:
                print(f"--- LMS node {p.node_id} log ({p.log_path}):\n"
                      f"{p.tail(40)}", file=sys.stderr, flush=True)
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------ phase 11b: a two-group LMS

LMS_GROUPS = 2               # [groups] count of phase 11b's copy
GROUP_STUDENTS = 4           # students homed in each group (8 questions)
RESHARD_REFUSAL = "resharding is not enabled on this deployment"


def homed_students(n_groups, per_group):
    """{gid: usernames} homed in each group by `RoutingMap.initial`."""
    from distributed_lms_raft_llm_tpu_torch.lms.group_router import (
        RoutingMap,
    )

    routing = RoutingMap.initial(n_groups)
    out = {g: [] for g in range(n_groups)}
    i = 0
    while any(len(v) < per_group for v in out.values()):
        name = f"student{i}"
        g = routing.group_for(name)
        if len(out[g]) < per_group:
            out[g].append(name)
        i += 1
    return out


def grouped_lms_phase(torch, attention, quant_matmul, ctx) -> dict:
    """Phase 11b: five port LMS processes from a copy of
    configs/cluster.toml with `[groups] count = 2`, in front of phase 11's
    tutoring node and with its gate threshold (see the module
    docstring). `ctx` carries phase 11's node, its direct answers and the
    processes, started beside phase 11's."""
    import concurrent.futures

    import grpc

    from distributed_lms_raft_llm_tpu_torch.client import LMSClient
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving import lms_cluster
    from distributed_lms_raft_llm_tpu_torch.utils import pdf

    t_phase = time.monotonic()
    procs, addresses, ports = ctx.procs, ctx.addresses, ctx.metrics_ports
    eng, answers = ctx.eng, ctx.answers
    clients = []
    record = dict(config_changes=ctx.applied, port_stride=ctx.stride)
    try:
        # (1) Both groups lead; every node's topology agrees on them.
        lms_cluster.wait_for(
            lambda: all(lms_cluster.health(p.metrics_port) for p in procs),
            LMS_BOOT_LIMIT_S, alive=procs)

        def topology(live):
            docs = []
            for p in live:
                code, doc = lms_cluster.http_json(p.metrics_port,
                                                  "/admin/raft")
                if code != 200:
                    return None
                docs.append(doc)
            leads = {tuple(sorted((g, v["leader"]) for g, v in
                                  d["groups"].items())) for d in docs}
            if len(leads) != 1:
                return None
            lead = dict(leads.pop())
            live_ids = {p.node_id for p in live}
            if set(lead) != {str(g) for g in range(LMS_GROUPS)} or not all(
                    v in live_ids for v in lead.values()):
                return None
            return docs[0], {int(g): v for g, v in lead.items()}

        (doc, leaders), lead_s = lms_cluster.wait_for(
            lambda: topology(procs), LMS_LIMIT_S, alive=procs)
        check(doc["routing_map"]["n_groups"] == LMS_GROUPS
              and all(len(g["members"]) == LMS_NODES and g["term"] >= 1
                      and g["applied"] >= 1
                      for g in doc["groups"].values()),
              f"phase 11b: GET /admin/raft: {doc}")
        record.update(leaders=leaders, leaders_agreed_s=lead_s,
                      topology={g: {k: v[k] for k in ("leader", "term",
                                                      "applied")}
                                for g, v in doc["groups"].items()},
                      group1_raft_ports=sorted(
                          int(a.rsplit(":", 1)[1]) for a in
                          doc["groups"]["1"]["members"].values()))
        check(record["group1_raft_ports"] == sorted(
                  b + ctx.stride for b in ctx.bases),
              f"phase 11b: group 1's Raft ports {record['group1_raft_ports']}"
              f" are not the bases + stride {ctx.stride}")
        reshard = lms_cluster.http_json(
            ports[0], "/admin/reshard", body={"course": "cs201",
                                               "to_group": 1})
        check(reshard == (400, {"error": RESHARD_REFUSAL}),
              f"phase 11b: POST /admin/reshard answered {reshard}")

        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
        serving_guard = contextlib.ExitStack()
        inventory = serving_guard.enter_context(
            inventory_guard(eng, "phase 11b node"))

        # (2) Eight students, four homed in each group, and an instructor:
        # each registers and logs in once (the router replicates both to
        # every group), each student posts the assignment PDF.
        homes = homed_students(LMS_GROUPS, GROUP_STUDENTS)
        students = [(g, n) for g in sorted(homes) for n in homes[g]]
        assignment = pdf.make_pdf(LMS_COURSE_TEXT)

        def enroll(name, role):
            c = LMSClient(addresses, discovery_backoff_s=0.2)
            clients.append(c)
            ok = (c.register(name, "pw", role).success
                  and c.login(name, "pw")
                  and (role != "student" or c.upload_assignment(
                      f"{name}.pdf", assignment)))
            check(ok, f"phase 11b: Register / Login / Post of {name} failed")
            return c

        with concurrent.futures.ThreadPoolExecutor(len(students) + 1) as ex:
            futs = [ex.submit(enroll, n, "student") for _, n in students]
            inst_fut = ex.submit(enroll, "prof", "instructor")
            student_clients = [f.result() for f in futs]
            inst = inst_fut.result()
        # The instructor's session verifies on both groups: the fan-out
        # read of every student's assignment spans them.
        posted = sorted((e.id, bytes(e.file)) for e in
                        inst.student_assignments())
        check(posted == sorted((n, assignment) for _, n in students),
              f"phase 11b: the instructor's fan-out read returned "
              f"{[e for e, _ in posted]}")

        # (3) 8 concurrent questions, one a student, through the routers.
        def ask(i):
            rid = f"phase11b-{i}"
            t0 = time.monotonic()
            resp = student_clients[i].ask_llm(QUESTIONS[i], request_id=rid)
            return resp, time.monotonic() - t0, rid

        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            routed = list(ex.map(ask, range(len(QUESTIONS))))
        for (resp, _, _), q in zip(routed, QUESTIONS):
            check(resp.success and resp.response == answers[q],
                  f"phase 11b: the routed answer to {q!r} is not the "
                  f"node's direct answer: {resp.response[:200]!r}")
        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            direct_runs = list(ex.map(ctx.direct, QUESTIONS))
        for (resp, _), q in zip(direct_runs, QUESTIONS):
            check(resp.success and resp.response == answers[q],
                  f"phase 11b: the node's direct answer to {q!r} changed")
        refusal = student_clients[0].ask_llm(
            ctx.off_topic, request_id="phase11b-off").response
        m = REFUSAL.match(refusal)
        check(m is not None, f"phase 11b: the off-topic query was not "
              f"refused with the reference's text: {refusal!r}")
        refused_sim = float(m.group(1))
        check(abs(refused_sim - ctx.off_topic_sim) <= GATE_SIM_TOL + 5e-3,
              f"phase 11b: the leader's gate reported {refused_sim}, the "
              f"in-process gate {ctx.off_topic_sim}")
        g1_client = student_clients[GROUP_STUDENTS]  # homed in group 1
        q_stream = QUESTIONS[GROUP_STUDENTS]
        st = g1_client.ask_llm_stream(q_stream)
        check(st.success and st.response == answers[q_stream].strip()
              and st.resumes == 0 and st.digest_ok,
              f"phase 11b: the stream of {q_stream!r} is not its unary "
              f"answer (resumes {st.resumes}, digest ok {st.digest_ok})")
        # The leaders' gate.check spans, by the node that ran them.
        gate_by_node = {}
        for _, _, rid in routed:
            for p in procs:
                code, trace = lms_cluster.http_json(p.metrics_port,
                                                    f"/admin/trace/{rid}")
                if code != 200:
                    continue
                for sp in find_spans(trace["trace"]["spans"], "gate.check"):
                    gate_by_node.setdefault(p.node_id, []).append(
                        sp["duration_s"])
        check(sum(len(v) for v in gate_by_node.values()) == len(QUESTIONS)
              and set(gate_by_node) <= set(leaders.values()),
              f"phase 11b: gate.check spans by node {gate_by_node}, "
              f"leaders {leaders}")

        # (4) A post of each group read back through a node leading
        # neither (its router fans the read out to both leaders).
        reader = next(p for p in procs if p.node_id not in leaders.values())
        with grpc.insecure_channel(addresses[reader.node_id - 1]) as ch:
            resp = rpc.LMSStub(ch).Get(lms_pb2.GetRequest(
                token=inst.token, type="student_list"), timeout=30)
        read_back = sorted(e.id for e in resp.entries)
        check(read_back == sorted(n for _, n in students),
              f"phase 11b: node {reader.node_id} read back {read_back}")

        # (5) SIGKILL the process leading group 1: group 1 re-elects and
        # a student homed in it is answered through the routers.
        killed = leaders[1]
        t_kill = time.monotonic()
        procs[killed - 1].kill()
        live = [p for p in procs if p.node_id != killed]
        (_, new_leaders), failover_s = lms_cluster.wait_for(
            lambda: topology(live), LMS_LIMIT_S, alive=live)
        q_after = QUESTIONS[GROUP_STUDENTS + 1]
        resp = student_clients[GROUP_STUDENTS + 1].ask_llm(q_after)
        after_kill_s = time.monotonic() - t_kill
        check(resp.success and resp.response == answers[q_after]
              and new_leaders[1] != killed,
              f"phase 11b: after the kill of node {killed} the group-1 "
              f"student's answer was {resp.response[:200]!r} (leaders "
              f"{new_leaders})")

        # (6) The same journey through the terminal client, piped.
        paper = Path(ctx.tmp) / "assignment3.pdf"
        paper.write_bytes(assignment)
        q_cli = QUESTIONS[1]
        live_addrs = [addresses[p.node_id - 1] for p in live]
        cli = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.client.cli", "--servers",
             ",".join(live_addrs)],
            input=(f"1\nclistudent\npw\nstudent\n2\nclistudent\npw\n3\n"
                   f"{paper}\n5\n{q_cli}\nq\nq\n"),
            capture_output=True, text=True, timeout=120, cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        got = cli.stdout.split("  [ok] ", 1)[-1].split("\n\n[student]", 1)[0]
        check(cli.returncode == 0 and "  [ok] " in cli.stdout
              and got == answers[q_cli],
              f"phase 11b: the CLI's answer to {q_cli!r} is not the "
              f"direct one (rc {cli.returncode}): {cli.stdout[-600:]!r} "
              f"{cli.stderr[-600:]!r}")

        # (7) Launches through the node's counters over the phase.
        launches = {**attention.launch_counts, **quant_matmul.launch_counts}
        decode_calls = eng.decode_steps - c0[0]
        model_calls = decode_calls + eng.admission_chunks - c0[1] + (
            eng.prefill_calls - c0[2])
        others = {k: v for k, v in attention.launch_counts.items()
                  if k != attention.APPEND_INT8KV and v}
        check(decode_calls > 0
              and launches[attention.APPEND_INT8KV] == 12 * decode_calls
              and not others,
              f"phase 11b: launches {launches} for {decode_calls} decode "
              f"and {model_calls} model calls")
        check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
            quant_matmul, eng, decode_calls, eng.admission_chunks - c0[1],
            eng.prefill_calls - c0[2]), 48), "phase 11b")
        serving_guard.close()
        emit("inventory_11b", **inventory)
        record.update(inventory=inventory,
            students={str(g): v for g, v in homes.items()},
            lms_answer=percentiles([t for _, t, _ in routed]),
            direct_answer=percentiles([t for _, t in direct_runs]),
            gate_check_by_leader={str(n): percentiles(v)
                                  for n, v in gate_by_node.items()},
            refused_similarity=refused_sim, stream_chunks=st.chunks,
            read_back_node=reader.node_id, killed=killed,
            new_leaders=new_leaders, failover_s=failover_s,
            first_answer_after_kill_s=after_kill_s, cli_answer_equal=True,
            reshard=list(reshard), decode_model_calls=decode_calls,
            model_calls=model_calls, launches=launches,
            card=ctx.card, seconds=time.monotonic() - t_phase)
        return record
    finally:
        for c in clients:
            c.close()


# ------------------------------- phase 12: fine-tune and serve

TRAIN_MODEL = "gpt2"         # GPT-2 small at full width: bf16 compute, f32
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # params (the trainer CLI's defaults)
TRAIN_EPOCHS = 2
TRAIN_STEPS_PER_EPOCH = 9    # the course directory is written to this size
TRAIN_LOSS_DROP = 0.8        # the last logged loss below 0.8x the first
TRAIN_TIMED_AFTER = 3        # step ms: the median after the first 3 steps
EXPORT_LOGIT_TOL = 1e-5      # of the logits' range (tests/test_train.py)
MOE_TRAIN = "gpt2-moe"
MOE_TRAIN_STEPS = 4
CONTINUATION_PREFIX = 256    # corpus bytes the continuation starts from
CONTINUATION_TOKENS = 32


def course_directory(directory: Path, seed: int) -> str:
    """Phase 12's course material, written from the seed: `notes.txt` (the
    course texts of phases 4c, 6 and 11 and the 16 questions, in a seeded
    order each round) cut so the packed corpus fills exactly
    TRAIN_STEPS_PER_EPOCH batches of TRAIN_BATCH x TRAIN_SEQ byte tokens,
    `slides.pdf` (`utils/pdf.make_pdf` of the gate's notes) and a file
    the loader ignores. Returns the notes' text."""
    import random

    from distributed_lms_raft_llm_tpu_torch.utils import pdf

    rng = random.Random(seed)
    paragraphs = [COURSE_CONTEXT.strip(), LMS_COURSE_TEXT, GATE_NOTES.strip()]
    paragraphs += [f"Q: {q}" for q in COURSE_QUESTIONS + QUESTIONS]
    slides = pdf.make_pdf(GATE_NOTES)
    slide_bytes = len(pdf.extract_text(slides).encode())
    # notes + EOS + slides' text + EOS fill the epoch's batches and one
    # block more, which no batch takes.
    blocks = TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH + 1
    size = blocks * TRAIN_SEQ - slide_bytes - 2
    rounds = []
    while sum(len(r) + 1 for r in rounds) < size:
        rng.shuffle(paragraphs)
        rounds.append("\n".join(paragraphs))
    notes = "\n".join(rounds)[:size]
    directory.mkdir(parents=True)
    (directory / "notes.txt").write_text(notes)
    (directory / "slides.pdf").write_bytes(slides)
    (directory / "scores.bin").write_bytes(bytes(range(256)))  # ignored
    return notes


def median_step_ms(history) -> float:
    return statistics.median(h["step_ms"]
                             for h in history[TRAIN_TIMED_AFTER:])


def export_logits_err(torch, params, reloaded, cfg, ids) -> dict:
    """float32 logits of the trained params and of the export read back,
    over `ids`: their largest difference beside the logits' range."""
    from distributed_lms_raft_llm_tpu_torch.models import gpt2

    x = torch.as_tensor([ids], device="cuda")
    with torch.no_grad():
        want = gpt2.forward(params, cfg, x)[0]
        got = gpt2.forward(reloaded, cfg, x)[0]
    span = float(want.max() - want.min())
    err = float((got - want).abs().max())
    return {"max_abs_err": err, "logit_range": span,
            "finite": bool(torch.isfinite(got).all())}


def train_phase(torch, attention, quant_matmul, args, card) -> dict:
    """Phase 12: GPT-2 small fine-tuned at full width through the port's
    trainer on course material written from the seed, resumed, exported,
    and served by a tutoring node from configs/cluster.toml; then gpt2-moe
    a few steps (see the module docstring)."""
    import concurrent.futures
    import shutil

    import grpc
    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        SamplingParams,
    )
    from distributed_lms_raft_llm_tpu_torch.models import (
        convert,
        gpt2,
        moe,
        registry,
    )
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2, rpc
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
    from distributed_lms_raft_llm_tpu_torch.train import train as trainer
    from distributed_lms_raft_llm_tpu_torch.train.data import (
        DataConfig,
        PackedDataset,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        ByteTokenizer,
    )

    t_phase = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="phase12-"))
    node = None
    record = {"card": card}
    try:
        course = tmp / "course"
        notes = course_directory(course, args.seed)
        ck_a = str(tmp / "straight.safetensors")
        ck_b = str(tmp / "resumed.safetensors")
        export = str(tmp / "model.safetensors")
        argv = ["--data", str(course), "--model", TRAIN_MODEL,
                "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                "--epochs", str(TRAIN_EPOCHS), "--log-every", "1",
                "--device", "cuda"]

        # (a) Train straight through the CLI's entry point, in process
        # (the step times and the peak allocation are this process's).
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        straight = trainer.main(argv + ["--checkpoint", ck_a,
                                        "--export", export])
        train_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        hist, steps = straight["history"], straight["step"]
        losses = [h["loss"] for h in hist]
        gnorms = [h["grad_norm"] for h in hist]
        check(steps == TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
              and [h["step"] for h in hist] == list(range(1, steps + 1)),
              f"phase 12: trained {steps} steps, logged "
              f"{[h['step'] for h in hist]}")
        check(all(math.isfinite(x) for x in losses + gnorms)
              and all(g > 0 for g in gnorms),
              f"phase 12: losses {losses}, gradient norms {gnorms}")
        check(losses[-1] < TRAIN_LOSS_DROP * losses[0],
              f"phase 12: the loss went from {losses[0]} to {losses[-1]}")
        check(ckpt.latest_step(ck_a) == steps,
              f"phase 12: the sidecar says step {ckpt.latest_step(ck_a)}")
        step_ms = median_step_ms(hist)
        record["train"] = dict(
            steps=steps, seconds=train_s, step_ms_median=step_ms,
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            step_ms_first=[h["step_ms"] for h in hist[:TRAIN_TIMED_AFTER]],
            max_memory_allocated=peak, loss_first=losses[0],
            loss_last=losses[-1], grad_norm_first=gnorms[0],
            grad_norm_last=gnorms[-1], batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            corpus_bytes=len(notes.encode()))
        emit("train_straight", card=card, **record["train"])

        # (b) Resume: the first epoch in process with the same schedule
        # (main's), then the CLI's entry point resumes it to the end from
        # the checkpoint file (in this process: a fresh one spent 25 s
        # importing); the two states must be bit-equal.
        _, model_cfg = registry.resolve(TRAIN_MODEL, torch.bfloat16,
                                        torch.float32)
        dataset = PackedDataset.from_paths(
            [str(course)], ByteTokenizer(),
            DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ))
        check(dataset.steps_per_epoch() == TRAIN_STEPS_PER_EPOCH,
              f"phase 12: {dataset.steps_per_epoch()} steps an epoch")
        train_cfg = trainer.TrainConfig(warmup_steps=max(1, steps // 20),
                                        decay_steps=max(2, steps))
        half = trainer.fit("cuda", model_cfg, train_cfg, dataset, epochs=1,
                           checkpoint_path=ck_b)
        check(half["step"] == TRAIN_STEPS_PER_EPOCH
              == ckpt.latest_step(ck_b), "phase 12: the half run")
        del half
        t0 = time.monotonic()
        said = []
        heard = logging.Handler()
        heard.emit = lambda r: said.append(r.getMessage())
        fit_log = logging.getLogger("train")  # `fit`'s logger
        level = fit_log.level
        fit_log.setLevel(logging.INFO)
        fit_log.addHandler(heard)
        try:
            resumed = trainer.main(argv + ["--checkpoint", ck_b])
        finally:
            fit_log.removeHandler(heard)
            fit_log.setLevel(level)
        resume_s = time.monotonic() - t0
        check(resumed["step"] == steps and f"resumed from {ck_b} at step "
              f"{TRAIN_STEPS_PER_EPOCH}" in said,
              f"phase 12: the resumed CLI run ended at {resumed['step']}, "
              f"logging {said[:4]}")
        del resumed
        check(ckpt.latest_step(ck_b) == steps,
              f"phase 12: the resumed run ended at "
              f"{ckpt.latest_step(ck_b)}, the straight run at {steps}")
        a, b = convert.load_safetensors(ck_a), convert.load_safetensors(ck_b)
        check(list(a) == list(b), "phase 12: the two checkpoints' leaves")
        differ = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
                  for k in a if not np.array_equal(a[k], b[k])}
        check(not differ, f"phase 12: the resumed state differs from the "
              f"straight run's: {differ}")
        record["resume"] = dict(bit_equal=True, leaves=len(a),
                                resume_s=resume_s)
        del a, b
        os.remove(ck_b)
        emit("train_resume", **record["resume"])

        # (c) The export read back through the serving converter: float32
        # logits over one framed question equal the trained params'.
        tok = ByteTokenizer()
        ids = tok.encode(PROMPT_TEMPLATE.format(query=QUESTIONS[0]))
        cfg32 = gpt2.GPT2Config.small(dtype=torch.float32,
                                      param_dtype=torch.float32)
        reloaded = convert.gpt2_params_from_hf(
            convert.load_safetensors(export), cfg32, device="cuda")
        record["export"] = export_logits_err(
            torch, straight["state"]["params"], reloaded, cfg32, ids)
        check(record["export"]["finite"] and record["export"]["max_abs_err"]
              <= EXPORT_LOGIT_TOL * record["export"]["logit_range"],
              f"phase 12: export logits {record['export']}")
        emit("train_export", **record["export"])
        del straight, reloaded
        torch.cuda.empty_cache()

        # (d) Serve the export: a node from configs/cluster.toml with
        # --checkpoint, greedy; 8 GetLLMAnswer calls equal its engine's
        # direct answers; launches exact through the replays.
        node_args = tutoring_server.resolve_args([
            "--config", str(REPO / "configs" / "cluster.toml"),
            "--checkpoint", export, "--vocab", "", "--merges", "",
            "--seed", str(args.seed), "--port", "0"])
        node_args.sampling_overrides = dict(GREEDY)
        node_args.scoring = False
        check(node_args.model == TRAIN_MODEL and node_args.paged
              and node_args.quant == "int8" and node_args.kv_quant
              and node_args.slots == 16 and node_args.megastep == 4
              and node_args.megastep_max == 8 and node_args.prefix_cache
              and node_args.prefill_chunk_tokens == 32,
              f"phase 12: configs/cluster.toml did not resolve to the "
              f"deployment config: {vars(node_args)}")
        eng = tutoring_server.engine_from_args(node_args)
        cfg = eng.cfg
        trained_wpe = convert.load_safetensors(export)["wpe.weight"]
        check(isinstance(eng, PagedEngine) and eng.cuda_graphs and eng.fused
              and cfg.quant_kv and cfg.dtype == torch.bfloat16
              and cfg.num_layers == 12 and cfg.hidden_size == 768
              and torch.equal(eng.params["wpe"].cpu(), torch.from_numpy(
                  trained_wpe.copy()).to(torch.bfloat16)),
              f"phase 12: not the deployment engine on the export: {cfg}")
        warm_s = eng.warmup()
        prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
        rids = [eng.submit(p) for p in prompts]
        for rid in rids:
            eng.stream_watch(rid)
        eng.drain()
        finals = eng.pop_final_tokens()
        direct = [eng.tokenizer.decode(finals[r]).strip() for r in rids]
        # How far greedy decoding continues the corpus from a prefix
        # (reported, not held).
        prefix = notes[:CONTINUATION_PREFIX]
        cont = engine_tokens(eng, [prefix])[0][:CONTINUATION_TOKENS]
        truth = list(notes[CONTINUATION_PREFIX:].encode()[
            :CONTINUATION_TOKENS])
        agree = first_divergence(cont, truth)
        record["continuation"] = dict(
            tokens=len(cont), equal=sum(x == y for x, y in zip(cont, truth)),
            prefix_equal=len(cont) if agree is None else agree,
            text=tok.decode(cont), truth=tok.decode(truth))
        emit("train_continuation", **record["continuation"])

        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
        serving_guard = contextlib.ExitStack()
        inventory = serving_guard.enter_context(
            inventory_guard(eng, "phase 12 node"))
        node = ServingThread(lambda: tutoring_server.serve_args(
            node_args, eng, host="127.0.0.1"))
        address = f"127.0.0.1:{node.server._port}"

        def ask(query):
            t0 = time.monotonic()
            with grpc.insecure_channel(address) as ch:
                resp = rpc.TutoringStub(ch).GetLLMAnswer(
                    lms_pb2.QueryRequest(query=query), timeout=120)
            return resp, time.monotonic() - t0

        with concurrent.futures.ThreadPoolExecutor(len(QUESTIONS)) as ex:
            served = list(ex.map(ask, QUESTIONS))
        node.stop()
        node = None
        for (resp, _), want, q in zip(served, direct, QUESTIONS):
            check(resp.success and resp.response == want,
                  f"phase 12: the node's answer to {q!r} is not its "
                  f"engine's direct answer: {resp.response[:200]!r} vs "
                  f"{want[:200]!r}")
        launches = {**attention.launch_counts, **quant_matmul.launch_counts}
        decode_calls = eng.decode_steps - c0[0]
        model_calls = decode_calls + eng.admission_chunks - c0[1] + (
            eng.prefill_calls - c0[2])
        others = {k: v for k, v in attention.launch_counts.items()
                  if k != attention.APPEND_INT8KV and v}
        check(decode_calls > 0
              and launches[attention.APPEND_INT8KV] == 12 * decode_calls
              and not others,
              f"phase 12: launches {launches} for {decode_calls} decode "
              f"and {model_calls} model calls")
        check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
            quant_matmul, eng, decode_calls, eng.admission_chunks - c0[1],
            eng.prefill_calls - c0[2]), 48), "phase 12")
        serving_guard.close()
        emit("inventory_12", **inventory)
        record["serve"] = dict(inventory=inventory,
            answers_equal=len(served), warm_s=warm_s,
            answer_chars=[len(a) for a in direct],
            answer=percentiles([t for _, t in served]),
            decode_model_calls=decode_calls, model_calls=model_calls,
            launches=launches)
        emit("train_serve", **record["serve"])
        del eng
        torch.cuda.empty_cache()

        # (e) float32 witness: the deployment engine on the export, kernel
        # path (graphs, the append kernel, the int8 products on the CUDA
        # cores) against the plain path (eager, plain attention, both
        # int8 wrappers' plain versions): equal greedy tokens.
        f32 = dict(model=TRAIN_MODEL, checkpoint=export, quant="int8",
                   kv_quant=True, dtype=torch.float32,
                   param_dtype=torch.float32, seed=args.seed, device="cuda",
                   sampling=SamplingParams.greedy(max_new_tokens=32))
        keng = PagedEngine(EngineConfig(fused_attention=True, **f32),
                           slots=16, chunk=16, inflight=3, megastep=4,
                           megastep_max=8, prefix_cache=True,
                           prefix_cache_blocks=512, prefill_chunk_tokens=32)
        keng.warmup()
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (keng.decode_steps, keng.admission_chunks, keng.prefill_calls)
        kernel_toks = engine_tokens(keng, prompts)
        launches = {k: v for k, v in {**attention.launch_counts,
                                      **quant_matmul.launch_counts}.items()
                    if v}
        decode_calls = keng.decode_steps - c0[0]
        model_calls = decode_calls + keng.admission_chunks - c0[1] + (
            keng.prefill_calls - c0[2])
        want = {attention.APPEND_INT8KV: 12 * decode_calls,
                quant_matmul.KERNEL: 49 * model_calls,
                quant_matmul.FMA: 49 * model_calls}
        check(decode_calls > 0 and launches == want,
              f"phase 12 float32 witness: launches {launches} != {want}")
        del keng
        torch.cuda.empty_cache()
        peng = PagedEngine(EngineConfig(fused_attention=False, **f32),
                           slots=16, chunk=16, inflight=3, cuda_graphs=False)
        with plain_int8_products(quant_matmul):
            plain_toks = engine_tokens(peng, prompts)
        del peng
        firsts = [first_divergence(x, y)
                  for x, y in zip(kernel_toks, plain_toks)]
        record["f32_witness"] = dict(
            requests=len(prompts), equal=sum(f is None for f in firsts),
            first_divergence=[f for f in firsts if f is not None],
            tokens=sum(len(t) for t in kernel_toks),
            decode_model_calls=decode_calls, model_calls=model_calls,
            launches=launches)
        emit("train_f32_witness", **record["f32_witness"])
        check(record["f32_witness"]["equal"] == len(prompts),
              f"phase 12 float32 witness: greedy tokens differ between the "
              f"kernel and the plain path: {firsts}")
        os.remove(export)
        torch.cuda.empty_cache()

        # (f) gpt2-moe a few steps on the corpus's first batches, its
        # native export read back through moe.params_from_hf.
        _, moe_cfg = registry.resolve(MOE_TRAIN, torch.bfloat16,
                                      torch.float32)
        moe_ds = PackedDataset(dataset.blocks[:TRAIN_BATCH * MOE_TRAIN_STEPS],
                               DataConfig(batch_size=TRAIN_BATCH,
                                          seq_len=TRAIN_SEQ))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = trainer.fit("cuda", moe_cfg, trainer.TrainConfig(
            warmup_steps=1, decay_steps=MOE_TRAIN_STEPS), moe_ds, epochs=1,
            log_every=1)
        moe_s = time.monotonic() - t0
        mhist = res["history"]
        check(res["step"] == MOE_TRAIN_STEPS and len(mhist) == MOE_TRAIN_STEPS
              and all(math.isfinite(h["loss"])
                      and math.isfinite(h["moe_balance"])
                      and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
                      for h in mhist),
              f"phase 12 gpt2-moe: {mhist}")
        moe_path = str(tmp / "moe.safetensors")
        ckpt.export_model(moe_path, res["state"])
        moe32 = moe.GPT2MoEConfig.moe_small(dtype=torch.float32,
                                            param_dtype=torch.float32)
        back = moe.params_from_hf(convert.load_safetensors(moe_path), moe32,
                                  device="cuda")
        moe_export = export_logits_err(torch, res["state"]["params"], back,
                                       moe32, ids)
        check(moe_export["finite"] and moe_export["max_abs_err"]
              <= EXPORT_LOGIT_TOL * moe_export["logit_range"],
              f"phase 12 gpt2-moe export logits {moe_export}")
        record["moe"] = dict(
            steps=res["step"], seconds=moe_s,
            step_ms=[h["step_ms"] for h in mhist],
            losses=[h["loss"] for h in mhist],
            moe_balance=[h["moe_balance"] for h in mhist],
            grad_norms=[h["grad_norm"] for h in mhist],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            export=moe_export)
        emit("train_moe", card=card, **record["moe"])
        del res, back
        torch.cuda.empty_cache()
        record["seconds"] = time.monotonic() - t_phase
        return record
    finally:
        if node is not None:
            node.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------ phase 13: a seeded semester

# configs/cluster.toml [sim], held as the run's shape (the file is not
# edited; a change there must be read before this phase is trusted).
SIM_SHAPE = dict(students=24, duration_s=30.0, base_rate=8.0,
                 tutoring_nodes=3, course_concentration=0.6,
                 bulk_scoring=True, continuous_slos=True, events=True,
                 lms_groups=1, tutoring_engine="echo")
SIM_NODE = 0  # the tutoring node the deployment engine serves on
SIM_ATTEMPTS = 2  # semesters run at most (see sim_phase, step 3)


def course_of_prompt(gen, prompt: str):
    """The course whose deterministic context a node-0 prompt carries
    (`sim/workload.course_context`: on-topic asks and session chains
    under course_concentration > 0), else None (the ops bot's probes)."""
    for course in gen.courses:
        if gen.course_context(course) in prompt:
            return course
    return None


def sim_phase(torch, attention, quant_matmul, args, card) -> dict:
    """Phase 13: one seeded semester (see the module docstring)."""
    import dataclasses
    import shutil

    from distributed_lms_raft_llm_tpu_torch.config import load_config
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
    from distributed_lms_raft_llm_tpu_torch.engine.scoring import (
        encode_score_batch)
    from distributed_lms_raft_llm_tpu_torch.ops import build
    from distributed_lms_raft_llm_tpu_torch.serving import (
        lms_cluster,
        tutoring_server,
    )
    from distributed_lms_raft_llm_tpu_torch.sim import SemesterSim
    from distributed_lms_raft_llm_tpu_torch.sim import workload
    from distributed_lms_raft_llm_tpu_torch.utils import locks
    from distributed_lms_raft_llm_tpu_torch.utils import metrics_registry as mr

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sim_")
    record = {"card": card}
    try:
        # (1) The deployment file: [sim] as it stands. The sim binds
        # ephemeral ports and keeps its data under its own directory, so
        # one machine forces no change; the copy is what the run reads.
        path, applied = lms_cluster.deployment_copy(
            str(REPO / "configs" / "cluster.toml"), tmp, {})
        for line in applied:
            print(f"phase 13 config change: {line}", flush=True)
        if not applied:
            print("phase 13 config change: none ([sim] of configs/"
                  "cluster.toml as it stands; ephemeral ports, a "
                  "temporary data directory)", flush=True)
        cfg = load_config(path).sim
        shape = {k: getattr(cfg, k) for k in SIM_SHAPE}
        check(shape == SIM_SHAPE,
              f"phase 13: configs/cluster.toml [sim] is {shape}, not "
              f"{SIM_SHAPE}")
        record.update(config_changes=applied,
                      sim=dataclasses.asdict(cfg))
        gen = workload.WorkloadGenerator(cfg)

        # (2) Node 0's engine: the deployment engine of phases 4c and 11
        # from the copy's [tutoring] and [scoring] (bulk_scoring is on),
        # greedy as there, under phase 5's tokenizer. Greedy because a
        # stream broken mid-answer (a leader failover, a stall) resumes by
        # regenerating the answer and skipping the delivered tokens, which
        # reproduces the answer only without sampling.
        vocab, merges, tok_record = phase5_tokenizer(args, Path(tmp))
        node_args = tutoring_server.resolve_args([
            "--config", path, "--checkpoint", args.checkpoint or "",
            "--vocab", vocab, "--merges", merges, "--seed", str(args.seed),
            "--port", "0"])
        node_args.sampling_overrides = dict(GREEDY)
        check(node_args.model == "gpt2" and node_args.paged
              and node_args.quant == "int8" and node_args.kv_quant
              and node_args.slots == 16 and node_args.megastep == 4
              and node_args.megastep_max == 8 and node_args.prefix_cache
              and node_args.prefill_chunk_tokens == 32
              and node_args.scoring and node_args.device == "cuda",
              f"phase 13: the copy did not resolve to the deployment "
              f"config: {vars(node_args)}")
        node = {}

        def node0_engine():
            """Built, checked and warmed on the sim cluster's loop before
            any Raft node boots; the launch counters start at 0 here,
            after the warmup, just before the semester's traffic."""
            t0 = time.monotonic()
            builds0 = build.builds
            eng = tutoring_server.engine_from_args(node_args)
            cfg_m = eng.cfg
            check(isinstance(eng, PagedEngine) and eng.cuda_graphs
                  and eng.fused and cfg_m.quant_kv
                  and cfg_m.dtype == torch.bfloat16
                  and cfg_m.num_layers == 12 and cfg_m.hidden_size == 768
                  and cfg_m.num_heads == 12 and cfg_m.vocab_size == 50257
                  and eng.config.scoring and eng.score_shapes
                  and eng.slots == 16,
                  f"phase 13: node 0 is not the deployment engine at GPT-2 "
                  f"small's full width: {cfg_m}")
            init_s = time.monotonic() - t0
            warm_s = eng.warmup()
            rows = min(nb * bucket for nb, bucket in eng.score_shapes)
            check(quant_matmul.uses_wgmma(rows),
                  f"phase 13: a score shape of {rows} rows would leave "
                  f"the wgmma route")
            submit, step, score = eng.submit, eng.step, eng.score

            def counted_submit(prompt):
                rid = submit(prompt)
                node["prompts"][rid] = prompt
                return rid

            def counted_step():
                out = step()
                for rid, text in out:
                    node["finished"][rid] = text
                return out

            def counted_score(texts):
                ids, _, _ = encode_score_batch(eng, texts)
                node["score_rows"].append(int(ids.shape[0] * ids.shape[1]))
                return score(texts)

            eng.submit, eng.step, eng.score = (counted_submit, counted_step,
                                               counted_score)
            attention.reset_launch_counts()
            quant_matmul.reset_launch_counts()
            serving_guard = contextlib.ExitStack()
            node.update(
                engine=eng, init_s=init_s, warm_s=warm_s,
                builds_in_boot=build.builds - builds0,
                guard=serving_guard, inventory=serving_guard.enter_context(
                    inventory_guard(eng, "phase 13 node 0")),
                t_ready=time.monotonic(),
                c0=(eng.decode_steps, eng.admission_chunks,
                    eng.prefill_calls, eng.total_generated_tokens))
            return eng

        # (3) The semester. Node 0's /metrics and /healthz and every LMS
        # node's /healthz are read just before the cluster is torn down.
        # The fleet router places course keys by hashing the nodes'
        # ephemeral addresses, so a run may give node 0 no course's
        # question; the verdict holds for every run, and the same seeded
        # semester runs once more (a new ring) when node 0 got none.
        for attempt in range(1, SIM_ATTEMPTS + 1):
            node = {"prompts": {}, "finished": {}, "score_rows": []}
            semester = SemesterSim(
                cfg, os.path.join(tmp, f"semester{attempt}"),
                tutoring_engine_factory=node0_engine)
            cluster = semester.cluster

            def read_then_stop(cluster=cluster, stop=cluster.stop,
                               node=node):
                node["t_stop"] = time.monotonic()
                try:
                    node["metrics"] = cluster.tutoring_node_metrics(
                        SIM_NODE)
                    node["health"] = cluster.tutoring_healthz(SIM_NODE)
                    node["lms_health"] = {nid: cluster.healthz(nid)
                                          for nid in cluster.node_ids()}
                finally:
                    stop()

            cluster.stop = read_then_stop
            t_run = time.monotonic()
            sim_record = semester.run()
            run_s = time.monotonic() - t_run
            eng = node.pop("engine")
            launches = {**attention.launch_counts,
                        **quant_matmul.launch_counts}

            # (4) The record's own verdict.
            ledger = semester.ledger.report()
            failed_events = [e for e in sim_record["events"]
                             if not e["ok"]]
            slos = sim_record["slos"]
            failed_slos = {k: v for k, v in slos["checks"].items()
                           if not v["ok"]}
            violations = locks.violations()
            try:
                locks.assert_acyclic()
                acyclic = True
            except AssertionError:
                acyclic = False
            snap = semester.metrics.snapshot()
            ask = snap["latency"].get(mr.SIM_ASK_LATENCY, {})
            turn = snap["latency"].get(mr.SIM_TURN_TTFT, {})
            alerts = (sim_record["telemetry"] or {}).get("alerts", [])
            headline = dict(
                ask_p50_s=ask.get("p50_s"), ask_p95_s=ask.get("p95_s"),
                asks=ask.get("count", 0), turn_ttft_p95_s=turn.get("p95_s"),
                turns=turn.get("count", 0),
                degraded_answers=sim_record["degraded_answers"],
                degraded_rate=slos["checks"]["degraded_rate"]["observed"],
                acked_writes=ledger["acked_writes"],
                lost_acked_writes=len(ledger["losses"]),
                ryw_violations=len(ledger["ryw_violations"]),
                ops_planned=sim_record["ops_planned"],
                ops_ok=sim_record["ops_ok"],
                ops_failed=sim_record["ops_failed"],
                ops_dropped=sim_record["ops_dropped"],
                events=dict(sim_record["events_executed"]),
                events_failed=len(failed_events), alerts=len(alerts),
                alerts_during_fault=sum(1 for a in alerts
                                        if a.get("during_fault")),
                tick_stalls=slos["checks"]["tick_stalls"]["observed"],
                answer_p95_nodes=slos["checks"]["answer_p95_nodes"][
                    "observed"],
                lock_edges=len(locks.acquisition_edges()),
                lock_violations=len(violations), wall_s=run_s,
                trace_digest=sim_record["trace_digest"],
                event_digest=sim_record["event_digest"])
            emit("sim_record", **headline)
            record.update(headline=headline, slos=slos["checks"],
                          events=sim_record["events"], alerts=alerts,
                          fleet=sim_record["tutoring_fleet"],
                          scoring=sim_record["scoring"],
                          sessions=sim_record["sessions"],
                          stage_p95s=slos.get("stage_p95s"))
            check(sim_record["events"] and not failed_events,
                  f"phase 13: events failed: {failed_events}")
            check(slos["ok"], f"phase 13: SLOs missed: {failed_slos}")
            check(not ledger["losses"] and not ledger["ryw_violations"],
                  f"phase 13: ledger: {len(ledger['losses'])} lost acked "
                  f"writes {ledger['losses'][:3]}, read-your-writes "
                  f"{ledger['ryw_violations'][:3]}")
            check(slos["checks"]["no_false_alarms"]["ok"],
                  f"phase 13: false burn alarms: "
                  f"{slos['checks']['no_false_alarms']}")
            check(acyclic and not violations,
                  f"phase 13: lock graph: acyclic {acyclic}, violations "
                  f"{violations[:3]}")

            served = node["finished"]
            by_course = {}
            for rid, prompt in node["prompts"].items():
                course = course_of_prompt(gen, prompt) or "no course"
                row = by_course.setdefault(course, {"submitted": 0,
                                                    "answered": 0})
                row["submitted"] += 1
                row["answered"] += int(rid in served)
            courses_hit = [c for c in gen.courses
                           if by_course.get(c, {}).get("answered", 0) >= 1]
            record["attempts"] = attempt
            if courses_hit or attempt == SIM_ATTEMPTS:
                break
            print(f"phase 13: attempt {attempt}: node 0's ring share got "
                  f"no course's question ({by_course}); the same seeded "
                  f"semester again", flush=True)
            del eng
            torch.cuda.empty_cache()

        # (5) Node 0 really served on the deployment engine: its own
        # /metrics and /healthz, the engine's counters, by course.
        metrics = node["metrics"]
        counters = metrics.get("counters", {})
        ttft = metrics.get("latency", {}).get("ttft", {})
        decode = eng.decode_steps - node["c0"][0]
        admission = eng.admission_chunks - node["c0"][1]
        prefill = eng.prefill_calls - node["c0"][2]
        tokens = eng.total_generated_tokens - node["c0"][3]
        serve_s = node["t_stop"] - node["t_ready"]
        fleet_nodes = {}
        for health in node["lms_health"].values():
            for row in (health.get("tutoring_fleet") or {}).get("nodes", []):
                key = row.get("node_id") or row.get("address")
                fleet_nodes.setdefault(key, {"routes": 0, "served": 0})
                fleet_nodes[key]["routes"] += int(row.get("routes", 0))
                fleet_nodes[key]["served"] += int(row.get("served", 0))
        node_record = dict(
            engine=node["health"].get("engine"),
            node_id=node["health"].get("node_id"),
            llm_requests=counters.get("llm_requests", 0),
            llm_failures=counters.get("llm_failures", 0),
            shed=counters.get("shed_expired", 0)
            + counters.get("shed_overload", 0),
            ttft_count=ttft.get("count", 0), ttft_p50_s=ttft.get("p50_s"),
            ttft_p95_s=ttft.get("p95_s"),
            engine_submitted=len(node["prompts"]),
            engine_answered=len(served),
            by_course=by_course, tokens=tokens, serve_s=serve_s,
            tokens_per_s=tokens / serve_s,
            prefix_cache_hit_tokens=counters.get("prefix_cache_hit_tokens",
                                                 0),
            scoring_quanta=counters.get(mr.SCORING_QUANTA, 0),
            score_calls=len(node["score_rows"]),
            decode_model_calls=decode, admission_chunks=admission,
            prefills=prefill, init_s=node["init_s"],
            warmup_s=node["warm_s"], fleet_routes=fleet_nodes)
        emit("sim_node0", **node_record)
        record["node0"] = node_record
        check(node_record["engine"] == "PagedEngine"
              and node_record["node_id"] == f"tut{SIM_NODE}",
              f"phase 13: node 0's /healthz names {node['health']}")
        check(courses_hit and all(
            row["answered"] >= 1 for c, row in by_course.items()
            if c != "no course"),
              f"phase 13: node 0 answered no course's question, or left a "
              f"course it received unanswered: {by_course}")
        check(node_record["llm_requests"] >= node_record["engine_submitted"]
              >= node_record["engine_answered"] >= 1
              and node_record["ttft_count"] == node_record["engine_answered"]
              and tokens > 0,
              f"phase 13: node 0's /metrics and its engine disagree: "
              f"{node_record}")
        check(node_record["scoring_quanta"] == node_record["score_calls"],
              f"phase 13: scoring_quanta {node_record['scoring_quanta']} != "
              f"the engine's score calls {node_record['score_calls']}")

        # (6) Launches over the semester, through the graph replays, exact
        # by route; node 0's compile guard closes here.
        others = {k: v for k, v in attention.launch_counts.items()
                  if k != attention.APPEND_INT8KV and v}
        check(decode > 0 and launches[attention.APPEND_INT8KV] == 12 * decode
              and not others,
              f"phase 13: attention launches {attention.launch_counts} for "
              f"{decode} decode model calls")
        calls = paged_calls(quant_matmul, eng, decode, admission, prefill)
        calls += [(1, rows) for rows in node["score_rows"]]
        check_int8_routes(launches, int8_want(quant_matmul, calls, 48),
                          "phase 13")
        node["guard"].close()
        emit("inventory_13", **node["inventory"])
        record["inventory"] = node["inventory"]
        check(node["builds_in_boot"] == 0,
              f"phase 13: {node['builds_in_boot']} kernel builds in node 0's "
              f"boot")
        record["launches"] = {k: v for k, v in launches.items() if v}
        emit("sim_launches", decode_model_calls=decode,
             admission_chunks=admission, prefills=prefill,
             score_quanta=len(node["score_rows"]),
             score_rows=sorted(set(node["score_rows"])),
             launches=record["launches"])
        del eng
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record["seconds"] = time.monotonic() - t_phase
    emit("sim_phase", seconds=record["seconds"], card=card)
    return record


# ------------------------------- phase 14: tensor parallelism

TP = 2                       # tp ranks, two processes on the one card
TP_BACKEND = "gloo"          # two ranks share the card: NCCL refuses that
TP_LAYERS = 4                # Llama-3-8B's widths, depth cut to 4 (of 32)
TP_MODEL = "llama3-8b-4-layers-tp"  # its preset, registered by phase 14
TP_WITNESS_REQUESTS, TP_WITNESS_TOKENS = 4, 16
TP_DEPLOY_REQUESTS, TP_DEPLOY_TOKENS = 8, 32
TP_ROWS = (16, 512)          # the int8 products at decode's and a quantum's
TP_RANK_TIMEOUT_S = 720.0    # phases 14 and 15 on the ranks
# bf16 at tp 2 beside tp 1: a greedy answer may part from tp 1's only
# where tp 1's top-2 logit margin is below TP_BF16_MARGIN_MAX (the
# partial products round to bf16 before the all-reduce sums them; the
# divergences read before this check sat at margins up to 0.047); and one
# forward's bf16 logits at tp 2 may sit no further from the float32
# model's (tp 1), nor from tp 1's bf16 ones, than TP_BF16_ERR_RATIO times
# tp 1's bf16 logits sit from the float32 ones: bf16's own error at tp 1
# is the floor (relative norms; a row-parallel sum dropped, doubled or
# mis-scaled moves them by the order of 1).
TP_BF16_MARGIN_MAX = 0.1
TP_BF16_ERR_RATIO = 2.0
# The deployment config's engine options (configs/cluster.toml
# [tutoring]), eager: gloo's collectives cannot be captured.
TP_DEPLOY_KW = dict(slots=16, chunk=16, inflight=3, megastep=4,
                    megastep_max=8, prefix_cache=True,
                    prefix_cache_blocks=512, prefill_chunk_tokens=32,
                    cuda_graphs=False)


def tp_register_preset():
    """Register TP_MODEL (Llama-3-8B at TP_LAYERS layers) in this
    process."""
    import functools

    from distributed_lms_raft_llm_tpu_torch.models import llama, registry

    registry.PRESETS[TP_MODEL] = (registry.LLAMA_FAMILY, functools.partial(
        llama.LlamaConfig.llama3_8b, num_layers=TP_LAYERS))


def tp_configs(torch, seed, tp):
    """(float32 witness config, bf16 deployment config) at `tp`."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    base = dict(model=TP_MODEL, quant="int8", kv_quant=True, seed=seed,
                device="cuda", tp=tp)
    witness = EngineConfig(
        dtype=torch.float32, param_dtype=torch.float32,
        sampling=SamplingParams.greedy(max_new_tokens=TP_WITNESS_TOKENS),
        **base)
    deploy = EngineConfig(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        sampling=SamplingParams.greedy(max_new_tokens=TP_DEPLOY_TOKENS),
        **base)
    return witness, deploy


def tp_prompts():
    """The witness's prompts (framed QUESTIONS, a 256-token bucket) and the
    deployment's (the bare QUESTIONS: one or two 32-token admission chunks
    each, so the fused admission's decode chunks stay few, each forward
    paying ten collectives through host memory)."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    framed = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    return framed[:TP_WITNESS_REQUESTS], list(QUESTIONS[:TP_DEPLOY_REQUESTS])


def watched_tokens(eng, prompts):
    """Submit `prompts` at once (each watched), drain, and return each
    one's final tokens in submit order."""
    rids = [eng.submit(p) for p in prompts]
    for rid in rids:
        eng.stream_watch(rid)
    eng.drain()
    finals = eng.pop_final_tokens()
    return [finals[r] for r in rids]


def queue_tokens(torch, eng, prompts):
    """`prompts` through one PagedQueue, all submitted before it starts,
    each watched: (answers, tokens, wall seconds, metrics snapshot)."""
    from distributed_lms_raft_llm_tpu_torch.engine import PagedQueue
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    submit, rids = eng.submit, []

    def watched(prompt):
        rid = submit(prompt)
        eng.stream_watch(rid)
        rids.append(rid)
        return rid

    eng.submit = watched
    try:
        answers, wall, snap = run_paged_waves(
            eng, PagedQueue, Metrics, prompts, [], ready=lambda: True)
    finally:
        del eng.submit
    finals = eng.pop_final_tokens()
    return answers, [finals[r] for r in rids], wall, snap


def tp_launches(attention, quant_matmul, eng, c0) -> dict:
    """Calls since `c0` (decode, admission chunks, prefills) and the
    launches, with the exact counts a Llama model call of TP_LAYERS layers
    must make: the append kernel a layer a decode call, and 7 products a
    layer and the unembedding a model call on each route."""
    decode = eng.decode_steps - c0[0]
    adm = eng.admission_chunks - c0[1]
    prefill = eng.prefill_calls - c0[2]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    if str(eng.cfg.dtype) == "torch.float32":
        model = decode + adm + prefill
        int8 = {quant_matmul.FMA: (7 * TP_LAYERS + 1) * model,
                quant_matmul.KERNEL: (7 * TP_LAYERS + 1) * model}
    else:
        int8 = int8_want(quant_matmul, paged_calls(
            quant_matmul, eng, decode, adm, prefill), 7 * TP_LAYERS)
    attn = {name: launches.get(name, 0) for name in attention.launch_counts}
    want_attn = {name: 0 for name in attention.launch_counts}
    want_attn[attention.APPEND_INT8KV] = TP_LAYERS * decode
    return dict(decode_calls=decode, admission_chunks=adm, prefills=prefill,
                launches={k: v for k, v in launches.items() if v},
                exact=(decode > 0 and attn == want_attn and all(
                    launches.get(k, 0) == v for k, v in int8.items())),
                want_int8={k: v for k, v in int8.items() if v})


def tp_rank_main(args) -> int:
    """One tp rank of phase 14 (a process this script starts): join the
    gloo group on the card, then run the float32 witness, the deployment
    config through PagedQueue (rank 0; rank 1 follows) and the refusal
    check, and write this rank's record to `args.tp_out`."""
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
    from distributed_lms_raft_llm_tpu_torch.ops import attention, quant_matmul
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    rank = args.tp_rank
    mesh.init_process_group(TP_BACKEND, args.tp_init, TP, rank)
    tp_register_preset()
    witness_cfg, deploy_cfg = tp_configs(torch, args.seed, TP)
    w_prompts, d_prompts = tp_prompts()
    rec = dict(rank=rank)
    t0 = time.monotonic()

    def run(eng, drive, count=tp_launches):
        """Rank 0 drives `eng` and returns what `drive` does; a follower
        returns the final tokens of the rids rank 0 watched, by rid (the
        results of its replayed calls by name where `eng` watches none).
        With the launches `count` reads since the run began."""
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (getattr(eng, "decode_steps", 0),
              getattr(eng, "admission_chunks", 0),
              getattr(eng, "prefill_calls", 0))
        if rank == 0:
            out = drive()
            eng.stop_followers()
        else:
            out = {}

            def keep(name, result):
                if hasattr(eng, "pop_final_tokens"):
                    out.update(eng.pop_final_tokens())
                else:
                    out[name] = result

            eng.follow(keep)
        torch.cuda.synchronize()
        return out, count(attention, quant_matmul, eng, c0)

    def in_order(finals):
        return [finals[r] for r in sorted(finals)]

    # (a) The float32 witness, eager.
    eng = PagedEngine(witness_cfg, slots=TP_WITNESS_REQUESTS, chunk=4,
                      cuda_graphs=False)
    toks, counts = run(eng, lambda: watched_tokens(eng, w_prompts))
    rec["witness"] = dict(
        tokens=toks if rank == 0 else in_order(toks),
        kv_bytes_per_chip=eng.kv_bytes_per_chip, tp=eng.tp,
        cache_heads=eng.state.cache.k.shape[2], decisions=list(
            eng.decisions), **counts)
    del eng
    torch.cuda.empty_cache()

    # (b) The deployment config at tp 2, eager, through PagedQueue.
    eng = PagedEngine(deploy_cfg, **TP_DEPLOY_KW)
    rec["deploy_config"] = dict(
        tp=eng.tp, fused=eng.fused, megastep_ks=eng.megastep_ks,
        prefix_cache=eng.prefix_cache is not None, cuda_graphs=eng.cuda_graphs,
        quant_kv=eng.cfg.quant_kv, dtype=str(eng.cfg.dtype),
        hidden=eng.cfg.hidden_size, layers=eng.cfg.num_layers,
        heads=eng.cfg.local_heads, kv_heads=eng.cfg.local_kv_heads,
        vocab=eng.cfg.vocab_size, lm_head_rows=eng.params["lm_head"][
            "q"].shape[0], kv_bytes_per_chip=eng.kv_bytes_per_chip,
        kv_planes_bytes=sum(x.numel() * x.element_size() for x in (
            eng._kv.k, eng._kv.v, eng._kv.ks, eng._kv.vs)))
    out, counts = run(eng, lambda: queue_tokens(torch, eng, d_prompts))
    if rank == 0:
        answers, toks, wall, snap = out
        rec["deploy"] = dict(
            answers=answers, tokens=toks, wall_s=wall,
            serving_tp=snap["gauges"].get("serving_tp"),
            serving_kv_bytes_per_chip=snap["gauges"].get(
                "serving_kv_bytes_per_chip"),
            prefix_hit_tokens=snap["counters"].get(
                "prefix_cache_hit_tokens", 0), **counts)
    else:
        rec["deploy"] = dict(tokens=in_order(out), **counts)
    rec["deploy"]["decisions"] = list(eng.decisions)
    # The bf16 logits of the first prompt (every rank runs the forward:
    # its collectives pair up), for the parent to hold against tp 1's.
    torch.save(prompt_logits(torch, eng, d_prompts[0]),
               f"{args.tp_out}.logits.pt")
    del eng
    torch.cuda.empty_cache()

    # What one collective of the decode call costs here: the row-parallel
    # all-reduce of [16, 4,096] bf16 and the logits' all-gather of
    # [16, 64,128] float32, through host memory and the loopback.
    tp = mesh.make_mesh({"tp": TP}).tensor_parallel()
    x = torch.zeros((16, 4096), dtype=torch.bfloat16,
                    device=deploy_cfg.device)
    y = torch.zeros((16, 128256 // TP), dtype=torch.float32,
                    device=deploy_cfg.device)

    def per_call_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    rec["collective_ms"] = dict(
        all_reduce_bf16_16x4096=per_call_ms(lambda: tp.all_reduce(x)),
        all_gather_f32_16x64128=per_call_ms(lambda: tp.all_gather(y)))

    # A refusal: CUDA graphs over gloo.
    try:
        PagedEngine(deploy_cfg, **dict(TP_DEPLOY_KW, cuda_graphs=True))
        rec["graphs_refusal"] = None
    except ValueError as e:
        rec["graphs_refusal"] = str(e)
    rec["seconds"] = time.monotonic() - t0

    # Phase 15 in the same two processes: expert parallelism, sequence
    # parallel scoring and the gate's tp.
    rec["ep_sp_gate"] = ep_rank_phase(torch, attention, quant_matmul, args,
                                      rank, run)
    # Phase 16 in the same two processes: the sharded trainer.
    rec["train_sharded"] = train_rank_phase(torch, args, rank)
    # Phase 17 in the same two processes: dp inside one engine.
    rec["dp"] = dp_rank_phase(torch, attention, quant_matmul, args, rank,
                              run)
    Path(args.tp_out).write_text(json.dumps(rec))
    from torch import distributed as dist

    dist.destroy_process_group()
    return 0


def tp_kernel_cases(torch, attention, quant_matmul) -> dict:
    """Phase 14 (c): every kernel a tp rank runs, at its shard's shapes,
    against its plain version (each helper raises where they disagree):
    the int8 append kernel at 16 of 32 query heads over 4 of 8 KV heads,
    and Llama-3-8B's products' halves (LLAMA_TP2_PRODUCTS) at M = 16 and
    512, each beside cuBLAS and its bound."""
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_int8

    append = append_attention_case(torch, attention, s=16, width=384,
                                   cache="int8", h=32 // TP, hkv=8 // TP,
                                   dh=128, seed=140)
    emit("tp_append_attention_case", **append)
    mm = []
    for name in sweep_int8.LLAMA_TP2_PRODUCTS:
        for m in TP_ROWS:
            mm.append(sweep_int8.int8_matmul_case(name=name, m=m,
                                                  dtype="bfloat16"))
            emit("tp_int8_matmul_case", **mm[-1])
    return dict(append=append, int8_matmul=mm)


def tp_phase(torch, attention, quant_matmul, args, card) -> dict:
    """Phase 14 (see the module docstring). Returns its record."""
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
    from distributed_lms_raft_llm_tpu_torch.models import registry

    t_phase = time.monotonic()
    rec = dict(card=card, tp=TP, backend=TP_BACKEND, layers=TP_LAYERS)
    # (c) first, alone on the card, so its times see no other process.
    rec["kernels"] = tp_kernel_cases(torch, attention, quant_matmul)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    init = f"file://{tmp}/rendezvous"
    outs = [Path(tmp) / f"rank{r}.json" for r in range(TP)]
    logs = [open(Path(tmp) / f"rank{r}.log", "wb") for r in range(TP)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--tp-rank", str(r),
         "--tp-init", init, "--tp-out", str(outs[r]), "--seed",
         str(args.seed)], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=str(REPO)) for r in range(TP)]
    tp_register_preset()
    try:
        # The tp 1 references, in this process while the ranks run.
        w_prompts, d_prompts = tp_prompts()
        witness_cfg, deploy_cfg = tp_configs(torch, args.seed, 1)
        eng = PagedEngine(witness_cfg, slots=TP_WITNESS_REQUESTS, chunk=4,
                          cuda_graphs=False)
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls)
        ref_w = watched_tokens(eng, w_prompts)
        ref_w_counts = tp_launches(attention, quant_matmul, eng, c0)
        f32_logits = prompt_logits(torch, eng, d_prompts[0])
        ref_w_kv = eng.kv_bytes_per_chip
        del eng
        torch.cuda.empty_cache()
        ref = PagedEngine(deploy_cfg, **TP_DEPLOY_KW)
        ref_kv = ref.kv_bytes_per_chip
        ref_planes = sum(x.numel() * x.element_size() for x in (
            ref._kv.k, ref._kv.v, ref._kv.ks, ref._kv.vs))
        ref_answers, ref_d, ref_wall, _ = queue_tokens(torch, ref, d_prompts)
        ref_calls = ref.decode_steps + ref.admission_chunks + ref.prefill_calls
        # Phase 15's one-rank references, while the ranks run on.
        refs15 = ep_references(torch, attention, quant_matmul, args)
        # Phase 16's one-rank references.
        refs16 = train_references(torch, args, Path(tmp))
        # Phase 17's dp-1 references.
        refs17 = dp_references(torch, attention, quant_matmul, args)
        deadline = time.monotonic() + TP_RANK_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
        registry.PRESETS.pop(TP_MODEL, None)
    tails = [(Path(tmp) / f"rank{r}.log").read_text(errors="replace")[-3000:]
             for r in range(TP)]
    check(all(p.returncode == 0 for p in procs) and all(
        o.exists() for o in outs),
          f"phase 14: a tp rank failed: exit codes "
          f"{[p.returncode for p in procs]}\n" + "\n".join(tails))
    ranks = [json.loads(o.read_text()) for o in outs]
    lead, follow = ranks

    # (a) float32: tp 1 and tp 2 byte-equal, both ranks the same tokens.
    firsts = [first_divergence(a, b) for a, b in zip(lead["witness"][
        "tokens"], ref_w)]
    rec["witness"] = dict(
        requests=len(ref_w), new_tokens=TP_WITNESS_TOKENS,
        equal_tp1=sum(f is None for f in firsts), first_divergence=firsts,
        ranks_equal=follow["witness"]["tokens"] == lead["witness"]["tokens"],
        decisions_equal=(follow["witness"]["decisions"]
                         == lead["witness"]["decisions"]),
        tp1=dict(ref_w_counts, kv_bytes_per_chip=ref_w_kv),
        ranks=[{k: r["witness"][k] for k in (
            "decode_calls", "admission_chunks", "prefills", "launches",
            "exact", "kv_bytes_per_chip", "cache_heads")} for r in ranks])
    emit("tp_f32_witness", **rec["witness"])
    check(rec["witness"]["equal_tp1"] == len(ref_w)
          and rec["witness"]["ranks_equal"]
          and rec["witness"]["decisions_equal"],
          f"phase 14: float32 greedy tokens at tp 2 differ from tp 1 or "
          f"between the ranks: {rec['witness']}")
    check(ref_w_counts["exact"] and all(r["witness"]["exact"] for r in ranks)
          and all(r["witness"]["launches"] == lead["witness"]["launches"]
                  for r in ranks),
          f"phase 14 witness: launches not exact on every rank: "
          f"{rec['witness']}")

    # (b) The deployment config at tp 2.
    dcfg = lead["deploy_config"]
    check(all(r["deploy_config"] == dcfg for r in ranks)
          and dcfg["tp"] == TP and dcfg["fused"] and dcfg["prefix_cache"]
          and dcfg["megastep_ks"] == [1, 2, 4, 8]
          and not dcfg["cuda_graphs"] and dcfg["quant_kv"]
          and dcfg["hidden"] == 4096 and dcfg["layers"] == TP_LAYERS
          and dcfg["heads"] == 32 // TP and dcfg["kv_heads"] == 8 // TP
          and dcfg["vocab"] == 128256 and dcfg["lm_head_rows"] == 128256 // TP,
          f"phase 14: not Llama-3-8B's widths on the deployment config at "
          f"tp {TP}: {dcfg}")
    check(dcfg["kv_bytes_per_chip"] * TP == ref_kv
          and dcfg["kv_planes_bytes"] * TP == ref_planes,
          f"phase 14: a rank's KV bytes {dcfg['kv_bytes_per_chip']} "
          f"(planes {dcfg['kv_planes_bytes']}) are not 1/{TP} of tp 1's "
          f"{ref_kv} ({ref_planes})")
    deploy = lead["deploy"]
    check(deploy["serving_tp"] == float(TP)
          and deploy["serving_kv_bytes_per_chip"] is not None,
          f"phase 14: serving_tp {deploy['serving_tp']}")
    check(len(deploy["answers"]) == TP_DEPLOY_REQUESTS
          and all(isinstance(a, str) for a in deploy["answers"])
          and follow["deploy"]["tokens"] == deploy["tokens"]
          and follow["deploy"]["decisions"] == deploy["decisions"],
          "phase 14: the deployment's ranks disagree (tokens or host "
          "decisions) or an answer is missing")
    check(all(r["deploy"]["exact"] for r in ranks)
          and all(r["deploy"]["launches"] == deploy["launches"]
                  for r in ranks) and deploy["admission_chunks"] > 0,
          f"phase 14 deployment: launches by route not exact on every rank: "
          f"{[(r['deploy']['launches'], r['deploy']['want_int8']) for r in ranks]}")
    # bf16 tokens beside tp 1's: the first divergence of each differing
    # answer, with the top-2 margin of tp 1's logits there (where tp 1's
    # answer ends first, at its end of sequence).
    diverged = []
    for i, (a, b) in enumerate(zip(deploy["tokens"], ref_d)):
        j = first_divergence(a, b)
        if j is not None:
            diverged.append(dict(request=i, token=j, top2_margin=(
                divergence_margin(torch, ref, d_prompts[i], b, j))))
    # The first prompt's logits: each rank's gathered bf16 ones against
    # tp 1's bf16 ones and the float32 model's, beside bf16's own error at
    # tp 1 (relative norms).
    ref_logits = prompt_logits(torch, ref, d_prompts[0])
    tp_logits = [torch.load(f"{o}.logits.pt") for o in outs]

    def rel(x, y):
        return ((x - y).norm() / y.norm()).item()

    logits_floor = rel(ref_logits, f32_logits)
    logits_rel = [rel(x, ref_logits) for x in tp_logits]
    logits_rel_f32 = [rel(x, f32_logits) for x in tp_logits]
    logits_max_abs = [(x - ref_logits).abs().max().item() for x in tp_logits]
    del ref
    torch.cuda.empty_cache()
    rec["deploy"] = dict(
        requests=TP_DEPLOY_REQUESTS, new_tokens=TP_DEPLOY_TOKENS,
        tokens_equal_tp1=TP_DEPLOY_REQUESTS - len(diverged),
        diverged=diverged, margin_max=TP_BF16_MARGIN_MAX,
        answers_equal_tp1=sum(
            a == b for a, b in zip(deploy["answers"], ref_answers)),
        logits_rel_err_tp1=logits_rel, logits_rel_err_f32=logits_rel_f32,
        logits_rel_err_tp1_f32=logits_floor,
        logits_max_abs_err_tp1=logits_max_abs,
        logits_ref_max_abs=ref_logits.abs().max().item(),
        logits_err_ratio_max=TP_BF16_ERR_RATIO,
        logits_ranks_equal=bool(torch.equal(*tp_logits)),
        wall_s=deploy["wall_s"], wall_s_tp1=ref_wall,
        ms_per_model_call=deploy["wall_s"] * 1e3 / (
            deploy["decode_calls"] + deploy["admission_chunks"]
            + deploy["prefills"]),
        ms_per_model_call_tp1=ref_wall * 1e3 / ref_calls,
        serving_tp=deploy["serving_tp"],
        serving_kv_bytes_per_chip=deploy["serving_kv_bytes_per_chip"],
        kv_bytes_per_chip=dcfg["kv_bytes_per_chip"], kv_bytes_tp1=ref_kv,
        prefix_hit_tokens=deploy["prefix_hit_tokens"],
        ranks=[{k: r["deploy"][k] for k in (
            "decode_calls", "admission_chunks", "prefills", "launches",
            "exact")} for r in ranks])
    emit("tp_deployment", **rec["deploy"])
    check(all(d["top2_margin"] < TP_BF16_MARGIN_MAX for d in diverged),
          f"phase 14: a bf16 answer at tp {TP} parts from tp 1's where tp "
          f"1's top-2 margin is not below {TP_BF16_MARGIN_MAX}: {diverged}")
    # The floor is bf16's rounding of one set of weights (each drawn in
    # float32, then cast): near 1 it would say the two models differ.
    check(logits_floor < 0.1, f"phase 14: tp 1's bf16 logits are "
          f"{logits_floor} (relative) from the float32 model's: not the "
          f"same weights")
    check(rec["deploy"]["logits_ranks_equal"]
          and max(logits_rel + logits_rel_f32)
          <= TP_BF16_ERR_RATIO * logits_floor,
          f"phase 14: bf16 logits at tp {TP}: relative error {logits_rel} "
          f"against tp 1's, {logits_rel_f32} against float32's, beyond "
          f"{TP_BF16_ERR_RATIO} x tp 1's own {logits_floor}; ranks equal "
          f"{rec['deploy']['logits_ranks_equal']}")
    rec["graphs_refusal"] = [r["graphs_refusal"] for r in ranks]
    check(all(m and "cuda_graphs over the gloo backend" in m
              for m in rec["graphs_refusal"]),
          f"phase 14: cuda_graphs=True over gloo did not raise: "
          f"{rec['graphs_refusal']}")
    rec["collective_ms"] = lead["collective_ms"]
    rec["rank_seconds"] = [r["seconds"] for r in ranks]
    rec["seconds"] = time.monotonic() - t_phase
    rec["launches"] = lead["deploy"]["launches"]
    emit("tp", **{k: rec[k] for k in ("card", "tp", "backend", "layers",
                                      "graphs_refusal", "collective_ms",
                                      "rank_seconds", "seconds")})
    # Phase 15's checks on the same ranks' records.
    rec["ep_sp_gate"] = ep_phase_checks(torch, attention, quant_matmul,
                                        args, ranks, refs15, outs, card)
    del refs15
    torch.cuda.empty_cache()
    # Phase 16's checks on the same ranks' records.
    rec["train_sharded"] = train_phase_checks(torch, args, ranks, refs16,
                                              tmp, card)
    # Phase 17's checks on the same ranks' records.
    rec["dp"] = dp_phase_checks(attention, ranks, refs17, card)
    return rec


# ---------------------------- phase 15: expert, sequence and the gate's tp

EP = 2                        # ep ranks: phase 14's two processes
EP_MODEL = "gpt2-moe"         # GPT-2 small's trunk, 8 experts, top-2
EP_LAYER_PRODUCTS = 2         # dense int8 products a layer (qkv, attn out)
EP_QUANTUM = (8, 256)         # a scoring quantum: texts x tokens, C = 640
# ep 1's bf16 logits against its float32 model's, at most: the same
# weights (two unrelated models' logits sit ~1.4 apart, relative).
EP_SAME_WEIGHTS = 0.5
SP = 2                        # sp ranks: the same two processes
SP_MODEL = "gpt2"             # GPT-2 small
SP_BUCKETS = (256, 1024)      # the texts fill the 1,024-token bucket
SP_TEXTS, SP_TOKENS = 2, 1000
SP_F32_RTOL = 1e-5            # float32 sp 2 against sp 1, each text
SP_BF16_ERR_RATIO = 2.0       # bf16 sp 2 against bf16's own error at sp 1
GATE_TP = 2                   # the gate's tp ranks: the same two
GATE_TP_TOL = TOLERANCE["bfloat16"]  # tp 2's similarity against tp 1's
GATE_TP_PAIRS = 8
# Phase 15 (d): a graphed engine on GPT-2 small's deployment options,
# small enough to capture quickly (one prompt bucket, so one width).
FREE_KW = dict(slots=4, chunk=4, inflight=2, megastep=2, megastep_max=2,
               prefix_cache=True, prefix_cache_blocks=64,
               prefill_chunk_tokens=32)


def ep_configs(torch, seed, ep):
    """(float32 witness config, bf16 deployment config) of gpt2-moe at
    `ep`, int8 weights and KV (configs/cluster.toml [tutoring])."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    base = dict(model=EP_MODEL, quant="int8", kv_quant=True, seed=seed,
                device="cuda", ep=ep, scoring=True)
    witness = EngineConfig(
        dtype=torch.float32, param_dtype=torch.float32,
        sampling=SamplingParams.greedy(max_new_tokens=TP_WITNESS_TOKENS),
        **base)
    deploy = EngineConfig(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        sampling=SamplingParams.greedy(max_new_tokens=TP_DEPLOY_TOKENS),
        **base)
    return witness, deploy


def sp_config(torch, seed, sp, dtype):
    """GPT-2 small's scoring engine at `sp`: int8 weights, the 1,024-token
    bucket."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    return EngineConfig(
        model=SP_MODEL, quant="int8", dtype=dtype, param_dtype=dtype,
        seed=seed, device="cuda", sp=sp, length_buckets=SP_BUCKETS,
        batch_buckets=(1, 2), sampling=SamplingParams.greedy(
            max_new_tokens=16))


def gate_tp_config(torch, tp):
    """The deployment's gate ([gate]: bert-base, int8, bf16) at `tp`."""
    from distributed_lms_raft_llm_tpu_torch.engine import GateConfig

    return GateConfig(quant="int8", dtype=torch.bfloat16, device="cuda",
                      tp=tp, threshold=GATE_THRESHOLD)


def gate_tp_pairs():
    """Phase 15 (c)'s 8 pairs: a course question each against the course
    notes, half of them cut short."""
    return [(q, GATE_NOTES[:120 + 40 * i])
            for i, q in enumerate(QUESTIONS[:GATE_TP_PAIRS])]


def expert_bytes(params) -> int:
    """Bytes of the expert stacks a rank holds (int8 q, scales, biases)."""
    total = 0
    for name in ("wi", "wo", "bi", "bo"):
        leaf = params["blocks"]["moe"][name]
        for x in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            total += x.numel() * x.element_size()
    return total


def moe_launches(attention, quant_matmul, eng, c0, quanta=0) -> dict:
    """Phase 14's `tp_launches` for gpt2-moe's paged engine: per model call
    24 dense products (qkv and the attention out a layer), the
    unembedding and 24 expert launches (wi and wo a layer, E / ep experts
    each), the append kernel a layer a decode call; and `quanta` scoring
    quanta of EP_QUANTUM (bf16) besides."""
    decode = eng.decode_steps - c0[0]
    adm = eng.admission_chunks - c0[1]
    prefill = eng.prefill_calls - c0[2]
    layers = eng.cfg.num_layers
    dense = EP_LAYER_PRODUCTS * layers
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    if str(eng.cfg.dtype) == "torch.float32":
        model = decode + adm + prefill
        int8 = {quant_matmul.FMA: (dense + 1) * model,
                quant_matmul.FMA_EXPERTS: 2 * layers * model,
                quant_matmul.KERNEL: (dense + 1 + 2 * layers) * model}
    else:
        int8 = int8_want(quant_matmul, paged_calls(
            quant_matmul, eng, decode, adm, prefill) + [
                (quanta, EP_QUANTUM[0] * EP_QUANTUM[1])], dense,
            experts=2 * layers, moe_cfg=eng.cfg)
    attn = {name: launches.get(name, 0) for name in attention.launch_counts}
    want_attn = {name: 0 for name in attention.launch_counts}
    want_attn[attention.APPEND_INT8KV] = layers * decode
    return dict(decode_calls=decode, admission_chunks=adm, prefills=prefill,
                launches={k: v for k, v in launches.items() if v},
                exact=(decode > 0 and attn == want_attn and all(
                    launches.get(k, 0) == v for k, v in int8.items())),
                want_int8={k: v for k, v in int8.items() if v})


def forward_launches(rows, dense, unembed=True, experts=0,
                     calls_of=lambda eng: 1):
    """A launch count for runs of whole forwards (a scoring quantum, the
    gate's checks): `calls_of(eng)` forwards since the run began, each
    `dense` int8 products, the unembedding where `unembed`, and `experts`
    expert launches over `rows` token rows (a product's route follows its
    rows: the wgmma route from WGMMA_MIN_ROWS), and no attention kernel."""

    def count(attention, quant_matmul, eng, c0) -> dict:
        launches = {**attention.launch_counts, **quant_matmul.launch_counts}
        calls = calls_of(eng)
        if str(eng.cfg.dtype) == "torch.float32":
            int8 = {quant_matmul.FMA: (dense + unembed) * calls,
                    quant_matmul.FMA_EXPERTS: experts * calls,
                    quant_matmul.KERNEL: (dense + unembed + experts) * calls}
        else:
            int8 = int8_want(quant_matmul, [(calls, rows)], dense,
                             experts=experts,
                             moe_cfg=eng.cfg if experts else None)
            if not unembed:
                int8[quant_matmul.KERNEL] -= calls
                int8[quant_matmul.MMA_UNEMBED] = 0
                int8[quant_matmul.WGMMA_UNEMBED] = 0
        attn = sum(launches.get(name, 0) for name in attention.launch_counts)
        return dict(forwards=calls,
                    launches={k: v for k, v in launches.items() if v},
                    exact=(calls > 0 and attn == 0 and all(
                        launches.get(k, 0) == v for k, v in int8.items())),
                    want_int8={k: v for k, v in int8.items() if v})

    return count


def ep_rank_phase(torch, attention, quant_matmul, args, rank, run) -> dict:
    """Phase 15 on one of phase 14's two rank processes (see the module
    docstring): (a) gpt2-moe over two ep ranks, (b) GPT-2 small's scoring
    over two sp ranks, (c) the gate over two tp ranks; rank 0 drives,
    rank 1 follows (`run`). Returns this rank's record."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        RelevanceGate,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh, ring

    t0 = time.monotonic()
    rec = dict(rank=rank)

    def in_order(finals):
        return [finals[r] for r in sorted(finals)]

    # (a) gpt2-moe at ep 2: the float32 witness, then the deployment
    # config and a scoring quantum.
    witness_cfg, deploy_cfg = ep_configs(torch, args.seed, EP)
    w_prompts, d_prompts = tp_prompts()
    eng = PagedEngine(witness_cfg, slots=TP_WITNESS_REQUESTS, chunk=4,
                      cuda_graphs=False)
    toks, counts = run(eng, lambda: watched_tokens(eng, w_prompts),
                       moe_launches)
    rec["witness"] = dict(
        tokens=toks if rank == 0 else in_order(toks), ep=eng.ep,
        experts=eng.cfg.local_experts, expert_bytes=expert_bytes(
            eng.params), decisions=list(eng.decisions), **counts)
    del eng
    torch.cuda.empty_cache()
    eng = PagedEngine(deploy_cfg, **TP_DEPLOY_KW)
    rec["deploy_config"] = dict(
        ep=eng.ep, tp=eng.tp, fused=eng.fused, megastep_ks=eng.megastep_ks,
        prefix_cache=eng.prefix_cache is not None,
        cuda_graphs=eng.cuda_graphs, quant_kv=eng.cfg.quant_kv,
        dtype=str(eng.cfg.dtype), hidden=eng.cfg.hidden_size,
        layers=eng.cfg.num_layers, experts=eng.cfg.local_experts,
        num_experts=eng.cfg.num_experts, vocab=eng.cfg.vocab_size,
        expert_bytes=expert_bytes(eng.params))
    texts = score_corpus(eng.tokenizer, *EP_QUANTUM, args.seed)

    def drive():
        # The deployment's questions on one schedule (all submitted, then
        # drained: with capacity drops a token depends on its companions,
        # so ep 1 and ep 2 must batch alike), then a scoring quantum
        # (C = 640); the followers are released after both.
        t_drive = time.monotonic()
        toks = watched_tokens(eng, d_prompts)
        return toks, time.monotonic() - t_drive, eng.score(texts)

    out, counts = run(eng, drive, functools.partial(moe_launches, quanta=1))
    if rank == 0:
        toks, wall, scores = out
        rec["deploy"] = dict(tokens=toks, wall_s=wall, quantum=scores,
                             **counts)
    else:
        rec["deploy"] = dict(tokens=in_order(out), **counts)
    rec["deploy"]["decisions"] = list(eng.decisions)
    torch.save(prompt_logits(torch, eng, d_prompts[0]),
               f"{args.tp_out}.ep_logits.pt")
    del eng
    torch.cuda.empty_cache()

    # (b) GPT-2 small's scoring at sp 2, the 1,024-token bucket, float32
    # and bf16, the ring's block steps and rotations timed (each wrapped
    # here between two device syncs).
    rec["scoring"] = {}
    block, rotate = ring.ring_block, mesh.ParallelAxis.rotate

    def timed(fn, seconds):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t_call = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_call)
            return out
        return wrapped

    for dtype in (torch.float32, torch.bfloat16):
        eng = TutoringEngine(sp_config(torch, args.seed, SP, dtype))
        texts = score_corpus(eng.tokenizer, SP_TEXTS, SP_TOKENS, args.seed)
        steps, rotations = [], []
        ring.ring_block = timed(block, steps)
        mesh.ParallelAxis.rotate = timed(rotate, rotations)
        try:
            scores, counts = run(eng, lambda: eng.score(texts),
                                 forward_launches(
                                     SP_TEXTS * SP_BUCKETS[-1] // SP,
                                     4 * eng.cfg.num_layers))
        finally:
            ring.ring_block, mesh.ParallelAxis.rotate = block, rotate
        rec["scoring"][str(dtype).split(".")[-1]] = dict(
            scores=scores if rank == 0 else scores["score"], sp=eng.sp,
            ring_step_ms=[1e3 * x for x in steps],
            ring_rotation_ms=[1e3 * x for x in rotations], **counts)
        del eng
        torch.cuda.empty_cache()

    # (c) The gate at tp 2 over the default group (both ranks).
    gate = RelevanceGate(gate_tp_config(torch, GATE_TP))
    pairs = gate_tp_pairs()
    f0 = gate.forwards
    checks, counts = run(gate, lambda: [gate.check(q, c) for q, c in pairs],
                         forward_launches(
                             min(gate.config.length_buckets),
                             4 * gate.cfg.num_layers, unembed=False,
                             calls_of=lambda g: g.forwards - f0))
    word = gate.params["embeddings"]["word"]
    rec["gate"] = dict(checks=checks if rank == 0 else None, tp=gate.cfg
                       .tensor_parallel.size, word_rows=(
                           word["q"] if isinstance(word, dict) else word)
                       .shape[0], **counts)
    del gate
    torch.cuda.empty_cache()
    rec["seconds"] = time.monotonic() - t0
    return rec


def ep_references(torch, attention, quant_matmul, args) -> dict:
    """Phase 15's one-rank references, in this process while the ranks
    run: gpt2-moe at ep 1 (the witness's tokens and the float32 logits,
    the deployment's tokens, answers and bf16 logits, the expert bytes;
    its bf16 engine kept for the divergence margins), GPT-2 small's
    scores at sp 1 (float32 and bf16) and the gate's checks at tp 1."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        RelevanceGate,
        TutoringEngine,
    )

    t0 = time.monotonic()
    refs = {}
    witness_cfg, deploy_cfg = ep_configs(torch, args.seed, 1)
    w_prompts, d_prompts = tp_prompts()
    eng = PagedEngine(witness_cfg, slots=TP_WITNESS_REQUESTS, chunk=4,
                      cuda_graphs=False)
    refs["witness"] = watched_tokens(eng, w_prompts)
    refs["f32_logits"] = prompt_logits(torch, eng, d_prompts[0])
    refs["expert_bytes"] = expert_bytes(eng.params)
    del eng
    torch.cuda.empty_cache()
    ref = PagedEngine(deploy_cfg, **TP_DEPLOY_KW)
    refs["deploy_expert_bytes"] = expert_bytes(ref.params)
    t_drive = time.monotonic()
    refs["deploy"] = watched_tokens(ref, d_prompts)
    refs["wall_s"] = time.monotonic() - t_drive
    refs["calls"] = ref.decode_steps + ref.admission_chunks \
        + ref.prefill_calls
    # The router's gap between each token's 2nd and 3rd expert
    # probability, every layer, over that forward: how near its top-2
    # choices sit to a tie.
    from distributed_lms_raft_llm_tpu_torch.models import moe as moe_lib

    gaps, top_k = [], moe_lib.top_k

    def spy(probs, k):
        ranked = torch.sort(probs, dim=-1, descending=True).values
        gaps.append((ranked[:, k - 1] - ranked[:, k]).float().cpu())
        return top_k(probs, k)

    moe_lib.top_k = spy
    try:
        refs["bf16_logits"] = prompt_logits(torch, ref, d_prompts[0])
    finally:
        moe_lib.top_k = top_k
    gap = torch.cat(gaps)
    refs["router_gap"] = dict(
        tokens_x_layers=gap.numel(), median=gap.median().item(),
        min=gap.min().item(),
        share_below_1e3=(gap < 1e-3).float().mean().item())
    texts = score_corpus(ref.tokenizer, *EP_QUANTUM, args.seed)
    refs["quantum"] = ref.score(texts)
    refs["engine"] = ref
    refs["scoring"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        eng = TutoringEngine(sp_config(torch, args.seed, 1, dtype))
        texts = score_corpus(eng.tokenizer, SP_TEXTS, SP_TOKENS, args.seed)
        refs["scoring"][str(dtype).split(".")[-1]] = eng.score(texts)
        del eng
        torch.cuda.empty_cache()
    gate = RelevanceGate(gate_tp_config(torch, 1))
    refs["gate"] = [gate.check(q, c) for q, c in gate_tp_pairs()]
    refs["gate_word_rows"] = gate.params["embeddings"]["word"]["q"].shape[0]
    del gate
    torch.cuda.empty_cache()
    refs["seconds"] = time.monotonic() - t0
    return refs


def ep_kernel_cases(torch, attention, quant_matmul) -> dict:
    """Phase 15's kernels at their new shapes, each against its plain
    version, timed beside its bound and library call: the expert kernel
    at an ep-2 rank's 4 experts (C 5 / 10 / 80 / 640 in bf16, and C 5 in
    float32: the witness's route) and BERT-base's four products' tp-2
    halves at the gate's rows."""
    from distributed_lms_raft_llm_tpu_torch.ops import sweep_int8

    experts = []
    for dtype, caps in (("bfloat16", sweep_int8.MOE_CAPACITIES),
                        ("float32", (5,))):
        for name in sweep_int8.EXPERT_PRODUCTS:
            for c in caps:
                experts.append(sweep_int8.int8_experts_case(
                    name=name, c=c, dtype=dtype,
                    experts=sweep_int8.MOE_EP2_EXPERTS, seed=150))
                emit("ep_int8_experts_case", **experts[-1])
    # Does a 4-expert launch give each expert the bits of an 8-expert one
    # (ep 2's layer equal to ep 1's bit for bit rests on it)?
    split_bits = []
    for dtype, c in (("bfloat16", 5), ("bfloat16", 640), ("float32", 5)):
        for name, (k, n) in sweep_int8.EXPERT_PRODUCTS.items():
            gen = torch.Generator(device="cuda").manual_seed(151)
            w = quant_matmul_weights(torch, gen, 8, k, n)
            x = torch.randn((8, c, k), generator=gen, device="cuda").to(
                getattr(torch, dtype))
            b = (torch.randn((8, n), generator=gen, device="cuda")
                 * 0.02).to(x.dtype)
            whole = quant_matmul.int8_matmul_experts(x, w["q"], w["s"], b)
            half = quant_matmul.int8_matmul_experts(
                x[:4].contiguous(), w["q"][:4].contiguous(),
                w["s"][:4].contiguous(), b[:4].contiguous())
            torch.cuda.synchronize()
            split_bits.append(dict(
                name=name, dtype=dtype, c=c,
                bit_equal=bool(torch.equal(whole[:4], half)),
                max_abs_diff=(whole[:4].float() - half.float()).abs()
                .max().item(),
                plan_8=sweep_int8._plan(c, k, n, False, dtype, experts=8),
                plan_4=sweep_int8._plan(c, k, n, False, dtype, experts=4)))
            emit("ep_expert_launch_bits", **split_bits[-1])
    products = []
    for name in sweep_int8.BERT_TP2_PRODUCTS:
        for m in sweep_int8.GATE_ROWS:
            products.append(sweep_int8.int8_matmul_case(
                name=name, m=m, dtype="bfloat16"))
            emit("gate_tp_int8_matmul_case", **products[-1])
    return dict(experts=experts, gate_products=products,
                launch_bits=split_bits)


def quant_matmul_weights(torch, gen, experts, k, n):
    """Seeded int8 expert weights [experts, K, N] with their scales."""
    from distributed_lms_raft_llm_tpu_torch.models import quant

    return quant.quantize_array(torch.randn(
        (experts, k, n), generator=gen, device="cuda") * 0.02)


def free_check(torch, args) -> dict:
    """Phase 15 (d): a graphed engine, served once through a node
    (`serve_args`, the scoring tenant on), is freed by reference counting
    alone once it is dropped: the garbage collector off, a weak reference
    dead, its device memory returned."""
    import gc
    import weakref

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        PagedEngine,
        SamplingParams,
    )
    from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server

    t0 = time.monotonic()
    eng = PagedEngine(EngineConfig(
        model="gpt2", quant="int8", kv_quant=True, seed=args.seed,
        device="cuda", length_buckets=(32,), scoring=True,
        sampling=SamplingParams.greedy(max_new_tokens=16)), **FREE_KW)
    eng.warmup()
    check(eng.cuda_graphs and len(eng._graphs) > 0,
          "phase 15 (d): the engine captured no graph")
    node_args = tutoring_server.resolve_args([
        "--device", "cuda", "--model", "gpt2", "--port", "0",
        "--metrics-port", "0", "--scoring", "--max-new-tokens", "16"])

    async def serve():
        server = await tutoring_server.serve_args(node_args, eng,
                                                  host="127.0.0.1")
        try:
            reply = await server._service.GetLLMAnswer(
                lms_pb2.QueryRequest(query=QUESTIONS[0]), None)
            return reply.success
        finally:
            await server.stop(0)
            await server._queue.close()

    answered = asyncio.run(serve())
    graphs = len(eng._graphs)
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        ref = weakref.ref(eng)
        del eng
        alive = ref()
        holders = ([type(r).__name__ for r in gc.get_referrers(alive)]
                   if alive is not None else [])
        del alive
        freed = ref() is None
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    rec = dict(answered=answered, graph_widths=graphs, freed=freed,
               holders=holders, allocated_before=before,
               allocated_after=after, freed_bytes=before - after,
               seconds=time.monotonic() - t0)
    check(answered and freed and after < before,
          f"phase 15 (d): a dropped graphed engine was not freed without "
          f"a collection: {rec}")
    return rec


def ep_phase_checks(torch, attention, quant_matmul, args, ranks, refs,
                    outs, card) -> dict:
    """Phase 15's checks on the ranks' records against the one-rank
    references, then its kernels at their new shapes (alone on the card)
    and the graph-engine free check. Returns its record."""
    t_phase = time.monotonic()
    lead, follow = [r["ep_sp_gate"] for r in ranks]
    rec = dict(card=card, ep=EP, sp=SP, gate_tp=GATE_TP,
               backend=TP_BACKEND, references_s=refs["seconds"])
    both = (lead, follow)

    # (a) gpt2-moe at ep 2, float32: tokens byte-equal to ep 1.
    firsts = [first_divergence(a, b) for a, b in
              zip(lead["witness"]["tokens"], refs["witness"])]
    rec["witness"] = dict(
        requests=len(refs["witness"]), new_tokens=TP_WITNESS_TOKENS,
        equal_ep1=sum(f is None for f in firsts), first_divergence=firsts,
        ranks_equal=follow["witness"]["tokens"] == lead["witness"]["tokens"],
        decisions_equal=(follow["witness"]["decisions"]
                         == lead["witness"]["decisions"]),
        expert_bytes=[r["witness"]["expert_bytes"] for r in both],
        expert_bytes_ep1=refs["expert_bytes"],
        ranks=[{k: r["witness"][k] for k in (
            "decode_calls", "admission_chunks", "prefills", "launches",
            "exact", "experts")} for r in both])
    emit("ep_f32_witness", **rec["witness"])
    check(rec["witness"]["equal_ep1"] == len(refs["witness"])
          and rec["witness"]["ranks_equal"]
          and rec["witness"]["decisions_equal"],
          f"phase 15 (a): float32 greedy tokens at ep {EP} differ from ep "
          f"1 or between the ranks: {rec['witness']}")
    check(all(r["witness"]["exact"] and r["witness"]["experts"] == 4
              and 2 * r["witness"]["expert_bytes"] == refs["expert_bytes"]
              for r in both),
          f"phase 15 (a) witness: launches not exact, or a rank's experts "
          f"not half of ep 1's: {rec['witness']}")

    # The deployment config at ep 2, bf16.
    dcfg = lead["deploy_config"]
    check(follow["deploy_config"] == dcfg and dcfg["ep"] == EP
          and dcfg["tp"] == 1 and dcfg["fused"] and dcfg["prefix_cache"]
          and dcfg["megastep_ks"] == [1, 2, 4, 8]
          and not dcfg["cuda_graphs"] and dcfg["quant_kv"]
          and dcfg["hidden"] == 768 and dcfg["layers"] == 12
          and dcfg["num_experts"] == 8 and dcfg["experts"] == 8 // EP
          and dcfg["vocab"] == 50257
          and 2 * dcfg["expert_bytes"] == refs["deploy_expert_bytes"],
          f"phase 15 (a): not gpt2-moe's deployment config at ep {EP} with "
          f"half the expert bytes a rank: {dcfg}, ep 1 "
          f"{refs['deploy_expert_bytes']}")
    deploy = lead["deploy"]
    check(len(deploy["tokens"]) == TP_DEPLOY_REQUESTS
          and all(len(t) > 0 for t in deploy["tokens"])
          and follow["deploy"]["tokens"] == deploy["tokens"]
          and follow["deploy"]["decisions"] == deploy["decisions"],
          "phase 15 (a): the ep ranks disagree (tokens or host decisions) "
          "or an answer is missing")
    check(all(r["deploy"]["exact"] for r in both)
          and follow["deploy"]["launches"] == deploy["launches"]
          and deploy["admission_chunks"] > 0,
          f"phase 15 (a) deployment: launches by route not exact on every "
          f"rank: {[(r['deploy']['launches'], r['deploy']['want_int8']) for r in both]}")
    ref = refs["engine"]
    _, d_prompts = tp_prompts()
    diverged = []
    for i, (a, b) in enumerate(zip(deploy["tokens"], refs["deploy"])):
        j = first_divergence(a, b)
        if j is not None:
            diverged.append(dict(request=i, token=j, top2_margin=(
                divergence_margin(torch, ref, d_prompts[i], b, j))))
    ep_logits = [torch.load(f"{o}.ep_logits.pt") for o in outs]

    def rel(x, y):
        return ((x - y).norm() / y.norm()).item()

    floor = rel(refs["bf16_logits"], refs["f32_logits"])
    logits_rel = [rel(x, refs["bf16_logits"]) for x in ep_logits]
    logits_rel_f32 = [rel(x, refs["f32_logits"]) for x in ep_logits]
    rec["deploy"] = dict(
        requests=TP_DEPLOY_REQUESTS, new_tokens=TP_DEPLOY_TOKENS,
        tokens_equal_ep1=TP_DEPLOY_REQUESTS - len(diverged),
        diverged=diverged, router_gap=refs["router_gap"],
        logits_bit_equal_ep1=[bool(torch.equal(x, refs["bf16_logits"]))
                              for x in ep_logits],
        logits_max_abs_err_ep1=[(x - refs["bf16_logits"]).abs().max().item()
                                for x in ep_logits],
        logits_rel_err_ep1=logits_rel, logits_rel_err_f32=logits_rel_f32,
        logits_rel_err_ep1_f32=floor,
        logits_ranks_equal=bool(torch.equal(*ep_logits)),
        wall_s=deploy["wall_s"], wall_s_ep1=refs["wall_s"],
        ms_per_model_call=deploy["wall_s"] * 1e3 / (
            deploy["decode_calls"] + deploy["admission_chunks"]
            + deploy["prefills"]),
        ms_per_model_call_ep1=refs["wall_s"] * 1e3 / refs["calls"],
        ranks=[{k: r["deploy"][k] for k in (
            "decode_calls", "admission_chunks", "prefills", "launches",
            "exact")} for r in both])
    emit("ep_deployment", **rec["deploy"])
    # bf16 tokens at ep 2 are reported beside ep 1's, not held: random
    # routers give near-equal expert probabilities (router_gap), so a
    # rounding change anywhere (the expert kernel's K split follows the
    # experts a launch holds: launch_bits) moves a token to another
    # expert or past capacity, and that token's logits move by far more
    # than rounding. The logits are held as phase 14 holds tp's: within
    # twice ep 1's own bf16 error against the float32 model. That floor
    # is large here for the same reason (0.179 on an H100; unrelated
    # weights would sit ~1.4 apart).
    check(floor < EP_SAME_WEIGHTS and rec["deploy"]["logits_ranks_equal"]
          and max(logits_rel + logits_rel_f32) <= TP_BF16_ERR_RATIO * floor,
          f"phase 15 (a): bf16 logits at ep {EP}: relative error "
          f"{logits_rel} against ep 1's, {logits_rel_f32} against "
          f"float32's, beyond {TP_BF16_ERR_RATIO} x ep 1's own {floor}")
    # The scoring quantum at ep 2 (C = 640: the wgmma expert route; its
    # launches are in the deployment run's, held exact above).
    quantum = deploy["quantum"]
    q_err = max(abs(a["logprob"] - b["logprob"]) / abs(b["logprob"])
                for a, b in zip(quantum, refs["quantum"]))
    rec["quantum"] = dict(texts=len(quantum), rel_err_ep1=q_err,
                          wgmma_expert_launches=deploy["launches"].get(
                              quant_matmul.WGMMA_EXPERTS, 0))
    emit("ep_quantum", **rec["quantum"])
    check(rec["quantum"]["wgmma_expert_launches"] == 24
          and [s["tokens"] for s in quantum]
          == [s["tokens"] for s in refs["quantum"]]
          and q_err <= TP_BF16_ERR_RATIO * TOLERANCE["bfloat16"],
          f"phase 15 (a): the scoring quantum at ep {EP}: {rec['quantum']}")

    # (b) GPT-2 small's scoring at sp 2 against sp 1.
    sp_rec = {}
    ref_f32 = refs["scoring"]["float32"]
    for dtype in ("float32", "bfloat16"):
        got = [r["scoring"][dtype] for r in both]
        want = refs["scoring"][dtype]
        errs = [abs(a["logprob"] - b["logprob"]) / abs(b["logprob"])
                for a, b in zip(got[0]["scores"], want)]
        own = [abs(a["logprob"] - b["logprob"]) / abs(b["logprob"])
               for a, b in zip(want, ref_f32)]
        sp_rec[dtype] = dict(
            texts=len(want), tokens=[s["tokens"] for s in want],
            truncated=[s["truncated"] for s in want],
            rel_err_sp1=errs, rel_err_sp1_f32=own,
            ranks_equal=got[1]["scores"] == got[0]["scores"],
            ring_step_ms_mean=statistics.mean(got[0]["ring_step_ms"]),
            ring_rotation_ms_mean=statistics.mean(
                got[0]["ring_rotation_ms"]),
            ring_steps=len(got[0]["ring_step_ms"]),
            ring_rotations=len(got[0]["ring_rotation_ms"]),
            ranks=[{k: g[k] for k in ("launches", "exact", "sp")}
                   for g in got])
        emit("sp_scoring", dtype=dtype, **sp_rec[dtype])
        check(all(g["exact"] and g["sp"] == SP for g in got)
              and sp_rec[dtype]["ranks_equal"]
              and [s["tokens"] for s in got[0]["scores"]]
              == sp_rec[dtype]["tokens"]
              and sp_rec[dtype]["ring_rotations"]
              == 12 * (SP - 1) and sp_rec[dtype]["ring_steps"] == 12 * SP,
              f"phase 15 (b): {dtype} scoring at sp {SP}: {sp_rec[dtype]}")
        bound = (SP_F32_RTOL if dtype == "float32"
                 else SP_BF16_ERR_RATIO * max(own))
        check(max(errs) <= bound,
              f"phase 15 (b): {dtype} log probabilities at sp {SP} are "
              f"{errs} (relative) from sp 1's, beyond {bound}")
    rec["scoring"] = sp_rec

    # (c) The gate at tp 2 against tp 1.
    sims = [s for _, s in lead["gate"]["checks"]]
    want = [s for _, s in refs["gate"]]
    verdicts = [ok for ok, _ in lead["gate"]["checks"]]
    away = [abs(s - GATE_THRESHOLD) > GATE_TP_TOL for s in want]
    rec["gate"] = dict(
        pairs=len(want), sims=sims, sims_tp1=want,
        max_abs_err_tp1=max(abs(a - b) for a, b in zip(sims, want)),
        verdicts_equal_away=all(v == w for v, (w, _), far in zip(
            verdicts, refs["gate"], away) if far),
        pairs_away=sum(away), word_rows=[r["gate"]["word_rows"]
                                         for r in both],
        word_rows_tp1=refs["gate_word_rows"],
        ranks=[{k: r["gate"][k] for k in ("forwards", "launches", "exact",
                                          "tp")} for r in both])
    emit("gate_tp", **rec["gate"])
    check(rec["gate"]["max_abs_err_tp1"] <= GATE_TP_TOL
          and rec["gate"]["verdicts_equal_away"]
          and all(r["gate"]["exact"] and r["gate"]["tp"] == GATE_TP
                  and 2 * r["gate"]["word_rows"] == refs["gate_word_rows"]
                  for r in both)
          and follow["gate"]["forwards"] == lead["gate"]["forwards"],
          f"phase 15 (c): the gate at tp {GATE_TP}: {rec['gate']}")
    del ref, refs["engine"]
    torch.cuda.empty_cache()

    # The kernels at their new shapes, alone on the card now.
    rec["kernels"] = ep_kernel_cases(torch, attention, quant_matmul)
    # (d) A dropped graphed engine is freed without a collection.
    rec["free"] = free_check(torch, args)
    emit("graph_engine_free", **rec["free"])
    rec["rank_seconds"] = [r["seconds"] for r in both]

    def ep_total(r):
        """A rank's launches over the ep runs, by route."""
        runs = [r[k]["launches"] for k in ("witness", "deploy")]
        return {k: sum(run.get(k, 0) for run in runs)
                for k in set().union(*runs)}

    rec["launches"] = {"ep": ep_total(lead), "ep_rank1": ep_total(follow),
                       "sp": lead["scoring"]["bfloat16"]["launches"],
                       "gate": lead["gate"]["launches"]}
    # Phase 15's own wall: its part of the ranks' run (the references ran
    # beside it), then these checks, kernel cases and the free check.
    rec["seconds"] = time.monotonic() - t_phase + max(rec["rank_seconds"])
    emit("ep_sp_gate", **{k: rec[k] for k in (
        "card", "ep", "sp", "gate_tp", "backend", "rank_seconds",
        "references_s", "seconds")})
    return rec


# ------------------------------ phase 16: the sharded trainer

TS_MODEL, TS_MOE_MODEL = "gpt2", "gpt2-moe"   # full width and depth
TS_VOCAB = 50257             # GPT-2's vocabulary: the batches' ids
TS_STEPS = 3                 # float32 steps a run (the first moves nothing)
TS_BATCH, TS_SEQ = 8, 128    # (a), (b), (d): a seeded 8 x 128 batch a step
TS_SP_BATCH, TS_SP_SEQ = 2, 1024  # (c): 2 x 1,024 tokens over two sp ranks
TS_PP_MICROS = (2, 4)        # (b): GPipe microbatches
TS_MASK_SHARE = 0.7          # a ragged loss mask: ~70% of the targets count
# Float32, TF32 off. lr 1e-4 keeps Adam's sign flips on float-noise
# gradients (|g| near its rounding) inside the leaves' tolerance.
TS_TRAIN_KW = dict(learning_rate=1e-4, warmup_steps=1, decay_steps=8,
                   remat=True)
# The CPU tolerances against one rank (tests/test_torch_train_sharded.py,
# tests/test_torch_train.py's `_assert_states`).
TS_LOSS_RTOL, TS_NORM_RTOL = 1e-5, 1e-4
TS_LEAF_TOL = {"mu": (1e-6, 1e-4), "nu": (1e-10, 1e-4),
               "params": (2e-5, 1e-5)}
TS_LOOSE = "params/blocks/attn/bqkv"  # the key bias: a float-noise gradient
# The one-rank reference states, written by this process beside the ranks'
# records for their leaves' checks.
TS_REF_DENSE, TS_REF_SP = "ts_ref_dense.safetensors", "ts_ref_sp.safetensors"
# (e): the CLI at pp 2 in bf16 on phase 12's course directory, 4 x 512
# byte tokens a batch: 4 steps an epoch.
TS_CLI_BATCH, TS_CLI_SEQ, TS_CLI_STEPS = 4, 512, 4
TS_BF16_RTOL = TOLERANCE["bfloat16"]
# JAX's refusals (distributed_lms_raft_llm_tpu/train/train.py:162-186).
TS_REFUSALS = {
    "pp_moe": "pp and MoE cannot combine yet: the pipeline stage body has "
              "no aux-loss channel; use ep x tp x dp",
    "pp_sp": "pp and sp cannot combine: the pipeline stage body uses "
             "dense attention (ring attention unreachable under pp)",
    "pp_tp": "pp and tp cannot combine: the pipeline stage body has no "
             "tensor-parallel collectives; use pp x dp",
}


def ts_batches(rows, seq, vocab, seed):
    """TS_STEPS seeded batches of `rows` x `seq` ids with a ragged mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(TS_STEPS):
        ids = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
        mask = (rng.random((rows, seq)) < TS_MASK_SHARE).astype(np.float32)
        out.append({"input_ids": ids, "loss_mask": mask})
    return out


def ts_state_bytes(state) -> dict:
    """Bytes of a (rank's) train state: every param, the blocks' params
    and Adam moments, the experts' params and moments."""
    from distributed_lms_raft_llm_tpu_torch.train.checkpoint import (
        flatten_with_paths,
    )

    out = dict(params=0, blocks=0, blocks_moments=0, experts=0,
               experts_moments=0)
    for key, leaf in flatten_with_paths(state):
        n = leaf.numel() * leaf.element_size()
        moment = key.startswith(("opt_state/1/0/mu/", "opt_state/1/0/nu/"))
        path = key.split("/", 4)[-1] if moment else key[len("params/"):]
        if not (moment or key.startswith("params/")):
            continue
        out["params"] += 0 if moment else n
        if path.startswith("blocks/"):
            out["blocks_moments" if moment else "blocks"] += n
        if re.match(r"blocks/moe/[wb][io]$", path):
            out["experts_moments" if moment else "experts"] += n
    return out


def ts_run(torch, mesh_, model, batches, kw, seed) -> dict:
    """`make_sharded_train_step` on `mesh_`: TS_STEPS steps of `batches`
    (each rank keeps its block), each step's metrics, wall ms and gradient
    all-reduce, the ring's and the pipeline's counters over the run, the
    state's bytes. Returns (record, state)."""
    from distributed_lms_raft_llm_tpu_torch.models import registry
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh, pipeline
    from distributed_lms_raft_llm_tpu_torch.train import train

    _, cfg = registry.resolve(model, torch.float32, torch.float32)
    step, state, slicer = train.make_sharded_train_step(
        mesh_, cfg, train.TrainConfig(**kw), seed)
    mesh.STATS.clear()
    pipeline.STATS.clear()
    rec = dict(metrics=[], step_ms=[], allreduce=[], coords=mesh_.coords())
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, slicer(batch))
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["allreduce"].append(dict(step.last))
    rec.update(ring=dict(mesh.STATS), pipeline=dict(pipeline.STATS),
               bytes=ts_state_bytes(state))
    return rec, state


def ts_params_digest(state) -> str:
    """sha256 of every param's bytes, in the tree's order."""
    from distributed_lms_raft_llm_tpu_torch.train.checkpoint import (
        flatten_with_paths,
    )

    h = hashlib.sha256()
    for _, leaf in flatten_with_paths(state["params"]):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def ts_refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def train_rank_phase(torch, args, rank) -> dict:
    """Phase 16 on one of phase 14's two rank processes (see the module
    docstring): the sharded trainer over (a) dp 2, (b) pp 2 at
    TS_PP_MICROS, (c) sp 2, (d) gpt2-moe at ep 2, (e) the CLI at pp 2 in
    bf16, (f) the refusals. Both ranks run every part alike. Returns this
    rank's record; rank 0 writes the gathered states beside `tp_out`."""
    import gc

    from distributed_lms_raft_llm_tpu_torch.models import registry
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh
    from distributed_lms_raft_llm_tpu_torch.train import train
    from distributed_lms_raft_llm_tpu_torch.train.data import (
        DataConfig,
        PackedDataset,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        ByteTokenizer,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.monotonic()
    before = counted_launches()
    out = Path(args.tp_out).parent
    rec = dict(rank=rank, seconds={})
    batches = ts_batches(TS_BATCH, TS_SEQ, TS_VOCAB, args.seed)

    refs = {}

    def part(name, sizes, model=TS_MODEL, data=batches, ref=None, **kw):
        t0 = time.monotonic()
        m = mesh.make_mesh(sizes, device="cuda")
        r, state = ts_run(torch, m, model, data, dict(TS_TRAIN_KW, **kw),
                          args.seed)
        if ref:
            r["leaves"] = ts_leaves_check(torch, state, m, out / ref, refs)
        if sizes.get("dp", 1) > 1:
            r["digest"] = ts_params_digest(state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        rec[name] = r
        rec["seconds"][name] = time.monotonic() - t0

    part("dp", {"dp": 2}, ref=TS_REF_DENSE)                   # (a)
    for micro in TS_PP_MICROS:                                # (b)
        part(f"pp_micro{micro}", {"pp": 2}, ref=TS_REF_DENSE,
             pp_micro=micro)
    refs.clear()
    part("sp", {"sp": 2}, data=ts_batches(                    # (c)
        TS_SP_BATCH, TS_SP_SEQ, TS_VOCAB, args.seed + 1), ref=TS_REF_SP)
    refs.clear()
    part("ep", {"ep": 2}, model=TS_MOE_MODEL)                 # (d)

    # (e) The trainer's CLI on both ranks, in these processes (the group
    # they hold is torchrun's stand-in), then one more step at pp 2.
    t0 = time.monotonic()
    course = out / f"ts_course{rank}"
    course_directory(course, args.seed)
    ck, ex = out / "ts_cli.safetensors", out / "ts_cli_export.safetensors"
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    cli = train.main(["--data", str(course), "--model", TS_MODEL,
                      "--batch-size", str(TS_CLI_BATCH), "--seq-len",
                      str(TS_CLI_SEQ), "--epochs", "1", "--log-every", "1",
                      "--pp", "2", "--backend", "gloo", "--checkpoint",
                      str(ck), "--export", str(ex)])
    dataset = PackedDataset.from_paths(
        [str(course)], ByteTokenizer(),
        DataConfig(batch_size=TS_CLI_BATCH, seq_len=TS_CLI_SEQ))
    _, bf16 = registry.resolve(TS_MODEL, torch.bfloat16, torch.float32)
    steps = dataset.steps_per_epoch()
    tc = train.TrainConfig(warmup_steps=max(1, steps // 20),
                           decay_steps=max(2, steps), pp_micro=2)
    nxt = train.make_train_step(bf16, train.make_optimizer(tc),
                                remat=tc.remat, mesh=cli["mesh"],
                                pp_micro=tc.pp_micro)
    _, metrics = nxt(cli["state"], next(iter(dataset.batches(1))))
    rec["cli"] = dict(step=cli["step"], steps_per_epoch=steps,
                      history=cli["history"],
                      next_step={k: float(v) for k, v in metrics.items()},
                      bytes=ts_state_bytes(cli["state"]))
    del cli, nxt
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"]["cli"] = time.monotonic() - t0

    # (f) The refusals, on each rank.
    _, small = registry.resolve(TS_MODEL, torch.float32, torch.float32)
    _, moe_cfg = registry.resolve(TS_MOE_MODEL, torch.float32, torch.float32)
    layout = functools.partial(mesh.make_mesh, world_size=4, rank=rank,
                               device="cuda")
    tc = train.TrainConfig(warmup_steps=1)
    rec["refusals"] = dict(
        tp2_vocab=ts_refusal(lambda: train.make_sharded_train_step(
            mesh.make_mesh({"tp": 2}, device="cuda"), small, tc, 0)),
        pp_moe=ts_refusal(lambda: train.make_sharded_train_step(
            layout({"pp": 2, "ep": 2}), moe_cfg, tc, 0)),
        pp_sp=ts_refusal(lambda: train.make_sharded_train_step(
            layout({"pp": 2, "sp": 2}), small, tc, 0)),
        pp_tp=ts_refusal(lambda: train.make_sharded_train_step(
            layout({"pp": 2, "tp": 2}), small, tc, 0)),
        engine_pp2=ts_refusal(lambda: mesh.make_mesh(
            {"pp": -1}).tensor_parallel()))
    gc.collect()
    torch.cuda.empty_cache()
    after = counted_launches()
    rec["launches"] = {k: after.get(k, 0) - before.get(k, 0)
                       for k in set(before) | set(after)}
    rec["seconds"]["total"] = time.monotonic() - t_start
    return rec


def train_references(torch, args, out: Path) -> dict:
    """Phase 16's one-rank references, in this process while the ranks
    run: GPT-2 small on (a)'s and (b)'s batches and on (c)'s, gpt2-moe on
    (d)'s, each `make_sharded_train_step` on a one-rank mesh; the GPT-2
    states written to `out` (TS_REF_DENSE, TS_REF_SP: `save_train_state`,
    its sidecar last) for the ranks' leaves' checks."""
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh
    from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt

    t0 = time.monotonic()
    one = mesh.single_mesh("cuda")
    refs = {}
    for name, path, data in (
            ("dense", TS_REF_DENSE, ts_batches(TS_BATCH, TS_SEQ, TS_VOCAB,
                                               args.seed)),
            ("sp", TS_REF_SP, ts_batches(TS_SP_BATCH, TS_SP_SEQ, TS_VOCAB,
                                         args.seed + 1))):
        refs[name], state = ts_run(torch, one, TS_MODEL, data, TS_TRAIN_KW,
                                   args.seed)
        ckpt.save_train_state(str(out / path), state)
        del state
    refs["moe"], state = ts_run(
        torch, one, TS_MOE_MODEL, ts_batches(TS_BATCH, TS_SEQ, TS_VOCAB,
                                             args.seed), TS_TRAIN_KW,
        args.seed)
    del state
    torch.cuda.empty_cache()
    refs["seconds"] = time.monotonic() - t0
    return refs


def ts_leaves_check(torch, state, mesh_, ref_path: Path, cache: dict):
    """This run's state, each leaf gathered whole on rank 0
    (`partition.gather_leaf`: every rank calls), against the one-rank
    reference state the parent writes at `ref_path` (waited for: its
    sidecar comes last; read once into `cache`), with the CPU tests'
    tolerances (`_assert_states`): counts and step equal, Adam's moments
    and the params within TS_LEAF_TOL, the key bias within lr x the steps
    that move it. Rank 0 returns the leaves that fail and each kind's
    largest |got - want| / (atol + rtol |want|); the others None."""
    from distributed_lms_raft_llm_tpu_torch.models import convert
    from distributed_lms_raft_llm_tpu_torch.parallel import partition
    from distributed_lms_raft_llm_tpu_torch.train import train
    from distributed_lms_raft_llm_tpu_torch.train.checkpoint import (
        flatten_with_paths,
    )

    lead = mesh_.rank == 0
    if lead and ref_path not in cache:
        deadline = time.monotonic() + TP_RANK_TIMEOUT_S
        while not Path(f"{ref_path}.json").exists():
            check(time.monotonic() < deadline,
                  f"phase 16: no reference state at {ref_path}")
            time.sleep(0.5)
        cache[ref_path] = convert.load_safetensors(str(ref_path))
    want = cache.get(ref_path)
    spec = train.state_spec(mesh_, is_moe=False)
    axes = train.model_axes(mesh_)
    lr = TS_TRAIN_KW["learning_rate"]
    bad, worst = [], {}
    with torch.no_grad():
        leaves = flatten_with_paths(state)
        if lead and [k for k, _ in leaves] != list(want):
            bad.append("leaf names differ")
        for key, leaf in leaves:
            got = partition.gather_leaf(key, leaf, spec(key, leaf), axes)
            if not lead or key not in want:
                continue
            ref = torch.from_numpy(want[key].copy()).to(got.device)
            if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
                bad.append(key)
                continue
            if ref.ndim == 0:
                if not torch.equal(got, ref):
                    bad.append(key)
                continue
            diff = (got.double() - ref.double()).abs()
            if key == TS_LOOSE:
                ratio = float(diff.max()) / (lr * (TS_STEPS - 1) + 1e-6)
                kind = "loose"
            else:
                kind = ("mu" if "/mu/" in key else "nu" if "/nu/" in key
                        else "params")
                atol, rtol = TS_LEAF_TOL[kind]
                ratio = float((diff / (atol + rtol * ref.double().abs()))
                              .max())
            worst[kind] = max(worst.get(kind, 0.0), ratio)
            if ratio > 1:
                bad.append(key)
    return dict(bad=bad, worst=worst) if lead else None


def ts_metrics_close(got, want, moe=False) -> bool:
    """Each step's loss within TS_LOSS_RTOL and grad norm within
    TS_NORM_RTOL of one rank's (MoE: moe_balance within TS_LOSS_RTOL)."""
    def close(a, b, rtol):
        return abs(a - b) <= rtol * abs(b)

    return len(got) == len(want) and all(
        close(g["loss"], w["loss"], TS_LOSS_RTOL)
        and close(g["grad_norm"], w["grad_norm"], TS_NORM_RTOL)
        and (not moe or close(g["moe_balance"], w["moe_balance"],
                              TS_LOSS_RTOL))
        for g, w in zip(got, want))


def train_phase_checks(torch, args, ranks, refs, tmp, card) -> dict:
    """Phase 16's checks on both ranks' records (see the module
    docstring). Returns its record."""
    from distributed_lms_raft_llm_tpu_torch.models import convert, registry
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh
    from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
    from distributed_lms_raft_llm_tpu_torch.train import train
    from distributed_lms_raft_llm_tpu_torch.train.data import (
        DataConfig,
        PackedDataset,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        ByteTokenizer,
    )

    t_phase = time.monotonic()
    lead, follow = [r["train_sharded"] for r in ranks]
    rec = dict(card=card, backend=TP_BACKEND, steps=TS_STEPS,
               rank_seconds=[r["seconds"] for r in (lead, follow)],
               references_s=refs["seconds"])
    tmp = Path(tmp)

    def same_metrics(name):
        return lead[name]["metrics"] == follow[name]["metrics"]

    # (a) dp 2.
    dp = lead["dp"]
    leaves = dp["leaves"]
    rec["dp"] = dict(
        metrics=dp["metrics"], one_rank=refs["dense"]["metrics"],
        ranks_equal=same_metrics("dp"),
        params_bit_equal=dp["digest"] == follow["dp"]["digest"],
        leaves=leaves, step_ms=dp["step_ms"],
        one_rank_step_ms=refs["dense"]["step_ms"],
        grad_allreduce_bytes=dp["allreduce"][-1]["bytes"],
        grad_allreduce_ms=[a["ms"] for a in dp["allreduce"]])
    emit("train_sharded_dp", card=card, **rec["dp"])
    check(rec["dp"]["ranks_equal"] and rec["dp"]["params_bit_equal"]
          and ts_metrics_close(dp["metrics"], refs["dense"]["metrics"])
          and not leaves["bad"],
          f"phase 16 (a): dp 2 against one rank: {rec['dp']}")

    # (b) pp 2 at each microbatch count.
    ref_bytes = refs["dense"]["bytes"]
    rec["pp"] = {}
    for micro in TS_PP_MICROS:
        r = lead[f"pp_micro{micro}"]
        leaves = r["leaves"]
        pipe, hops = r["pipeline"], r["ring"]
        ticks = pipe.get("ticks", 0)
        pr = rec["pp"][micro] = dict(
            metrics=r["metrics"], ranks_equal=same_metrics(
                f"pp_micro{micro}"), leaves=leaves, step_ms=r["step_ms"],
            blocks_bytes=[x[f"pp_micro{micro}"]["bytes"]["blocks"]
                          for x in (lead, follow)],
            blocks_moments_bytes=[x[f"pp_micro{micro}"]["bytes"][
                "blocks_moments"] for x in (lead, follow)],
            one_rank_blocks_bytes=ref_bytes["blocks"],
            one_rank_blocks_moments_bytes=ref_bytes["blocks_moments"],
            ticks=ticks, ticks_want=TS_STEPS * (micro + 2 - 1),
            ms_per_tick=1e3 * (pipe.get("forward_s", 0)
                               + pipe.get("backward_s", 0))
            / max(1, 2 * ticks),
            hops=dict(send=hops.get("send", 0), recv=hops.get("recv", 0)),
            ms_per_hop=dict(
                send=1e3 * hops.get("send_s", 0) / max(1, hops.get("send",
                                                                   0)),
                recv=1e3 * hops.get("recv_s", 0) / max(1, hops.get("recv",
                                                                   0))),
            # rank 0 sends each microbatch forward and receives its
            # gradient back, every step
            hops_want=TS_STEPS * micro)
        emit("train_sharded_pp", card=card, pp_micro=micro, **pr)
        check(pr["ranks_equal"]
              and ts_metrics_close(r["metrics"], refs["dense"]["metrics"])
              and not leaves["bad"] and ticks == pr["ticks_want"]
              and pr["hops"] == dict(send=pr["hops_want"],
                                     recv=pr["hops_want"])
              and all(2 * b == ref_bytes["blocks"]
                      for b in pr["blocks_bytes"])
              and all(2 * b == ref_bytes["blocks_moments"]
                      for b in pr["blocks_moments_bytes"]),
              f"phase 16 (b): pp 2 at pp_micro {micro}: {pr}")

    # (c) sp 2 over 2 x 1,024 tokens: the ring forward and backward.
    sp = lead["sp"]
    leaves = sp["leaves"]
    _, f32 = registry.resolve(TS_MODEL, torch.float32, torch.float32)
    layers = f32.num_layers
    remat = 2 if TS_TRAIN_KW["remat"] else 1
    rec["sp"] = dict(
        metrics=sp["metrics"], one_rank=refs["sp"]["metrics"],
        ranks_equal=same_metrics("sp"), leaves=leaves,
        step_ms=sp["step_ms"], one_rank_step_ms=refs["sp"]["step_ms"],
        rotations=sp["ring"].get("rotate", 0),
        rotations_backward=sp["ring"].get("rotate_backward", 0),
        # sp - 1 = 1 rotation a layer forward (twice with remat's
        # recompute) and 1 backward
        rotations_want=TS_STEPS * layers * remat,
        rotations_backward_want=TS_STEPS * layers,
        grad_allreduce_bytes=sp["allreduce"][-1]["bytes"],
        grad_allreduce_ms=[a["ms"] for a in sp["allreduce"]])
    emit("train_sharded_sp", card=card, **rec["sp"])
    check(rec["sp"]["ranks_equal"]
          and ts_metrics_close(sp["metrics"], refs["sp"]["metrics"])
          and not leaves["bad"]
          and rec["sp"]["rotations"] == rec["sp"]["rotations_want"]
          and rec["sp"]["rotations_backward"]
          == rec["sp"]["rotations_backward_want"],
          f"phase 16 (c): sp 2 against one rank: {rec['sp']}")

    # (d) gpt2-moe at ep 2.
    ep = lead["ep"]
    moe_ref = refs["moe"]
    rec["ep"] = dict(
        metrics=ep["metrics"], one_rank=moe_ref["metrics"],
        ranks_equal=same_metrics("ep"), step_ms=ep["step_ms"],
        one_rank_step_ms=moe_ref["step_ms"],
        experts_bytes=[x["ep"]["bytes"]["experts"] for x in (lead, follow)],
        experts_moments_bytes=[x["ep"]["bytes"]["experts_moments"]
                               for x in (lead, follow)],
        one_rank_experts_bytes=moe_ref["bytes"]["experts"],
        one_rank_experts_moments_bytes=moe_ref["bytes"]["experts_moments"])
    emit("train_sharded_ep", card=card, **rec["ep"])
    check(rec["ep"]["ranks_equal"]
          and ts_metrics_close(ep["metrics"], moe_ref["metrics"], moe=True)
          and all(2 * b == moe_ref["bytes"]["experts"]
                  for b in rec["ep"]["experts_bytes"])
          and all(2 * b == moe_ref["bytes"]["experts_moments"]
                  for b in rec["ep"]["experts_moments_bytes"]),
          f"phase 16 (d): gpt2-moe at ep 2 against ep 1: {rec['ep']}")

    # (e) The CLI's bf16 run at pp 2: its checkpoint holds the one-device
    # file's keys and shapes, resumes here at pp 1 for the next step, and
    # its export serves.
    cli = lead["cli"]
    losses = [h["loss"] for h in cli["history"]]
    ck = tmp / "ts_cli.safetensors"
    _, bf16 = registry.resolve(TS_MODEL, torch.bfloat16, torch.float32)
    tc = train.TrainConfig(warmup_steps=max(1, TS_CLI_STEPS // 20),
                           decay_steps=max(2, TS_CLI_STEPS), pp_micro=2)
    opt = train.make_optimizer(tc)
    template = train.init_train_state(args.seed, bf16, opt, "cuda")
    with open(ck, "rb") as fh:  # the file's header: names, dtypes, shapes
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    names = {torch.float32: "F32", torch.int32: "I32"}
    layout_ok = {k: (v["dtype"], tuple(v["shape"]))
                 for k, v in header.items() if k != "__metadata__"} == {
        k: (names.get(v.dtype), tuple(v.shape))
        for k, v in ckpt.flatten_with_paths(template)}
    resumed = ckpt.restore_train_state(str(ck), template,
                                       mesh.single_mesh("cuda"))
    reloaded = convert.gpt2_params_from_hf(
        convert.load_safetensors(str(tmp / "ts_cli_export.safetensors")),
        f32, device="cuda")
    export = export_logits_err(torch, resumed["params"], reloaded, f32,
                               list(QUESTIONS[0].encode()))
    del reloaded
    dataset = PackedDataset.from_paths(
        [str(tmp / "ts_course0")], ByteTokenizer(),
        DataConfig(batch_size=TS_CLI_BATCH, seq_len=TS_CLI_SEQ))
    step = train.make_train_step(bf16, opt, remat=tc.remat)
    _, metrics = step(resumed, next(iter(dataset.batches(1))))
    here = {k: float(v) for k, v in metrics.items()}
    rec["cli"] = dict(
        steps=cli["step"], steps_per_epoch=cli["steps_per_epoch"],
        losses=losses, grad_norms=[h["grad_norm"] for h in cli["history"]],
        layout_equal=layout_ok, sidecar_step=ckpt.latest_step(str(ck)),
        next_step_pp2=cli["next_step"], next_step_pp1=here,
        blocks_bytes=[x["cli"]["bytes"]["blocks"] for x in (lead, follow)],
        export=export)
    del resumed, template
    emit("train_sharded_cli", card=card, **rec["cli"])
    check(cli["step"] == TS_CLI_STEPS == cli["steps_per_epoch"]
          and rec["cli"]["sidecar_step"] == TS_CLI_STEPS
          and all(math.isfinite(x) for x in losses) and layout_ok
          and abs(here["loss"] - cli["next_step"]["loss"])
          <= TS_BF16_RTOL * abs(cli["next_step"]["loss"])
          and abs(here["grad_norm"] - cli["next_step"]["grad_norm"])
          <= TS_BF16_RTOL * abs(cli["next_step"]["grad_norm"])
          and export["finite"]
          and export["max_abs_err"] <= 1e-5 * export["logit_range"],
          f"phase 16 (e): the CLI at pp 2: {rec['cli']}")

    # (f) The refusals, with the JAX package's messages.
    rec["refusals"] = [r["refusals"] for r in (lead, follow)]
    emit("train_sharded_refusals", card=card, refusals=rec["refusals"])
    for got in rec["refusals"]:
        check(all(got[k] == f"ValueError: {msg}"
                  for k, msg in TS_REFUSALS.items())
              and got["tp2_vocab"] is not None
              and f"wte: axis 0 of size {TS_VOCAB} does not split over "
              f"tp=2" in got["tp2_vocab"]
              and got["engine_pp2"] is not None
              and got["engine_pp2"].startswith("NotImplementedError")
              and "pp=2" in got["engine_pp2"],
              f"phase 16 (f): the refusals: {got}")
    rec["launches"] = [r["launches"] for r in (lead, follow)]
    check(not any(v for r in rec["launches"] for v in r.values()),
          f"phase 16: the training path launched a kernel: "
          f"{rec['launches']}")
    for f in tmp.glob("ts_*.safetensors*"):  # the references, the CLI's
        f.unlink()
    rec["seconds"] = (time.monotonic() - t_phase
                      + max(r["total"] for r in rec["rank_seconds"]))
    emit("train_sharded", **{k: rec[k] for k in (
        "card", "backend", "rank_seconds", "references_s", "seconds")})
    return rec


# ------------------------------------ phase 17: dp inside one engine

DP = 2                        # dp ranks: phase 14's two processes
DP_REQUESTS, DP_TOKENS = 4, 32  # phase 4c's 4 bare questions x 32 tokens
DP_LAYERS = 12                # GPT-2 small: the append kernel a layer
DP_PRODUCTS = 4 * DP_LAYERS + 1  # int8 products a model call
# The deployment config's engine options (configs/cluster.toml
# [tutoring]) with its CUDA graphs: a dp-only engine's model calls hold
# no collective, so gloo does not keep it from capturing.
DP_DEPLOY_KW = dict(TP_DEPLOY_KW, cuda_graphs=True)


def dp_config(torch, seed):
    """GPT-2 small at full width and depth with the deployment's int8
    weights and KV cache, in float32 (the witness: dp 1 and dp 2 must
    give the same tokens), greedy; dp is what the ranks' group leaves."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    return EngineConfig(
        model="gpt2", quant="int8", kv_quant=True, seed=seed, device="cuda",
        dtype=torch.float32, param_dtype=torch.float32,
        sampling=SamplingParams.greedy(max_new_tokens=DP_TOKENS))


def dp_launches(attention, quant_matmul, eng, c0) -> dict:
    """Calls since `c0` (decode, admission chunks, prefills) and the
    launches; for a paged engine also whether they are exact: the append
    kernel DP_LAYERS a decode call and no other attention variant,
    DP_PRODUCTS int8 products a model call, all on the CUDA cores
    (float32)."""
    decode = getattr(eng, "decode_steps", 0) - c0[0]
    adm = getattr(eng, "admission_chunks", 0) - c0[1]
    prefill = getattr(eng, "prefill_calls", 0) - c0[2]
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    rec = dict(decode_calls=decode, admission_chunks=adm, prefills=prefill,
               launches={k: v for k, v in launches.items() if v})
    if hasattr(eng, "admission_chunks"):
        model = decode + adm + prefill
        want = {name: 0 for name in attention.launch_counts}
        want[attention.APPEND_INT8KV] = DP_LAYERS * decode
        want[quant_matmul.FMA] = want[quant_matmul.KERNEL] = \
            DP_PRODUCTS * model
        rec["exact"] = decode > 0 and all(launches.get(k, 0) == v
                                          for k, v in want.items())
    return rec


def dp_witness_run(torch, attention, quant_matmul, eng, leader, what):
    """Phase 17 (a) on one engine (a dp rank's, or dp 1's): warm it (the
    graphs captured, every program over its domain), then serve the
    4 bare questions under the compile guard; a follower enters the guard
    once it has replayed rank 0's warmup. Returns (tokens in submit
    order, launch record, inventory record)."""
    prompts = list(QUESTIONS[:DP_REQUESTS])
    box = {}

    def begin():
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        box["c0"] = (eng.decode_steps, eng.admission_chunks,
                     eng.prefill_calls)
        return inventory_guard(eng, what)

    with contextlib.ExitStack() as stack:
        if leader:
            eng.warmup()
            box["inventory"] = stack.enter_context(begin())
            toks = watched_tokens(eng, prompts)
            eng.stop_followers()
        else:
            finals = {}

            def keep(name, result):
                if name == "warmup":
                    box["inventory"] = stack.enter_context(begin())
                finals.update(eng.pop_final_tokens())

            eng.follow(keep)
            toks = [finals[r] for r in sorted(finals)]
        torch.cuda.synchronize()
    counts = dp_launches(attention, quant_matmul, eng, box["c0"])
    return toks, counts, box["inventory"]


def dp_rank_phase(torch, attention, quant_matmul, args, rank, run) -> dict:
    """Phase 17 on one of phase 14's two rank processes (see the module
    docstring): the ranks laid out by `make_hybrid_mesh({}, {"dp": DP})`,
    each process a host of its own; (a) GPT-2 small's deployment, (b) one
    bucketed generate and one scoring quantum, (c) one gate check, each
    at dp 2, rank 0 driving and rank 1 following. Returns this rank's
    record."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        RelevanceGate,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    t0 = time.monotonic()
    layout = mesh.make_hybrid_mesh({}, {"dp": DP}, local_world_size=1)
    rec = dict(rank=rank, layout=layout.layout, coords=layout.coords())
    cfg = dp_config(torch, args.seed)

    # (a) The deployment config at dp 2, on CUDA graphs.
    eng = PagedEngine(cfg, mesh=layout, **DP_DEPLOY_KW)
    rec["config"] = dict(
        dp=eng.dp, tp=eng.tp, ep=eng.ep, cuda_graphs=eng.cuda_graphs,
        fused=eng.fused, megastep_ks=eng.megastep_ks,
        prefix_cache=eng.prefix_cache is not None, quant_kv=eng.cfg.quant_kv,
        dtype=str(eng.cfg.dtype), hidden=eng.cfg.hidden_size,
        layers=eng.cfg.num_layers, vocab=eng.cfg.vocab_size,
        kv_bytes_per_chip=eng.kv_bytes_per_chip)
    toks, counts, inventory = dp_witness_run(
        torch, attention, quant_matmul, eng, rank == 0,
        f"phase 17 (a) dp rank {rank}")
    rec["witness"] = dict(tokens=toks, decisions=list(eng.decisions),
                          inventory=inventory, **counts)
    del eng
    torch.cuda.empty_cache()

    # (b) The bucketed engine: one generate, then one scoring quantum.
    eng = TutoringEngine(cfg, mesh=layout)
    prompts, texts = list(QUESTIONS[:DP_REQUESTS]), list(QUESTIONS)
    out, counts = run(eng, lambda: (eng.answer_batch(prompts),
                                    eng.score(texts)), dp_launches)
    answers, scores = (out if rank == 0
                       else (out["answer_batch"], out["score"]))
    rec["bucketed"] = dict(dp=eng.dp, answers=answers, quantum=scores,
                           **counts)
    del eng
    torch.cuda.empty_cache()

    # (c) The deployment's gate (bert-base, int8, bf16): one check.
    gate = RelevanceGate(gate_tp_config(torch, 1), mesh=layout)
    f0 = gate.forwards
    check_out, counts = run(gate, lambda: gate.check(*gate_tp_pairs()[0]),
                            dp_launches)
    rec["gate"] = dict(dp=gate.dp, forwards=gate.forwards - f0,
                       check=check_out if rank == 0 else None, **counts)
    del gate
    torch.cuda.empty_cache()
    rec["seconds"] = time.monotonic() - t0
    return rec


def dp_references(torch, attention, quant_matmul, args) -> dict:
    """Phase 17's dp-1 references, in this process while the ranks run:
    the same three runs on engines of one rank."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        RelevanceGate,
        TutoringEngine,
    )

    t0 = time.monotonic()
    refs = {}
    cfg = dp_config(torch, args.seed)
    eng = PagedEngine(cfg, **DP_DEPLOY_KW)
    refs["kv_bytes_per_chip"] = eng.kv_bytes_per_chip
    toks, counts, inventory = dp_witness_run(
        torch, attention, quant_matmul, eng, True,
        "phase 17 (a) dp 1 reference")
    refs["witness"] = dict(tokens=toks, inventory=inventory, **counts)
    del eng
    torch.cuda.empty_cache()

    def counted(obj, fn):
        attention.reset_launch_counts()
        quant_matmul.reset_launch_counts()
        c0 = tuple(getattr(obj, k, 0) for k in (
            "decode_steps", "admission_chunks", "prefill_calls"))
        out = fn()
        torch.cuda.synchronize()
        return out, dp_launches(attention, quant_matmul, obj, c0)

    eng = TutoringEngine(cfg)
    (answers, scores), counts = counted(eng, lambda: (
        eng.answer_batch(list(QUESTIONS[:DP_REQUESTS])),
        eng.score(list(QUESTIONS))))
    refs["bucketed"] = dict(answers=answers, quantum=scores, **counts)
    del eng
    torch.cuda.empty_cache()
    gate = RelevanceGate(gate_tp_config(torch, 1))
    check_out, counts = counted(gate, lambda: gate.check(
        *gate_tp_pairs()[0]))
    refs["gate"] = dict(check=check_out, **counts)
    del gate
    torch.cuda.empty_cache()
    refs["seconds"] = time.monotonic() - t0
    return refs


def dp_phase_checks(attention, ranks, refs, card) -> dict:
    """Phase 17's checks on both ranks' records against the dp-1
    references (see the module docstring). Returns its record."""
    t_phase = time.monotonic()
    lead, follow = [r["dp"] for r in ranks]
    rec = dict(card=card, dp=DP, backend=TP_BACKEND,
               rank_seconds=[r["seconds"] for r in (lead, follow)],
               references_s=refs["seconds"],
               layout=lead["layout"], coords=[lead["coords"],
                                              follow["coords"]])
    check(lead["layout"] == follow["layout"] == [0, 1]
          and [lead["coords"]["dp"], follow["coords"]["dp"]] == [0, 1],
          f"phase 17: make_hybrid_mesh's layout {rec['layout']}, "
          f"coordinates {rec['coords']}")
    config = lead["config"]
    check(follow["config"] == config and config["dp"] == DP
          and config["tp"] == config["ep"] == 1 and config["cuda_graphs"]
          and config["fused"] and config["prefix_cache"]
          and config["megastep_ks"] == [1, 2, 4, 8] and config["quant_kv"]
          and config["dtype"] == "torch.float32" and config["hidden"] == 768
          and config["layers"] == DP_LAYERS and config["vocab"] == 50257
          and config["kv_bytes_per_chip"] == refs["kv_bytes_per_chip"],
          f"phase 17: not GPT-2 small's deployment at dp {DP} on graphs, "
          f"each rank holding dp 1's KV: {config}")

    # (a) The float32 witness: each rank's tokens dp 1's, launches by
    # route dp 1's and exact, nothing new under the compile guard.
    want = refs["witness"]
    w = dict(requests=DP_REQUESTS, new_tokens=DP_TOKENS,
             equal_dp1=[sum(a == b for a, b in zip(r["witness"]["tokens"],
                                                   want["tokens"]))
                        for r in (lead, follow)],
             decisions_equal=(follow["witness"]["decisions"]
                              == lead["witness"]["decisions"]),
             dp1={k: want[k] for k in ("decode_calls", "admission_chunks",
                                       "prefills", "launches", "exact")},
             ranks=[{k: r["witness"][k] for k in (
                 "decode_calls", "admission_chunks", "prefills", "launches",
                 "exact")} for r in (lead, follow)],
             new_program_keys=[r["witness"]["inventory"]["new_program_keys"]
                               for r in (lead, follow)])
    rec["witness"] = w
    emit("dp_f32_witness", **w)
    for r in (lead, follow):
        emit("inventory", what=f"phase 17 (a) dp rank {r['rank']}",
             **r["witness"]["inventory"])
    check(w["equal_dp1"] == [DP_REQUESTS] * DP and w["decisions_equal"],
          f"phase 17 (a): float32 greedy tokens at dp {DP} differ from dp "
          f"1's or between the ranks: {w}")
    check(want["exact"] and all(r["exact"] for r in w["ranks"])
          and all(r["launches"] == want["launches"] for r in w["ranks"])
          and all(r[k] == want[k] for r in w["ranks"] for k in (
              "decode_calls", "admission_chunks", "prefills")),
          f"phase 17 (a): launches by route not dp 1's on every rank, or "
          f"not exact: {w}")

    # (b) The bucketed generate and the scoring quantum.
    want = refs["bucketed"]
    b = dict(dp=[r["bucketed"]["dp"] for r in (lead, follow)],
             answers_equal_dp1=[r["bucketed"]["answers"] == want["answers"]
                                for r in (lead, follow)],
             quantum_max_rel_err=max(
                 abs(s["logprob"] - t["logprob"]) / max(1.0, abs(t["logprob"]))
                 for r in (lead, follow)
                 for s, t in zip(r["bucketed"]["quantum"], want["quantum"])),
             quantum_tokens_equal=all(
                 [s["tokens"] for s in r["bucketed"]["quantum"]]
                 == [t["tokens"] for t in want["quantum"]]
                 for r in (lead, follow)),
             launches=[r["bucketed"]["launches"] for r in (lead, follow)],
             launches_dp1=want["launches"],
             decode_calls=[r["bucketed"]["decode_calls"]
                           for r in (lead, follow)])
    rec["bucketed"] = b
    emit("dp_bucketed", **b)
    check(b["dp"] == [DP] * DP and all(b["answers_equal_dp1"])
          and b["quantum_tokens_equal"]
          and len(want["quantum"]) == len(QUESTIONS)
          and b["quantum_max_rel_err"] <= TOLERANCE["float32"]
          and all(x == want["launches"] for x in b["launches"])
          and want["launches"].get(attention.INT8KV, 0) > 0,
          f"phase 17 (b): the bucketed engine at dp {DP} against dp 1: {b}")

    # (c) The gate's check.
    want = refs["gate"]
    got = lead["gate"]["check"]
    g = dict(dp=[r["gate"]["dp"] for r in (lead, follow)],
             verdict_equal=got[0] == want["check"][0],
             similarity=got[1], similarity_dp1=want["check"][1],
             abs_err=abs(got[1] - want["check"][1]),
             forwards=[r["gate"]["forwards"] for r in (lead, follow)],
             launches=[r["gate"]["launches"] for r in (lead, follow)],
             launches_dp1=want["launches"])
    rec["gate"] = g
    emit("dp_gate", **g)
    check(g["dp"] == [DP] * DP and g["verdict_equal"]
          and g["abs_err"] <= TOLERANCE["bfloat16"]
          and g["forwards"][0] == g["forwards"][1] > 0
          and all(x == want["launches"] for x in g["launches"]),
          f"phase 17 (c): the gate at dp {DP} against dp 1: {g}")
    rec["launches"] = {k: lead[k]["launches"]
                       for k in ("witness", "bucketed", "gate")}
    rec["launches_rank1"] = {k: follow[k]["launches"]
                             for k in ("witness", "bucketed", "gate")}
    # Phase 17's own wall: its part of the ranks' run (the references ran
    # beside it), then these checks.
    rec["seconds"] = time.monotonic() - t_phase + max(rec["rank_seconds"])
    emit("dp", **{k: rec[k] for k in (
        "card", "dp", "backend", "layout", "rank_seconds", "references_s",
        "seconds")})
    return rec


# ------------- phase 18: the deployment from artifacts built on the card

ARTIFACT_CORPUS = "checkout"  # the builders' text: this checkout's files
GPT2_PARAMS = 124_439_808     # GPT2LMHeadModel (gpt2) less lm_head.weight
BERT_PARAMS = 108_891_648     # BertModel (bert-base-uncased) less pooler.*
ARTIFACT_WITNESS = "gpt2-local-4-layers"  # its preset, registered by (b)
ARTIFACT_WITNESS_LAYERS = 4
GATE_PLAIN_TOL = 1e-5         # a float32 gate's similarity vs float64's
PROFILE_BATCH = 8             # profile_decode's device-mode batch
PROFILE_MEGASTEP = 4          # ... and its dispatch-gap K


def artifact_prompts():
    """The node's traffic in phase 18: the 8 QUESTIONS framed as the node
    frames a query, then the 8 course prompts behind COURSE_CONTEXT."""
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )

    return ([PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS],
            [COURSE_CONTEXT + PROMPT_TEMPLATE.format(query=q)
             for q in COURSE_QUESTIONS])


def build_artifacts(args, root: Path) -> dict:
    """Phase 18 (a): GPT-2 small's and bert-base's artifacts written into
    `root` by the port's tool (`tools/make_local_checkpoint.py`), the
    weights drawn on the card; the files, each step's seconds, the
    corpus, both vocabularies' sizes and the prompts' token counts under
    the trained BPE beside the byte tokenizer."""
    from distributed_lms_raft_llm_tpu_torch.tools import (
        make_local_checkpoint as mk,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        BPETokenizer, ByteTokenizer, WordPieceTokenizer)

    gpt2_dir, bert_dir = root / "gpt2-local", root / "bert-local"
    t0 = time.monotonic()
    gpt2 = mk.build_gpt2_local(str(gpt2_dir), seed=args.seed, device="cuda",
                               corpus=ARTIFACT_CORPUS)
    t1 = time.monotonic()
    bert = mk.build_bert_local(str(bert_dir), seed=args.seed, device="cuda",
                               corpus=ARTIFACT_CORPUS)
    t2 = time.monotonic()
    files = dict(checkpoint=str(gpt2_dir / "model.safetensors"),
                 vocab=str(gpt2_dir / "vocab.json"),
                 merges=str(gpt2_dir / "merges.txt"),
                 gate_checkpoint=str(bert_dir / "model.safetensors"),
                 gate_vocab=str(bert_dir / "vocab.txt"))
    check(all(set(r) == {"corpus", "vocab", "checkpoint"}
              for r in (gpt2, bert))
          and gpt2["checkpoint"]["params"] == GPT2_PARAMS
          and bert["checkpoint"]["params"] == BERT_PARAMS
          and gpt2["corpus"]["sha256"] == bert["corpus"]["sha256"]
          and all(Path(f).is_file() for f in files.values()),
          f"phase 18 (a): the tool did not build every artifact: "
          f"{gpt2}, {bert}")
    bpe = BPETokenizer.from_files(files["vocab"], files["merges"])
    wordpiece = WordPieceTokenizer.from_file(files["gate_vocab"])
    check(bpe.vocab_size == gpt2["vocab"]["tokens"] > 10_000
          and wordpiece.vocab_size == bert["vocab"]["tokens"] > 5_000,
          f"phase 18 (a): vocabularies of {bpe.vocab_size} and "
          f"{wordpiece.vocab_size} tokens")
    questions, course = artifact_prompts()
    byte = ByteTokenizer()
    tokens = {name: dict(bpe=[len(bpe.encode(p)) for p in prompts],
                         byte=[len(byte.encode(p)) for p in prompts])
              for name, prompts in (("questions", questions),
                                    ("course", course))}
    corpus = {k: gpt2["corpus"][k] for k in ("bytes", "sha256", "files")}
    rec = dict(
        files=files, corpus=corpus, corpus_s=[gpt2["corpus"]["seconds"],
                                              bert["corpus"]["seconds"]],
        bpe=gpt2["vocab"], wordpiece=bert["vocab"], gpt2_s=t1 - t0,
        bert_s=t2 - t1,
        gpt2_checkpoint=gpt2["checkpoint"], bert_checkpoint=bert["checkpoint"],
        seconds=t2 - t0, prompt_tokens=tokens,
        bpe_over_byte=sum(tokens["questions"]["bpe"] + tokens["course"]["bpe"])
        / sum(tokens["questions"]["byte"] + tokens["course"]["byte"]))
    emit("artifacts", **{k: v for k, v in rec.items() if k != "files"})
    return rec


# The node's GPT-2 tree path -> the HF tensor it holds ("{}": the layer
# of a stacked leaf), written out here rather than taken from the loader.
HF_OF_LEAF = {
    ("wte",): "wte.weight", ("wpe",): "wpe.weight",
    ("lnf", "scale"): "ln_f.weight", ("lnf", "bias"): "ln_f.bias",
    **{("blocks",) + tuple(path.split(".")): "h.{}." + name
       for path, name in (
           ("ln1.scale", "ln_1.weight"), ("ln1.bias", "ln_1.bias"),
           ("attn.wqkv", "attn.c_attn.weight"),
           ("attn.bqkv", "attn.c_attn.bias"),
           ("attn.wo", "attn.c_proj.weight"), ("attn.bo", "attn.c_proj.bias"),
           ("ln2.scale", "ln_2.weight"), ("ln2.bias", "ln_2.bias"),
           ("mlp.wi", "mlp.c_fc.weight"), ("mlp.bi", "mlp.c_fc.bias"),
           ("mlp.wo", "mlp.c_proj.weight"), ("mlp.bo", "mlp.c_proj.bias"))},
}


def read_safetensors(path) -> dict:
    """name -> float32 numpy array of a .safetensors file, read by its
    format (an 8-byte header length, a JSON header, the raw tensors), not
    by the port's loader."""
    import numpy as np

    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    out = {}
    for name, meta in json.loads(raw[8:8 + n]).items():
        if name == "__metadata__":
            continue
        check(meta["dtype"] == "F32", f"{path}: {name} is {meta['dtype']}")
        lo, hi = meta["data_offsets"]
        out[name.removeprefix("transformer.")] = np.frombuffer(
            raw, np.float32, (hi - lo) // 4, 8 + n + lo).reshape(meta["shape"])
    return out


def loaded_leaves_check(torch, eng, files) -> dict:
    """The node's weights are the file's: each leaf of the tree it serves
    against the file's tensors (read by `read_safetensors`, named by
    HF_OF_LEAF), a float leaf equal to the file's in the leaf's dtype, an
    int8 leaf dequantized within one step (its scale) of the file's
    float32 (half a step of rounding, up to half a step more from the
    bf16 cast it was quantized from); and the float32 tree maps back to
    the file's tensors exactly (`gpt2_params_from_hf`, then
    `gpt2_params_to_hf`)."""
    import dataclasses
    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.models import convert, quant

    def leaf_paths(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, dict) and not quant.is_quantized(value):
                yield from leaf_paths(value, path + (key,))
            else:
                yield path + (key,)

    sd = read_safetensors(files["checkpoint"])
    layers = eng.cfg.num_layers
    check(set(leaf_paths(eng.params)) == set(HF_OF_LEAF)
          and set(sd) == {n.format(i) for n in HF_OF_LEAF.values()
                          for i in range(layers)},
          f"phase 18 (b): the node's leaves {sorted(leaf_paths(eng.params))}"
          f" or the file's tensors {sorted(sd)} are not GPT-2's")
    exact = int8 = 0
    worst = 0.0  # the largest int8 error, in steps
    for path, name in HF_OF_LEAF.items():
        leaf = eng.params
        for key in path:
            leaf = leaf[key]
        want = torch.from_numpy(np.stack([sd[name.format(i)]
                                          for i in range(layers)])
                                if "{}" in name else np.array(sd[name])
                                ).to(eng.device)
        if quant.is_quantized(leaf):
            q, step = leaf["q"], leaf["s"]
            # a scale per row of the embedding, per output column of a
            # product's [in, out]
            step = step.unsqueeze(-1 if path == ("wte",) else -2)
            err = ((q.float() * step - want).abs() / step).max().item()
            check(q.shape == want.shape and err <= 1.0,
                  f"phase 18 (b): the node's int8 {'.'.join(path)} is "
                  f"{err} steps from the file's {name}")
            worst, int8 = max(worst, err), int8 + 1
        else:
            check(torch.equal(leaf, want.to(leaf.dtype)),
                  f"phase 18 (b): the node's {'.'.join(path)} is not the "
                  f"file's {name}")
            exact += 1
    f32 = dataclasses.replace(eng.cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    back = convert.gpt2_params_to_hf(
        convert.gpt2_params_from_hf(sd, f32, device="cpu"))
    same = sum(np.array_equal(back[k], sd[k]) for k in back)
    check(len(back) == len(sd) and same == len(sd),
          f"phase 18 (b): the float32 round trip kept {same} of {len(sd)} "
          f"tensors")
    return dict(leaves=len(HF_OF_LEAF), float_leaves_equal=exact,
                int8_leaves_within_a_step=int8, int8_worst_steps=worst,
                file_tensors=len(sd), round_trip_tensors=same)


def artifact_witness(torch, attention, quant_matmul, files, prompts) -> dict:
    """Phase 18 (b)'s float32 witness: the built checkpoint's first
    ARTIFACT_WITNESS_LAYERS layers at full width, int8 weights and KV, the
    paged engine eagerly: the kernel path's greedy tokens on the framed
    questions equal the plain path's (plain attention, the int8 wrapper's
    plain version)."""
    import functools

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig, PagedEngine, SamplingParams)
    from distributed_lms_raft_llm_tpu_torch.models import gpt2, registry

    layers = ARTIFACT_WITNESS_LAYERS
    registry.PRESETS[ARTIFACT_WITNESS] = (registry.GPT2_FAMILY,
                                          functools.partial(
                                              gpt2.GPT2Config.small,
                                              num_layers=layers))
    base = dict(model=ARTIFACT_WITNESS, checkpoint=files["checkpoint"],
                vocab_path=files["vocab"], merges_path=files["merges"],
                quant="int8", kv_quant=True, dtype=torch.float32,
                param_dtype=torch.float32, device="cuda",
                sampling=SamplingParams.greedy(max_new_tokens=32))
    toks, runs = {}, {}
    try:
        for name, fused in (("plain", False), ("kernels", True)):
            eng = PagedEngine(EngineConfig(fused_attention=fused, **base),
                              slots=8, chunk=16, inflight=3,
                              cuda_graphs=False)
            check(eng.cfg.num_layers == layers and eng.cfg.hidden_size == 768
                  and eng.cfg.dtype == torch.float32,
                  f"phase 18 witness: not GPT-2 small's width at {layers} "
                  f"layers in float32: {eng.cfg}")
            attention.reset_launch_counts()
            quant_matmul.reset_launch_counts()
            calls0 = (eng.decode_steps, eng.prefill_calls)
            if fused:
                toks[name] = engine_tokens(eng, prompts)
            else:
                with plain_int8_products(quant_matmul):
                    toks[name] = engine_tokens(eng, prompts)
            decode = eng.decode_steps - calls0[0]
            model = decode + eng.prefill_calls - calls0[1]
            launches = {k: v for k, v in {**attention.launch_counts,
                                          **quant_matmul.launch_counts}.items()
                        if v}
            want = ({} if not fused else {
                attention.APPEND_INT8KV: layers * decode,
                quant_matmul.FMA: (4 * layers + 1) * model,
                quant_matmul.KERNEL: (4 * layers + 1) * model})
            check(decode > 0 and launches == want,
                  f"phase 18 witness {name}: launches {launches} != {want}")
            runs[name] = dict(decode_model_calls=decode, model_calls=model,
                              tokens=sum(len(t) for t in toks[name]),
                              launches=launches)
            del eng
            torch.cuda.empty_cache()
    finally:
        registry.PRESETS.pop(ARTIFACT_WITNESS, None)
    firsts = [first_divergence(a, b)
              for a, b in zip(toks["kernels"], toks["plain"])]
    rec = dict(layers=layers, requests=len(prompts),
               equal=sum(f is None for f in firsts),
               first_divergence=[f for f in firsts if f is not None],
               runs=runs)
    check(rec["equal"] == len(prompts),
          f"phase 18 witness: float32 greedy tokens differ between the "
          f"kernel and the plain path: {rec['first_divergence']}")
    return rec


def artifact_node(torch, attention, quant_matmul, args, files) -> dict:
    """Phase 18 (b): the tutoring node's engine from configs/cluster.toml
    with only --checkpoint/--vocab/--merges pointed at (a)'s files,
    warmed, serving the framed questions and the course prompts through
    PagedQueue under the compile guard (see the module docstring)."""
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine, PagedQueue)
    from distributed_lms_raft_llm_tpu_torch.serving import tutoring_server
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        BPETokenizer)

    node_args = tutoring_server.resolve_args([
        "--config", str(REPO / "configs" / "cluster.toml"),
        "--checkpoint", files["checkpoint"], "--vocab", files["vocab"],
        "--merges", files["merges"]])
    check(node_args.model == "gpt2" and node_args.paged
          and node_args.quant == "int8" and node_args.kv_quant
          and node_args.slots == 16 and node_args.megastep == 4
          and node_args.megastep_max == 8 and node_args.prefix_cache
          and node_args.prefill_chunk_tokens == 32
          and node_args.checkpoint == files["checkpoint"],
          f"phase 18 (b): configs/cluster.toml did not resolve to the "
          f"deployment config on the built files: {vars(node_args)}")
    t0 = time.monotonic()
    eng = tutoring_server.engine_from_args(node_args)
    init_s = time.monotonic() - t0
    cfg = eng.cfg
    check(isinstance(eng, PagedEngine) and eng.cuda_graphs and eng.fused
          and isinstance(eng.tokenizer, BPETokenizer)
          and eng.tokenizer.encoder == BPETokenizer.from_files(
              files["vocab"], files["merges"]).encoder
          and cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.vocab_size == 50257 and cfg.dtype == torch.bfloat16
          and cfg.quant_kv and eng.widths == [160, 192, 256, 384],
          f"phase 18 (b): not GPT-2 small's deployment on the trained BPE: "
          f"{cfg}, widths {eng.widths}")
    leaves = loaded_leaves_check(torch, eng, files)
    warm_s = eng.warmup()
    questions, course = artifact_prompts()
    lens = [len(eng.tokenizer.encode(p)) for p in questions + course]
    check(max(lens) <= eng.bucket,
          f"phase 18 (b): a prompt exceeds the prompt bucket: {lens}")
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    c0 = (eng.decode_steps, eng.admission_chunks, eng.prefill_calls,
          eng.total_generated_tokens)
    with inventory_guard(eng, "phase 18 served waves") as inventory:
        answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics,
                                              questions, course)
    launches = {**attention.launch_counts, **quant_matmul.launch_counts}
    decode_calls = eng.decode_steps - c0[0]
    adm_calls = eng.admission_chunks - c0[1]
    tokens = eng.total_generated_tokens - c0[3]
    emit("inventory_18", **inventory)
    check(len(answers) == 16 and all(isinstance(a, str) and a.strip()
                                     for a in answers),
          f"phase 18 (b): empty answers: {answers}")
    check(decode_calls > 0
          and launches[attention.APPEND_INT8KV] == 12 * decode_calls,
          f"phase 18 (b): append launches {launches[attention.APPEND_INT8KV]}"
          f" != 12 x {decode_calls} decode model calls")
    check_int8_routes(launches, int8_want(quant_matmul, paged_calls(
        quant_matmul, eng, decode_calls, adm_calls,
        eng.prefill_calls - c0[2]), 48), "phase 18 (b)")
    lat, counters = snap["latency"], snap["counters"]
    run = dict(
        init_s=init_s, warmup_s=warm_s, requests=len(answers),
        prompt_tokens=lens, wall_s=wall, tokens=tokens,
        tokens_per_s=tokens / wall, ttft_p50_s=lat["ttft"]["p50_s"],
        ttft_p90_s=lat["ttft"]["p90_s"], decode_model_calls=decode_calls,
        admission_chunks=adm_calls,
        prefix_hit_tokens=counters.get("prefix_cache_hit_tokens", 0),
        launches={k: v for k, v in launches.items() if v},
        inventory=inventory, leaves=leaves,
        answer_sample=answers[0][:80])
    del eng
    torch.cuda.empty_cache()
    run["witness"] = artifact_witness(torch, attention, quant_matmul, files,
                                      questions)
    emit("artifact_node", **{k: v for k, v in run.items()
                             if k != "inventory"})
    return run


def artifact_gate(torch, args, files) -> dict:
    """Phase 18 (c): the gate from configs/cluster.toml's [gate] with only
    --gate-checkpoint/--gate-vocab pointed at (a)'s files, built as the LMS
    node builds it; its WordPiece ids against the plain tokenizer's, check
    latency per bucket, and a float32 gate on the same files against its
    plain float64 version on the CPU."""
    import dataclasses
    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig, RelevanceGate)
    from distributed_lms_raft_llm_tpu_torch.models import bert
    from distributed_lms_raft_llm_tpu_torch.serving import lms_server
    from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
        WordPieceTokenizer)

    gate_args = lms_server.resolve_args([
        "--config", str(REPO / "configs" / "cluster.toml"), "--id", "1",
        "--gate-checkpoint", files["gate_checkpoint"],
        "--gate-vocab", files["gate_vocab"]])
    check(gate_args.gate_model == "bert-base-uncased"
          and gate_args.gate_threshold == GATE_THRESHOLD
          and gate_args.gate_checkpoint == files["gate_checkpoint"]
          and gate_args.gate_vocab == files["gate_vocab"],
          f"phase 18 (c): [gate] did not resolve on the built files: "
          f"{vars(gate_args)}")
    t0 = time.monotonic()
    gate = lms_server.gate_from_args(gate_args)
    gate.warmup()
    build_s = time.monotonic() - t0
    plain = WordPieceTokenizer.from_file(files["gate_vocab"])
    check(isinstance(gate.tokenizer, WordPieceTokenizer)
          and gate.cfg.hidden_size == 768 and gate.cfg.num_layers == 12
          and gate.cfg.vocab_size == 30522,
          f"phase 18 (c): not bert-base on the WordPiece: {gate.cfg}")
    contexts = gate_contexts(gate.tokenizer, (64, 128, 256, 512))
    texts = QUESTIONS + list(contexts.values())
    ids = [gate.tokenizer.encode(t, add_special_tokens=True) for t in texts]
    check(ids == [plain.encode(t, add_special_tokens=True) for t in texts]
          and all(plain.unk_id not in row for row in ids[:len(QUESTIONS)]),
          "phase 18 (c): the gate's WordPiece ids differ from the plain "
          "tokenizer's, or a question holds [UNK]")
    pairs = [(q, c) for q in QUESTIONS for c in contexts.values()]
    buckets = sorted({gate._encode([q, c])[0].shape[1] for q, c in pairs})
    latency = gate_latency(torch, gate, QUESTIONS[1], contexts)
    bf16 = [gate.check(q, c)[1] for q, c in pairs]
    del gate
    f32 = RelevanceGate(GateConfig(
        model="bert-base-uncased", checkpoint=files["gate_checkpoint"],
        vocab_path=files["gate_vocab"], threshold=GATE_THRESHOLD,
        dtype=torch.float32, device="cuda"))
    sims = [f32.check(q, c)[1] for q, c in pairs]
    cfg64 = dataclasses.replace(f32.cfg, dtype=torch.float64)
    params64 = to_cpu_f64(torch, f32.params)
    emb = {}
    with torch.inference_mode():
        for text in dict.fromkeys(t for pair in pairs for t in pair):
            tok_ids, mask = f32._encode([text])
            emb[text] = bert.embed(params64, cfg64, torch.as_tensor(tok_ids),
                                   attention_mask=torch.as_tensor(mask)
                                   ).numpy()[0]

    def cos(a, b):
        return float(np.dot(a, b) / max(float(np.linalg.norm(a)
                                              * np.linalg.norm(b)), 1e-12))

    plain_sims = [cos(emb[q], emb[c]) for q, c in pairs]
    f32_err = max(abs(a - b) for a, b in zip(sims, plain_sims))
    bf16_err = max(abs(a - b) for a, b in zip(bf16, sims))
    del f32
    torch.cuda.empty_cache()
    rec = dict(build_s=build_s, tokenizer_size=plain.vocab_size,
               question_tokens=[len(r) for r in ids[:len(QUESTIONS)]],
               context_tokens={k: len(r) for k, r in zip(
                   contexts, ids[len(QUESTIONS):])},
               buckets=buckets, pairs=len(pairs), latency=latency,
               float32_vs_plain_max_abs=f32_err, tol=GATE_PLAIN_TOL,
               bf16_vs_float32_max_abs=bf16_err, bf16_tol=GATE_BF16_TOL,
               sim_range_float32=[min(sims), max(sims)])
    emit("artifact_gate", **rec)
    check(buckets == [64, 128, 256, 512],
          f"phase 18 (c): the pairs land in buckets {buckets}")
    check(f32_err <= GATE_PLAIN_TOL and bf16_err <= GATE_BF16_TOL,
          f"phase 18 (c): the float32 gate's similarities err {f32_err} "
          f"against float64 (tol {GATE_PLAIN_TOL}), the deployment's bf16 "
          f"{bf16_err} against float32 (tol {GATE_BF16_TOL})")
    return rec


def artifact_profiles(torch, attention, quant_matmul, files) -> dict:
    """Phase 18 (d): `tools/profile_decode.py` in both modes on (a)'s
    files: the device mode (bucketed GPT-2 small, batch PROFILE_BATCH,
    int8 weights and KV, 64-token prefill, 128 new tokens) with its module
    scopes and the kernels it saw against those launched; the dispatch-gap
    mode at K = PROFILE_MEGASTEP against the chunk loop."""
    from distributed_lms_raft_llm_tpu_torch.tools import profile_decode

    flags = ["--checkpoint", files["checkpoint"], "--vocab", files["vocab"],
             "--merges", files["merges"], "--batch", str(PROFILE_BATCH),
             "--greedy"]
    parse = profile_decode.build_parser().parse_args
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    t0 = time.monotonic()
    device = profile_decode.profile_device(parse(flags))
    device_s = time.monotonic() - t0
    launches = {k: v for k, v in {**attention.launch_counts,
                                  **quant_matmul.launch_counts}.items() if v}
    seen = device["traced_vs_launched"]
    check(device["total_device_ms"] > 0 and device["decode_steps"] > 0
          and seen and all(t <= n for t, n in seen.values())
          and seen["decode_attention"][1] == 12 * device["decode_steps"],
          f"phase 18 (d): the device mode's kernels seen against launched "
          f"{seen} for {device['decode_steps']} decode steps")
    # Each of the port's kernels credited by the wrappers' counters to the
    # module that launched it (the int8 products to the model's products,
    # the attention kernel to the attention); only a route whose records
    # the trace lost may stand unmatched.
    unmatched = profile_decode.UNMATCHED
    products = {"qkv", "attn_out", "mlp_in", "mlp_out", "unembed", unmatched}
    misplaced = {r["op"][:60]: r["scopes"] for r in device["ops_ms"]
                 if ("int8_" in r["op"] and set(r["scopes"]) - products)
                 or ("decode_attention" in r["op"]
                     and set(r["scopes"]) - {"attention", unmatched})}
    found = device["scope_found_by"]
    traced = sum(t for t, _ in seen.values())
    lossy = sum(t for t, n in seen.values() if t < n)
    exact = found.get("launch_order", 0) + found.get("launch_scope", 0)
    check(traced - lossy <= exact <= traced and not misplaced,
          f"phase 18 (d): kernels outside their modules' scopes {misplaced} "
          f"(scopes found by {found}, {traced} of the port's kernels "
          f"traced, {lossy} of them of routes that lost records)")
    t0 = time.monotonic()
    mega = profile_decode.profile_megastep(
        parse(flags + ["--megastep", str(PROFILE_MEGASTEP)]))
    mega_s = time.monotonic() - t0
    before, after = mega["before"], mega["after"]
    check(before["emitted_tokens"] > 0 and after["emitted_tokens"] > 0
          and after["host_dispatches_per_token"]
          < before["host_dispatches_per_token"],
          f"phase 18 (d): K={PROFILE_MEGASTEP} did not cut host dispatches "
          f"a token: {before} against {after}")
    rec = dict(device_s=device_s, megastep_s=mega_s, launches=launches,
               device={k: device[k] for k in (
                   "device", "batch", "bucket", "decode_steps",
                   "total_device_ms", "cuda_event_span_ms", "wall_ms",
                   "profiled_wall_ms", "device_busy_share", "kernels",
                   "scopes_ms", "scope_found_by", "traced_vs_launched")},
               top_kernels=[dict(r, op=r["op"][:90])
                            for r in device["ops_ms"][:10]],
               megastep=mega)
    emit("artifact_profiles", **rec)
    return rec


def artifacts_phase(torch, attention, quant_matmul, args) -> dict:
    """Phase 18: GPT-2 small's deployment and the bert-base gate served
    from artifacts the port's tool builds on the card (see the module
    docstring); the files live in a temporary directory, never data/."""
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="phase18_") as tmp:
        rec = dict(artifacts=build_artifacts(args, Path(tmp)))
        files = rec["artifacts"]["files"]
        rec["node"] = artifact_node(torch, attention, quant_matmul, args,
                                    files)
        rec["gate"] = artifact_gate(torch, args, files)
        rec["profiles"] = artifact_profiles(torch, attention, quant_matmul,
                                            files)
    rec["seconds"] = time.monotonic() - t0
    emit("artifacts_phase", seconds=rec["seconds"])
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--merges", default=None)
    parser.add_argument("--gate-checkpoint", default=None,
                        help="phase 6: the gate's BERT .safetensors (HF "
                        "layout); default seeded random weights")
    parser.add_argument("--gate-vocab", default=None,
                        help="phase 6: the gate's WordPiece vocab.txt; "
                        "default the byte fallback")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write every record as JSON to this file")
    # Phase 14 starts this script once a tp rank with these.
    parser.add_argument("--tp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-init", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tp_rank is not None:
        return tp_rank_main(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 2
    if not (REPO / PACKAGE / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    records = {}
    phase_s = {}  # each phase's wall seconds, in order

    def lap(name):
        phase_s[name] = time.monotonic() - t_start - sum(phase_s.values())

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("torch", version=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    records["card"] = smi

    # 2. Build every kernel (one nvcc per source, started together).
    from distributed_lms_raft_llm_tpu_torch.ops import (
        attention,
        build,
        quant_matmul,
        sweep_int8,
    )

    t0 = time.monotonic()
    build.build_all()
    build_s = time.monotonic() - t0
    for name, (secs, log) in build.build_logs.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln]
        emit("build", kernel=name, nvcc_s=secs, ptxas=ptxas)
    emit("build_total", seconds=build_s)
    records["build_s"] = build_s
    lap("1-2_card_build")

    # 3. Kernel vs plain at GPT-2-small shapes.
    shapes = [dict(b=b, s=s, dtype=dtype) for dtype in ("bfloat16", "float32")
              for b in (1, 8) for s in (64, 384)]
    # The main path's grid: batch x (bucket 32 + 1, bucket 256 + 64, 384).
    shapes += [dict(b=b, s=s) for b in (1, 2, 4, 8) for s in (33, 320, 384)
               if (b, s) not in ((1, 384), (8, 384))]
    shapes += [
        dict(b=8, s=1024), dict(b=1, s=1024),  # GPT-2's full window
        dict(b=8, s=384, hkv=4),               # GQA
        # ragged: the last row pads 383 of 384, so every split of it but
        # the last is fully masked; then every row padded that far
        dict(b=8, s=384, pad=[0, 5, 17, 60, 100, 150, 200, 383]),
        dict(b=8, s=384, pad=[383] * 8),
        dict(b=8, s=300, s_alloc=384),         # a window of the cache
        dict(b=8, s=300, s_alloc=384, strided_q=True),
    ]
    cases = []
    for shape in shapes:
        cases.append(attention_case(torch, attention,
                                    **{"h": 12, "hkv": 12, **shape}))
        emit("attention_case", **cases[-1])
    records["attention_cases"] = cases

    # 3b. The paged path's kernels at its shapes.
    paged_cases = []
    for int8 in (False, True):
        for slots in (8, 16):
            for width in (160, 384):
                paged_cases.append(paged_attention_case(
                    torch, attention, s=slots, width=width, int8=int8,
                    seed=slots + width))
        # two rows split four ways: the short row's later splits are empty
        paged_cases.append(paged_attention_case(
            torch, attention, s=2, width=384, int8=int8, lengths=[1, 150]))
        paged_cases.append(paged_attention_case(
            torch, attention, s=16, width=384, int8=int8, dtype="float32",
            seed=3))
    # The bucketed engine's int8-cache decode step as phase 18 (d) runs it:
    # 8 rows at its last window, the whole 64 + 128-slot cache, under the
    # model's bias (left padding as a served batch has it).
    paged_cases.append(paged_attention_case(
        torch, attention, s=8, width=192, s_alloc=192, int8=True,
        pads=[0, 0, 0, 5, 17, 30, 47, 63], seed=11))
    for case in paged_cases:
        emit("paged_attention_case", **case)
    records["paged_attention_cases"] = paged_cases
    # The paged decode step's one kernel since the append was fused in,
    # against its plain version (output and cache bytes) and beside what
    # it replaces: 8 and 16 slots, widths 160, 384 and 1,024 (two splits),
    # each with a dead slot at the width; float32; GQA (G = 4); two rows
    # split four ways (the new rows in splits 0 and 1, splits 2-3 empty).
    append_cases = []
    for cache in ("int8", "bfloat16"):
        for slots in (8, 16):
            for width in (160, 384, 1024):
                append_cases.append(dict(s=slots, width=width, cache=cache,
                                         seed=slots + width))
    append_cases += [dict(s=16, width=384, cache="float32", seed=5),
                     dict(s=16, width=384, cache="int8", hkv=3, seed=6),
                     dict(s=2, width=384, cache="int8", lengths=[1, 150]),
                     # gpt2-medium's 16 heads and gpt2-xl's 25, Dh = 64
                     dict(s=16, width=384, cache="int8", h=16, hkv=16,
                          seed=7),
                     dict(s=16, width=384, cache="int8", h=25, hkv=25,
                          seed=8)]
    for i, case in enumerate(append_cases):
        append_cases[i] = append_attention_case(torch, attention, **case)
        emit("append_attention_case", **append_cases[i])
    records["append_attention_cases"] = append_cases
    mm_cases = []
    for dtype in ("bfloat16", "float32"):
        for name in sweep_int8.INT8_PRODUCTS:
            # decode, the fused admission chunk, the cold prefill
            for m in (1, 16, 32, 256):
                mm_cases.append(sweep_int8.int8_matmul_case(
                    name=name, m=m, dtype=dtype))
                emit("int8_matmul_case", **mm_cases[-1])
    # The scoring tenant's rows (phase 8): a quantum of 8 texts at length
    # buckets 64 and 256, through all five products.
    for name in sweep_int8.INT8_PRODUCTS:
        for m in sweep_int8.SCORE_ROWS:
            mm_cases.append(sweep_int8.int8_matmul_case(
                name=name, m=m, dtype="bfloat16"))
            emit("int8_matmul_case", **mm_cases[-1])
    # The relevance gate's rows (phase 6): texts x length bucket.
    for name in sweep_int8.GATE_PRODUCTS:
        for m in sweep_int8.GATE_ROWS:
            mm_cases.append(sweep_int8.int8_matmul_case(
                name=name, m=m, dtype="bfloat16"))
            emit("int8_matmul_case", **mm_cases[-1])
    # GPT-2 medium's five products at decode's 16 rows (K = 1,024).
    for name in sweep_int8.MEDIUM_PRODUCTS:
        mm_cases.append(sweep_int8.int8_matmul_case(name=name, m=16,
                                                    dtype="bfloat16"))
        emit("int8_matmul_case", **mm_cases[-1])
    records["int8_matmul_cases"] = mm_cases
    # gpt2-moe's expert products (phase 10's path), one launch for all 8
    # experts, at its four capacities, bf16 and float32.
    expert_cases = []
    for dtype in ("bfloat16", "float32"):
        for name in sweep_int8.EXPERT_PRODUCTS:
            for c in sweep_int8.MOE_CAPACITIES:
                expert_cases.append(sweep_int8.int8_experts_case(
                    name=name, c=c, dtype=dtype))
                emit("int8_experts_case", **expert_cases[-1])
    records["int8_experts_cases"] = expert_cases
    model_call = sweep_int8.int8_model_call()
    emit("int8_matmul_model_call", **model_call)
    records["int8_matmul_model_call"] = model_call
    # The 48 dense products of one admission chunk (32 prompt tokens, the
    # wgmma route), beside the route they replaced there.
    chunk_call = sweep_int8.int8_model_call(m=32, unembed=False)
    emit("int8_matmul_admission_chunk", **chunk_call)
    records["int8_matmul_admission_chunk"] = chunk_call
    records["int8_matmul_gate_forward"] = []
    for m in sweep_int8.GATE_ROWS:  # one int8 gate forward's 48 products
        records["int8_matmul_gate_forward"].append(
            sweep_int8.int8_model_call(m=m, unembed=False))
        emit("int8_matmul_gate_forward",
             **records["int8_matmul_gate_forward"][-1])

    lap("3-3b_kernels")

    # 4. The bucketed path.
    from distributed_lms_raft_llm_tpu_torch.engine import (
        BatchingQueue,
        EngineConfig,
        SamplingParams,
        TutoringEngine,
    )
    from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
        PROMPT_TEMPLATE,
    )
    from distributed_lms_raft_llm_tpu_torch.tools import profile_decode

    prompts = [PROMPT_TEMPLATE.format(query=q) for q in QUESTIONS]
    common = dict(model="gpt2", checkpoint=args.checkpoint,
                  vocab_path=args.vocab, merges_path=args.merges,
                  seed=args.seed, device="cuda")
    greedy_eng = TutoringEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=32), **common))
    sampled_eng = TutoringEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=64),
        **common))
    cfg = greedy_eng.cfg
    check(cfg.fused_decode_attention and cfg.num_layers == 12
          and cfg.hidden_size == 768 and cfg.num_heads == 12
          and cfg.vocab_size == 50257 and cfg.max_position_embeddings == 1024
          and cfg.dtype == torch.bfloat16,
          f"not GPT-2 small at full width in bf16 with the kernel: {cfg}")
    warm_s = greedy_eng.warmup(batch=8) + sampled_eng.warmup(batch=8)
    bucket = greedy_eng.encode_prompts(prompts)[2]

    attention.reset_launch_counts()
    steps0 = greedy_eng.decode_steps + sampled_eng.decode_steps
    runs = {}
    for name, eng in (("greedy_1", greedy_eng), ("greedy_2", greedy_eng),
                      ("sampled", sampled_eng)):
        tok0, eng_steps0 = eng.total_generated_tokens, eng.decode_steps
        answers, wall = run_queue(eng, prompts, BatchingQueue)
        check(len(answers) == 8 and all(isinstance(a, str) for a in answers),
              f"{name}: expected 8 string answers")
        ttfts = eng.last_batch_ttfts
        tokens = eng.total_generated_tokens - tok0
        ttft = sum(ttfts) / len(ttfts)
        runs[name] = dict(answers=answers, wall_s=wall, tokens=tokens,
                          decode_steps=eng.decode_steps - eng_steps0,
                          ttft_s=ttft, tokens_per_s=tokens / wall,
                          decode_tokens_per_s=(tokens - len(prompts))
                          / max(wall - ttft, 1e-9))
    launches = attention.launch_counts[attention.KERNEL]
    steps = greedy_eng.decode_steps + sampled_eng.decode_steps - steps0
    check(steps > 0 and launches == cfg.num_layers * steps,
          f"decode_attention launches {launches} != {cfg.num_layers} layers "
          f"x {steps} decode steps: the main path bypassed the kernel")
    check(runs["greedy_1"]["answers"] == runs["greedy_2"]["answers"],
          "greedy answers changed between two runs")
    for name, run in runs.items():
        emit("main_path", run=name, bucket=bucket,
             **{k: v for k, v in run.items() if k != "answers"})
    emit("main_path_kernel", launches=launches, decode_steps=steps,
         layers=cfg.num_layers, warmup_s=warm_s)
    print("answer_sample " + json.dumps(runs["greedy_1"]["answers"][0][:80]),
          flush=True)
    records["main_path"] = {k: {kk: vv for kk, vv in v.items()
                                if kk != "answers"} for k, v in runs.items()}
    records["main_path_launches"] = launches
    records["main_path_decode_steps"] = steps

    records["profile"] = profile_decode.profile_generate(torch, greedy_eng,
                                                        prompts)
    emit("profile_greedy_batch", **records["profile"])

    # The kernel at the widest window this run's decode gave it, with q
    # strided as the model passes it.
    main_case = attention_case(torch, attention, b=8, h=12, hkv=12,
                               s=bucket + 64, strided_q=True, seed=1)
    emit("attention_main_shape", **main_case)

    # Kernel path vs plain path, greedy tokens in float32.
    f32 = dict(common, dtype=torch.float32, param_dtype=torch.float32,
               sampling=SamplingParams.greedy(max_new_tokens=32))
    fused_eng = TutoringEngine(EngineConfig(fused_attention=True, **f32))
    plain_eng = TutoringEngine(EngineConfig(fused_attention=False, **f32))
    ids, mask, _ = fused_eng.encode_prompts(prompts)
    fused_res = fused_eng.generate_ids(ids, mask)
    plain_res = plain_eng.generate_ids(ids, mask)
    same = bool((fused_res.tokens == plain_res.tokens).all())
    check(same and (fused_res.lengths == plain_res.lengths).all(),
          "float32 greedy tokens differ between kernel and plain paths")
    with torch.inference_mode():
        logits, _ = fused_eng.family.forward(
            fused_eng.params, fused_eng.cfg,
            torch.as_tensor(ids[:2, -8:], device="cuda").long())
    check(tuple(logits.shape) == (2, 8, 50257)
          and bool(torch.isfinite(logits).all()),
          "full-width forward logits are not finite [2, 8, 50257]")
    emit("f32_greedy_kernel_vs_plain", equal=same,
         tokens=int(fused_res.lengths.sum()))
    del fused_eng, plain_eng

    lap("4_bucketed")

    # 4b. The production path: PagedQueue -> PagedEngine, int8 weights and
    # an int8 KV cache (configs/cluster.toml's tutoring node, without the
    # megastep, the prefix cache and fused admission).
    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        PagedQueue,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    prod = dict(common, quant="int8", kv_quant=True)
    # The sequential config, run eagerly (the baseline that phase 4c's
    # graphs are read against).
    paged_kw = dict(slots=16, chunk=16, inflight=3, cuda_graphs=False)
    greedy_paged = PagedEngine(EngineConfig(
        sampling=SamplingParams.greedy(max_new_tokens=128), **prod),
        **paged_kw)
    sampled_paged = PagedEngine(EngineConfig(
        sampling=SamplingParams.reference_defaults(max_new_tokens=128),
        **prod), **paged_kw)
    pcfg = greedy_paged.cfg
    check(pcfg.fused_decode_attention and pcfg.quant_kv
          and pcfg.num_layers == 12 and pcfg.hidden_size == 768
          and pcfg.vocab_size == 50257 and pcfg.dtype == torch.bfloat16
          and isinstance(greedy_paged.params["wte"], dict)
          and greedy_paged.state.cache.k.dtype == torch.int8
          and greedy_paged.widths == [160, 192, 256, 384],
          f"not the production configuration: {pcfg}, widths "
          f"{greedy_paged.widths}")
    paged_warm_s = greedy_paged.warmup() + sampled_paged.warmup()
    wave1, wave2 = paged_waves()
    attention.reset_launch_counts()
    quant_matmul.reset_launch_counts()
    engines = (greedy_paged, sampled_paged)
    calls0 = [(e.decode_steps, e.prefill_calls) for e in engines]
    paged_runs = {}
    for name, eng in (("greedy_1", greedy_paged), ("greedy_2", greedy_paged),
                      ("sampled", sampled_paged)):
        tok0, steps0 = eng.total_generated_tokens, eng.decode_steps
        answers, wall, snap = run_paged_waves(eng, PagedQueue, Metrics,
                                              wave1, wave2)
        check(len(answers) == 24 and all(isinstance(a, str)
                                         for a in answers),
              f"{name}: expected 24 string answers")
        tokens = eng.total_generated_tokens - tok0
        lat, counters = snap["latency"], snap["counters"]
        grows = lat.get("engine_prog_grow", {}).get("count", 0)
        check(grows >= 1 and counters.get("decode_stalled_tokens", 0) > 0,
              f"{name}: the second wave did not join mid-decode and widen "
              f"the cache (grows {grows}, counters {counters})")
        paged_runs[name] = dict(
            answers=answers, wall_s=wall, tokens=tokens,
            tokens_per_s=tokens / wall,
            decode_steps=eng.decode_steps - steps0,
            ttft_mean_s=lat["ttft"]["mean_s"], ttft_p50_s=lat["ttft"]["p50_s"],
            ttft_max_s=lat["ttft"]["max_s"], grows=grows,
            decode_stalled_tokens=counters["decode_stalled_tokens"],
            host_dispatches_per_token=snap["gauges"][
                "host_dispatches_per_token"])
    decode_calls = sum(e.decode_steps - d0
                       for e, (d0, _) in zip(engines, calls0))
    model_calls = decode_calls + sum(e.prefill_calls - p0
                                     for e, (_, p0) in zip(engines, calls0))
    int8kv_launches = attention.launch_counts[attention.APPEND_INT8KV]
    mm_launches = quant_matmul.launch_counts[quant_matmul.KERNEL]
    quant_matmul_routes_4b = dict(quant_matmul.launch_counts)
    mm_routes = {name: quant_matmul.launch_counts[name] for name in (
        quant_matmul.MMA, quant_matmul.MMA_UNEMBED, quant_matmul.WGMMA,
        quant_matmul.WGMMA_UNEMBED, quant_matmul.FMA)}
    check(decode_calls > 0
          and int8kv_launches == pcfg.num_layers * decode_calls,
          f"decode_attention_append_int8kv launches {int8kv_launches} != "
          f"{pcfg.num_layers} layers x {decode_calls} decode model calls")
    # by route: decode calls (16 slots) on the mma.sync tiles, prefills
    # (a prompt bucket of rows) on the wgmma ones
    check_int8_routes(quant_matmul.launch_counts, int8_want(
        quant_matmul, paged_calls(quant_matmul, greedy_paged, decode_calls,
                                  0, model_calls - decode_calls), 48),
        "phase 4b")
    check(all(attention.launch_counts[n] == 0 for n in (
        attention.KERNEL, attention.RAGGED, attention.INT8KV,
        attention.APPEND)),
          "the int8-KV paged path launched a one-row attention variant "
          "other than the int8 append kernel")
    check(paged_runs["greedy_1"]["answers"] == paged_runs["greedy_2"]["answers"],
          "paged greedy answers changed between two runs")
    for name, run in paged_runs.items():
        emit("production_path", run=name,
             **{k: v for k, v in run.items() if k != "answers"})
    emit("production_path_kernels", int8kv_launches=int8kv_launches,
         int8_matmul_launches=mm_launches, int8_matmul_routes=mm_routes,
         decode_model_calls=decode_calls, model_calls=model_calls,
         warmup_s=paged_warm_s)
    records["production_path"] = {
        k: {kk: vv for kk, vv in v.items() if kk != "answers"}
        for k, v in paged_runs.items()}
    records["production_path_launches"] = dict(
        int8kv=int8kv_launches, int8_matmul=mm_launches,
        int8_matmul_routes=mm_routes, decode_model_calls=decode_calls,
        model_calls=model_calls)
    records["production_profile"] = profile_paged(torch, greedy_paged,
                                                  wave1 + wave2[:4])
    emit("profile_production_step", **records["production_profile"])
    deploy_wave1, deploy_wave2 = deployment_waves()
    records["production_drain"] = profile_drain(
        torch, greedy_paged, deploy_wave1 + deploy_wave2)
    emit("profile_production_drain", **records["production_drain"])
    del greedy_paged, sampled_paged

    # The paged engine in float32, int8 weights: kernel vs plain attention
    # over an int8 and over a dense cache (the latter is the run that
    # launches decode_attention_ragged).
    f32_checks = [paged_f32_check(torch, attention, PagedEngine,
                                  EngineConfig, SamplingParams, common,
                                  wave1 + wave2, kv_quant)
                  for kv_quant in (True, False)]
    for rec in f32_checks:
        emit("f32_paged_kernel_vs_plain", **rec)
    records["f32_paged_checks"] = f32_checks
    ragged_launches = f32_checks[1]["launches"]

    lap("4b_production")

    # 4c. The deployment config: megastep as CUDA-graph replays, fused
    # staged admission and the radix prefix cache on top of phase 4b.
    records["deployment"], deploy_refs = deployment_phase(
        torch, attention, quant_matmul, PagedEngine, PagedQueue, Metrics,
        EngineConfig, SamplingParams, prod, records["production_profile"],
        records["production_drain"])
    deploy_launches = records["deployment"]["launches"]
    lap("4c_deployment")

    # 5. gRPC: the repaired unary round trip, then streaming, sessions and
    # drain on the deployment config, under a tokenizer that decodes every
    # sampled id.
    del greedy_eng, sampled_eng
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        vocab, merges, tok_record = phase5_tokenizer(args, Path(tmp))
        emit("phase5_tokenizer", **tok_record)
        unary_eng = TutoringEngine(EngineConfig(
            sampling=SamplingParams.greedy(max_new_tokens=32),
            **dict(common, vocab_path=vocab, merges_path=merges)))
        unary_eng.warmup(batch=1)
        records["grpc"] = dict(grpc_round_trip(unary_eng, PROMPT_TEMPLATE),
                               **tok_record)
        emit("grpc", **records["grpc"])
        del unary_eng
        records["streaming"] = streaming_phase(
            torch, attention, quant_matmul, PagedEngine, EngineConfig,
            SamplingParams, prod, vocab, merges)
    emit("streaming", **records["streaming"])
    lap("5_grpc_streaming")

    # 6. The relevance gate at bert-base width, beside phase 5's TTFT.
    records["gate"] = gate_phase(torch, attention, quant_matmul, args,
                                 records["streaming"])
    emit("gate", **records["gate"])
    lap("6_gate")

    # 7. Speculative decoding on the deployment config, beside phase 4c.
    window_cases = {}
    records["spec"] = spec_phase(torch, attention, quant_matmul, prod,
                                 common, deploy_refs, args, window_cases)
    spec_launches = records["spec"]["deployment"]["launches"]
    lap("7_spec")

    # 8. The bulk-scoring tenant on the deployment config, the node started
    # from configs/cluster.toml.
    records["scoring"] = scoring_phase(torch, attention, quant_matmul, args)
    lap("8_scoring")

    # 9. Llama-3-8B at full width: its kernels' shapes, a float32 witness
    # cut to 4 layers, the deployment config at full depth, a quantum.
    records["llama"] = llama_phase(torch, attention, quant_matmul, args)
    llama_launches = records["llama"]["launches"]
    llama_spec_launches = records["llama"]["spec_launches"]
    lap("9_llama")

    # 10. gpt2-moe at full width: a float32 witness cut to 4 layers, the
    # deployment config at full depth, a scoring quantum.
    records["moe"] = moe_phase(torch, attention, quant_matmul, args)
    moe_launches = records["moe"]["deployment"]["launches"]
    moe_f32_launches = records["moe"]["witness"]["runs"]["kernels"][
        "launches"]
    lap("10_moe")

    # 11. The LMS main path: five port LMS processes started from a copy of
    # configs/cluster.toml, the gate on the card in each, a student's
    # questions answered through the tutoring node in this process.
    torch.cuda.empty_cache()
    # 11b. The same path through a two-group LMS (its processes boot
    # during phase 11; the phase runs on phase 11's node before it stops).
    records["lms"] = lms_phase(torch, attention, quant_matmul, args, smi)
    records["lms_groups"] = records["lms"].pop("groups")
    emit("lms", **records["lms"])
    emit("lms_groups", **records["lms_groups"])
    lms_launches = records["lms"]["launches"]
    group_launches = records["lms_groups"]["launches"]
    lap("11_lms")
    phase_s["11b_groups"] = records["lms_groups"]["seconds"]
    phase_s["11_lms"] -= phase_s["11b_groups"]

    # 12. Fine-tune GPT-2 small on course material through the port's
    # trainer, resume, export, and serve the export through a tutoring
    # node from configs/cluster.toml; then gpt2-moe a few steps.
    torch.cuda.empty_cache()
    records["train"] = train_phase(torch, attention, quant_matmul, args, smi)
    emit("train", **{k: v for k, v in records["train"].items()
                     if k in ("card", "seconds", "train", "resume")})
    train_launches = records["train"]["serve"]["launches"]
    lap("12_train")

    # 13. One seeded semester (configs/cluster.toml [sim]) on the port's
    # LMS, tutoring node 0 on the deployment engine.
    torch.cuda.empty_cache()
    records["sim"] = sim_phase(torch, attention, quant_matmul, args, smi)
    emit("sim", **{k: records["sim"][k] for k in (
        "card", "seconds", "headline", "node0", "launches")})
    sim_launches = records["sim"]["launches"]
    lap("13_sim")

    # 14. Tensor parallelism: two gloo ranks on the card serve Llama-3-8B's
    # widths (4 layers), held against tp 1; every kernel at its shard's
    # shapes.
    torch.cuda.empty_cache()
    # 15. The rest of serving's parallel axes in the same two ranks:
    # gpt2-moe over two ep ranks, GPT-2 small's scoring over two sp ranks,
    # the gate over two tp ranks; a dropped graphed engine freed.
    records["tp"] = tp_phase(torch, attention, quant_matmul, args, smi)
    records["ep_sp_gate"] = records["tp"].pop("ep_sp_gate")
    records["train_sharded"] = records["tp"].pop("train_sharded")
    records["dp"] = records["tp"].pop("dp")
    tp_launches_ = records["tp"]["launches"]
    ep_launches_ = records["ep_sp_gate"]["launches"]
    lap("14_tp")
    phase_s["15_ep_sp_gate"] = records["ep_sp_gate"]["seconds"]
    phase_s["16_train_sharded"] = records["train_sharded"]["seconds"]
    phase_s["17_dp"] = records["dp"]["seconds"]
    phase_s["14_tp"] -= (phase_s["15_ep_sp_gate"]
                         + phase_s["16_train_sharded"] + phase_s["17_dp"])

    # 18. GPT-2 small's deployment and the bert-base gate served from
    # artifacts the port's tool builds on the card (configs/cluster.toml
    # with only the file flags pointed at them), and profile_decode on
    # them.
    records["artifacts"] = artifacts_phase(torch, attention, quant_matmul,
                                           args)
    art_launches = records["artifacts"]["node"]["launches"]
    prof_launches = records["artifacts"]["profiles"]["launches"]
    lap("18_artifacts")

    records["seconds"] = time.monotonic() - t_start
    phase_s["total"] = records["seconds"]
    emit("phase_seconds", **phase_s)
    records["phase_seconds"] = phase_s
    def paged_case(int8, dtype="bfloat16"):  # 16 slots, width 384
        return next(c for c in paged_cases if c["int8"] == int8
                    and c["slots"] == 16 and c["width"] == 384
                    and c["dtype"] == dtype)

    def append_case(cache):  # the same shape through the append kernel
        return next(c for c in append_cases if c["cache"] == cache
                    and c["slots"] == 16 and c["width"] == 384
                    and c["hkv"] == 12)

    def entry(name, replaces, launches, case, **extra):
        source = ("int8_matmul" if name.startswith("int8_matmul")
                  else "decode_attention")
        return dict({
            "name": name, "route": "cuda",
            "source": extra.pop("source",
                                f"{PACKAGE}/ops/csrc/{source}.cu"),
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"],
            "ms": case["kernel_us"] / 1e3, "plain_ms": case["plain_us"] / 1e3,
            "bound_ms": case["bound_us"] / 1e3,
            "bound_by": case.get("bound_by", "bytes"),
            "library_ms": (None if case["library_us"] is None
                           else case["library_us"] / 1e3),
            "eager_ms": case["kernel_eager_us"] / 1e3,
        }, **extra)

    window_note = ("SDPA, [B, 1, T, S] boolean mask (the int8 cache "
                   "dequantized beforehand)")
    bucketed_case, int8_case = window_cases["bucketed"], window_cases["int8"]
    unembed_case = next(c for c in mm_cases if c["name"] == "wte.unembed"
                        and c["m"] == 16 and c["dtype"] == "bfloat16")
    pallas = "distributed_lms_raft_llm_tpu/ops/attention.py:88"
    kernels = [
        entry("decode_attention", pallas, launches, main_case,
              n_split=main_case["n_split"]),
        entry(attention.APPEND, pallas + " (extended: the paged step's "
              "append and attend, distributed_lms_raft_llm_tpu/models/"
              "gpt2.py:367-394 and models/common.py:163 attend)",
              ragged_launches,
              append_case("float32"),
              library_note=append_case("float32")["library_note"],
              old_kernel_ms=append_case("float32")["old_kernel_us"] / 1e3,
              old_sequence_ms=append_case("float32")["old_sequence_us"]
              / 1e3, replaced_variant=attention.RAGGED,
              replaced_variant_ms=paged_case(False, "float32")["kernel_us"]
              / 1e3, launches_path="4b's float32 paged check, dense cache "
              "(the times: its float32 case)"),
        entry(attention.APPEND_INT8KV, pallas + " (extended: the paged "
              "step's quantize_kv append and attend over the int8 cache, "
              "distributed_lms_raft_llm_tpu/models/common.py:121-131 and "
              ":133 attend_quant, models/gpt2.py:367-394)",
              deploy_launches[attention.APPEND_INT8KV], append_case("int8"),
              library_note=append_case("int8")["library_note"],
              old_kernel_ms=append_case("int8")["old_kernel_us"] / 1e3,
              old_sequence_ms=append_case("int8")["old_sequence_us"] / 1e3,
              replaced_variant=attention.INT8KV,
              replaced_variant_ms=paged_case(True)["kernel_us"] / 1e3,
              launches_by_path={
                  "4b": int8kv_launches,
                  "4c": deploy_launches[attention.APPEND_INT8KV],
                  "9": llama_launches[attention.APPEND_INT8KV],
                  "10": moe_launches[attention.APPEND_INT8KV],
                  "11": lms_launches[attention.APPEND_INT8KV],
                  "11b": group_launches[attention.APPEND_INT8KV],
                  "12": train_launches[attention.APPEND_INT8KV],
                  "13": sim_launches.get(attention.APPEND_INT8KV, 0),
                  "15_ep_rank0": ep_launches_["ep"].get(
                      attention.APPEND_INT8KV, 0),
                  "15_ep_rank1": ep_launches_["ep_rank1"].get(
                      attention.APPEND_INT8KV, 0),
                  "18b": art_launches.get(attention.APPEND_INT8KV, 0)}),
        entry("int8_matmul", "no Pallas kernel: distributed_lms_raft_llm_tpu/"
              "models/common.py:58 and models/quant.py:139 (XLA-fused int8 "
              "einsums)", deploy_launches[quant_matmul.KERNEL],
              dict(model_call, max_abs_err=max(c["max_abs_err"]
                                               for c in mm_cases)),
              shape="the 49 products of one decode model call, M=16, bf16",
              library_note="cuBLAS torch.matmul against weights "
              "dequantized to bf16 beforehand (the bf16 config's "
              "products)",
              launches_by_path={
                  "4b": mm_launches,
                  "4c": deploy_launches[quant_matmul.KERNEL],
                  "6": records["gate"]["int8"]["int8_matmul_launches"][
                      quant_matmul.KERNEL],
                  "9": llama_launches[quant_matmul.KERNEL],
                  "10": moe_launches[quant_matmul.KERNEL],
                  "11": lms_launches[quant_matmul.KERNEL],
                  "11b": group_launches[quant_matmul.KERNEL],
                  "12": train_launches[quant_matmul.KERNEL],
                  "13": sim_launches.get(quant_matmul.KERNEL, 0),
                  "18b": art_launches.get(quant_matmul.KERNEL, 0),
                  "18d": prof_launches.get(quant_matmul.KERNEL, 0)}),
        entry(quant_matmul.MMA_UNEMBED, "no Pallas kernel: "
              "distributed_lms_raft_llm_tpu/models/quant.py:139 (the "
              "XLA-fused int8 unembedding einsum)",
              deploy_launches[quant_matmul.MMA_UNEMBED], unembed_case,
              launches_by_path={
                  "4b": mm_routes[quant_matmul.MMA_UNEMBED],
                  "4c": deploy_launches[quant_matmul.MMA_UNEMBED],
                  "9": llama_launches[quant_matmul.MMA_UNEMBED],
                  "10": moe_launches[quant_matmul.MMA_UNEMBED],
                  "11": lms_launches[quant_matmul.MMA_UNEMBED],
                  "11b": group_launches[quant_matmul.MMA_UNEMBED],
                  "12": train_launches[quant_matmul.MMA_UNEMBED],
                  "13": sim_launches.get(quant_matmul.MMA_UNEMBED, 0),
                  "18b": art_launches.get(quant_matmul.MMA_UNEMBED, 0),
                  "18d": prof_launches.get(quant_matmul.MMA_UNEMBED, 0)},
              shape="the tied unembedding 50257 x 768, M=16, bf16 x, "
              "float32 logits",
              walked_bytes=unembed_case["walked_bytes"],
              library_note=unembed_case["library_note"]),
        entry(attention.WINDOW, pallas + " (extended: T = k+1 query rows "
              "a row, the speculative verify window of "
              "distributed_lms_raft_llm_tpu/models/gpt2.py:367-400)",
              records["spec"]["main_window_launches"], bucketed_case,
              library_note=window_note,
              max_row_rel_err=bucketed_case["max_row_rel_err"],
              shape=f"{bucketed_case['slots']} rows x T="
              f"{bucketed_case['t']}, width {bucketed_case['width']}, bf16 "
              "cache, padding bias (the bucketed engine, spec 8)",
              launches_path="7b, bucketed bf16 spec 8"),
        entry(attention.WINDOW_INT8KV, pallas + " (extended: T = k+1 "
              "query rows a row over the int8 cache, the paged verify "
              "window of distributed_lms_raft_llm_tpu/engine/paged.py:"
              "515-606)", spec_launches[attention.WINDOW_INT8KV],
              int8_case, library_note=window_note,
              max_row_rel_err=int8_case["max_row_rel_err"],
              shape=f"{int8_case['slots']} slots x T={int8_case['t']}, "
              f"width {int8_case['width']}, int8 cache, bf16 q",
              launches_path="7c, the deployment with spec 8",
              launches_by_path={
                  "7c": spec_launches[attention.WINDOW_INT8KV],
                  "9": llama_spec_launches[attention.WINDOW_INT8KV]}),
    ]
    def expert_case(dtype, c=5):  # moe.wi, the decode capacity
        return next(x for x in expert_cases if x["name"] == "moe.wi"
                    and x["c"] == c and x["dtype"] == dtype)

    def by_path(route):
        """A route's launches on each path that ran it."""
        paths = {
            "4b": quant_matmul_routes_4b, "4c": deploy_launches,
            "5": records["streaming"]["launches"],
            "6": records["gate"]["int8"]["int8_matmul_launches"],
            "7c": spec_launches, "8": records["scoring"]["quantum_launches"],
            "9": llama_launches,
            "9_quantum": records["llama"]["deployment"]["score_quantum"][
                "launches"],
            "9_spec": llama_spec_launches, "10": moe_launches,
            "10_quantum": records["moe"]["deployment"]["score_quantum"][
                "launches"],
            "11": lms_launches, "11b": group_launches, "12": train_launches,
            "13": sim_launches, "18b": art_launches, "18d": prof_launches}
        return {k: v.get(route, 0) for k, v in paths.items()
                if v.get(route, 0)}

    moe_ref = ("no Pallas kernel: distributed_lms_raft_llm_tpu/models/"
               "moe.py:164-171 (expert_dense, XLA-fused int8 einsums "
               "ecd,edm->ecm)")
    kernels += [
        entry(quant_matmul.MMA_EXPERTS, moe_ref,
              moe_launches[quant_matmul.MMA_EXPERTS], expert_case("bfloat16"),
              shape="gpt2-moe's wi, 8 experts x C=5 rows (decode, 16 "
              "slots), 768 x 3072, bf16",
              library_note=expert_case("bfloat16")["library_note"],
              launches_path="10, the deployment config (24 a model call)"),
        entry(quant_matmul.FMA_EXPERTS, moe_ref,
              moe_f32_launches[quant_matmul.FMA_EXPERTS],
              expert_case("float32"),
              shape="gpt2-moe's wi, 8 experts x C=5 rows, 768 x 3072, "
              "float32 (CUDA cores)",
              library_note=expert_case("float32")["library_note"],
              launches_path="10's float32 witness (8 a model call)"),
    ]
    # The wgmma route (csrc/int8_matmul_wgmma.cu), bf16 x from
    # WGMMA_MIN_ROWS rows: its times beside the mma.sync route it replaced
    # there (old_kernel_ms) at the main path's shapes.
    chunk_err = max(c["max_abs_err"] for c in mm_cases
                    if c["m"] == 32 and c["dtype"] == "bfloat16"
                    and not c["transposed"])
    wide_unembed = next(c for c in mm_cases if c["name"] == "wte.unembed"
                        and c["m"] == 32 and c["dtype"] == "bfloat16")
    wide_experts = expert_case("bfloat16", c=640)
    wgmma_src = f"{PACKAGE}/ops/csrc/int8_matmul_wgmma.cu"
    kernels += [
        entry(quant_matmul.WGMMA, "no Pallas kernel: "
              "distributed_lms_raft_llm_tpu/models/common.py:58-60 (dense, "
              "an XLA-fused int8 einsum)",
              deploy_launches[quant_matmul.WGMMA],
              dict(chunk_call, max_abs_err=chunk_err,
                   bound_by="bytes"),
              source=wgmma_src,
              shape="the 48 dense products of one admission chunk, M=32, "
              "bf16", old_kernel_ms=chunk_call["replaced_us"] / 1e3,
              replaced_variant=quant_matmul.MMA,
              library_note="cuBLAS torch.matmul against weights "
              "dequantized to bf16 beforehand",
              launches_path="4c, the deployment (48 an admission chunk)",
              launches_by_path=by_path(quant_matmul.WGMMA)),
        entry(quant_matmul.WGMMA_UNEMBED, "no Pallas kernel: "
              "distributed_lms_raft_llm_tpu/models/quant.py:139-146 (the "
              "XLA-fused int8 unembedding einsum)",
              deploy_launches[quant_matmul.WGMMA_UNEMBED], wide_unembed,
              source=wgmma_src,
              shape="the tied unembedding 50257 x 768, M=32 (an admission "
              "chunk), bf16 x, float32 logits",
              old_kernel_ms=wide_unembed["replaced_us"] / 1e3,
              replaced_variant=quant_matmul.MMA_UNEMBED,
              library_note=wide_unembed["library_note"],
              launches_path="4c, the deployment (1 an admission chunk)",
              launches_by_path=by_path(quant_matmul.WGMMA_UNEMBED)),
        entry(quant_matmul.WGMMA_EXPERTS, "no Pallas kernel: "
              "distributed_lms_raft_llm_tpu/models/moe.py:168-170 "
              "(expert_dense, XLA-fused int8 einsums ecd,edm->ecm)",
              records["moe"]["deployment"]["score_quantum"]["launches"].get(
                  quant_matmul.WGMMA_EXPERTS, 0), wide_experts,
              source=wgmma_src,
              shape="gpt2-moe's wi, 8 experts x C=640 rows (a scoring "
              "quantum of 8 x 256), 768 x 3072, bf16",
              old_kernel_ms=wide_experts["replaced_us"] / 1e3,
              replaced_variant=quant_matmul.MMA_EXPERTS,
              library_note=wide_experts["library_note"],
              launches_path="10's scoring quantum (24 a quantum)",
              launches_by_path=by_path(quant_matmul.WGMMA_EXPERTS)),
    ]
    # Phase 14: each kernel at a tp rank's shard shapes (Llama-3-8B's
    # widths over two ranks), its launches those of rank 0 over the
    # deployment run (rank 1's are equal, checked).
    tp_append = records["tp"]["kernels"]["append"]
    kernels.append(entry(
        f"{attention.APPEND_INT8KV}[tp2 shard: 16 of 32 query heads over 4 "
        f"of 8 KV heads, Dh 128]", pallas + " (extended: the paged step's "
        "append and attend over the int8 cache)",
        tp_launches_.get(attention.APPEND_INT8KV, 0), tp_append,
        library_note=tp_append["library_note"],
        shape="16 slots, width 384, int8 cache, bf16 q, H 16 / Hkv 4",
        launches_path="14b, rank 0 of 2 (gloo, one card)"))
    for case in records["tp"]["kernels"]["int8_matmul"]:
        kernels.append(entry(
            f"{case['route']}[tp2 shard: {case['name']}, M={case['m']}]",
            "no Pallas kernel: distributed_lms_raft_llm_tpu/models/"
            "common.py:58-60 and models/quant.py:139-146 (XLA-fused int8 "
            "einsums, sharded by parallel/partition.py LLAMA_RULES)",
            tp_launches_.get(case["route"], 0), case,
            source=(wgmma_src if case["route"].startswith(
                "int8_matmul_wgmma") else f"{PACKAGE}/ops/csrc/"
                "int8_matmul.cu"),
            shape=f"K {case['k']} x N {case['n']}"
            f"{' (transposed)' if case['transposed'] else ''}, M "
            f"{case['m']}, bf16",
            library_note=case["library_note"],
            launches_path="14b, rank 0 of 2: the route's launches over "
            "the deployment run"))
    # Phase 15: the expert kernel at an ep-2 rank's 4 experts, its
    # launches rank 0's over the ep runs (witness, deployment, quantum);
    # BERT-base's products' tp-2 halves, their launches rank 0's over the
    # gate's checks.
    ep_rec = records["ep_sp_gate"]
    for case in ep_rec["kernels"]["experts"]:
        kernels.append(entry(
            f"{case['route']}[ep2 rank: {case['experts']} of 8 experts, "
            f"{case['name']}, C={case['c']}]", moe_ref,
            ep_launches_["ep"].get(case["route"], 0), case,
            source=(wgmma_src if case["route"].startswith(
                "int8_matmul_wgmma") else f"{PACKAGE}/ops/csrc/"
                "int8_matmul.cu"),
            shape=f"{case['experts']} experts x C={case['c']} rows, K "
            f"{case['k']} x N {case['n']}, {case['dtype']}",
            library_note=case["library_note"],
            launches_path="15a, rank 0 of 2 ep ranks: the route's launches "
            "over the float32 witness, the deployment run and a scoring "
            "quantum"))
    for case in ep_rec["kernels"]["gate_products"]:
        kernels.append(entry(
            f"{case['route']}[gate tp2 shard: {case['name']}, M={case['m']}]",
            "no Pallas kernel: distributed_lms_raft_llm_tpu/models/"
            "common.py:58-60 (XLA-fused int8 einsums of models/bert.py, "
            "sharded by parallel/partition.py BERT_RULES)",
            ep_launches_["gate"].get(case["route"], 0), case,
            source=(wgmma_src if case["route"].startswith(
                "int8_matmul_wgmma") else f"{PACKAGE}/ops/csrc/"
                "int8_matmul.cu"),
            shape=f"K {case['k']} x N {case['n']}, M {case['m']}, bf16",
            library_note=case["library_note"],
            launches_path="15c, rank 0 of 2 gate tp ranks: the route's "
            "launches over the 8 checks"))
    # Phase 17: the kernels a dp-2 rank of GPT-2 small's deployment runs,
    # their launches rank 0's (rank 1's and dp 1's are equal, checked), at
    # the shapes phase 3b timed them.
    dp_runs = records["dp"]["launches"]
    f32_wi = next(c for c in mm_cases if c["name"] == "mlp.wi"
                  and c["m"] == 16 and c["dtype"] == "float32")
    gate_wi = next(c for c in mm_cases if c["name"] == "mlp.wi"
                   and c["m"] == 256 and c["dtype"] == "bfloat16")
    kernels += [
        entry(f"{attention.APPEND_INT8KV}[dp2 rank: GPT-2 small's "
              f"deployment, float32]", pallas + " (extended: the paged "
              "step's append and attend over the int8 cache)",
              dp_runs["witness"].get(attention.APPEND_INT8KV, 0),
              append_case("int8"),
              library_note=append_case("int8")["library_note"],
              shape="16 slots, width 384, int8 cache, bf16 q (the dp run's "
              "q is float32)",
              launches_path="17a, rank 0 of 2 dp ranks, through the graph "
              "replays"),
        entry(f"{attention.INT8KV}[dp2 rank: the bucketed engine, float32]",
              pallas + " (extended: per-row lengths over the int8 cache)",
              dp_runs["bucketed"].get(attention.INT8KV, 0),
              paged_case(True, "float32"),
              library_note=paged_case(True, "float32")["library_note"],
              shape="16 rows, width 384, int8 cache, float32",
              launches_path="17b, rank 0 of 2 dp ranks: one generate of 4 "
              "questions"),
        entry(f"{quant_matmul.FMA}[dp2 rank: float32, M=16]",
              "no Pallas kernel: distributed_lms_raft_llm_tpu/models/"
              "common.py:58-60 and models/quant.py:139-146 (XLA-fused int8 "
              "einsums)", dp_runs["witness"].get(quant_matmul.FMA, 0)
              + dp_runs["bucketed"].get(quant_matmul.FMA, 0), f32_wi,
              source=f"{PACKAGE}/ops/csrc/int8_matmul.cu",
              shape="mlp.wi 768 x 3072, M 16, float32 (CUDA cores)",
              library_note=f32_wi["library_note"],
              launches_path="17a and 17b, rank 0 of 2 dp ranks"),
        entry(f"{quant_matmul.WGMMA}[dp2 rank: the gate's check]",
              "no Pallas kernel: distributed_lms_raft_llm_tpu/models/"
              "common.py:58-60 (XLA-fused int8 einsums of models/bert.py)",
              dp_runs["gate"].get(quant_matmul.WGMMA, 0), gate_wi,
              source=wgmma_src,
              shape="mlp.wi 768 x 3072, M 256, bf16 (GPT-2's product at "
              "the gate's rows)", library_note=gate_wi["library_note"],
              launches_path="17c, rank 0 of 2 dp ranks: one check"),
    ]
    # Phase 18 (d): the bucketed engine's int8-cache decode attention in
    # profile_decode's device mode (8 rows, bf16), at its shape in phase
    # 3b (the whole 192-slot cache, the model's bias).
    bucketed_int8 = next(c for c in paged_cases if c["bias"])
    kernels.append(entry(
        f"{attention.INT8KV}[the bucketed engine, int8 cache, bf16]",
        pallas + " (extended: the int8 cache)",
        prof_launches.get(attention.INT8KV, 0), bucketed_int8,
        library_note=bucketed_int8["library_note"],
        shape="8 rows, width 192 of a 192-slot cache (64-token prompts + "
        "128 new), int8 cache, bf16 q, the model's bias, the last step",
        launches_path="18d, profile_decode's device mode on the built "
        "checkpoint: four generates of 8 x 128 tokens"))
    records["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
