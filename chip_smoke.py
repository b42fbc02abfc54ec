#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:

1. device   — a CUDA card must be present; prints its name and power
              limit as nvidia-smi reports them.
2. build    — builds the CUDA kernels from the sources in this checkout
              (nvcc, sm_90a, one process per source, all started together:
              socket_score.cu, flash_decode.cu, paged_attention.cu,
              paged_quest.cu, paged_ring.cu, flash_prefill.cu); phase 3
              waits for the contiguous kernels' builds alone, and the
              paged kernels' (paged_attention.cu's takes 90-130 s) go on
              through phase 3's contiguous cases and phase 4, after
              which phase 3's paged cases run.
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at edge shapes, with the tolerance
              stated; times kernel, plain version and (where one exists) the
              one PyTorch call computing the same function on the device
              (CUDA-graph replay), beside the least time the card could
              take, and the kernel once more launched back to back from
              Python (the host's launch rate).  ``socket_score`` at the
              static path's shape (f32 words, with vnorm, int8 planes,
              pooled G 1; f32 words and int8 planes timed) and at its
              edges (G 3 / P 7, P 1, P 20 on the sign-add instance, BH
              256 on C 1 in several waves, tables in chunks at P 16 and
              at P 24 / L 600), every case logged with its launch plan
              (C, clusters at once, shared memory, instance) and failing
              where the plan does not exercise its label; keys given
              equal bits on every rank of the cluster must score
              bit-equal (f32 words and int8 planes).  ``flash_decode`` on
              every case of its ``cases.CARD_CASES`` (the static path's
              shape, B 1, stablelm hd 160, gemma-7b hd 256 / G 1, mixtral
              G 6, K < C, BH 256 / K 64, bf16 and f16 K/V, fully masked
              rows, which must return exactly 0; its softmax partials
              ``m``/``l``, the context-parallel ranks' merge input, within
              ATTN_TOL of the plain version's, the output launched with
              them bit-equal to the output without, and a fully masked
              row's exactly (-1e30, 0)), each logged with its
              launch plan (``ops.flash_decode_plan``: C, clusters at once,
              shared memory, stages) and failing where the plan does not
              exercise its label; timed at the main shape with the host's
              microseconds a call; its build's ptxas registers and spills
              are logged, and ``cuobjdump -sass`` of the library must show
              asynchronous copies (``LDGSTS`` or ``UTMALDG``).  The four fused paged
              kernels again on pools stored as bf16, int8 and fp8 (the main
              case and an edge: ties, or a ring whose dead rows hold NaN in
              scales and fp8 payloads), SOCKET's and hard LSH's selections
              also equal to their own on the f32 pages; int8 and fp8 are
              timed as entries ``name[int8]``, ``name[fp8]``.  SOCKET,
              hard LSH and Quest also run, on every pool, the cases of the
              cluster split (32K contexts, selected ties across ranks, idle
              ranks and, but for Quest, pooled selection) and the head
              dims of the all-global architectures (gemma-7b's hd 256 at
              KVH 16, G 1; stablelm's hd 160 at G 4; the gemma-7b case
              also timed on f32 pages, entry ``gemma7b`` of the kernel's
              row), every case logged with the split it ran (C, clusters
              the card holds at once, shared memory a CTA, K/V stages and
              the rows a stage holds); the tie case must
              put selected ties on two ranks or more (Quest's must also
              leave a tied page out), the idle case leave a rank idle, and
              Quest's main path run on two ranks or more.  The ring
              kernel runs every case of ``cases.RING_CASES`` on f32,
              bf16, int8 and fp8 pools, each logged with its launch plan
              (``ops.paged_ring_plan``: C, shared memory, stages, the
              fold's lanes) and failing where the plan does not exercise
              its label (a cluster split at B 1 and B 2, empty ranks,
              windows from inside a page, padded rows); it is timed at
              the main shape and at B 2 (``b2``), and its yardstick twice:
              SDPA over views gathered beforehand, and the gather, mask
              and SDPA as one callable (``library_with_gather_ms``).
              The prefill kernel ``flash_prefill`` at llama31-8b's
              prefill (BH 64, BKV
              16, S 8192, hd 128; timed with its plain version and
              ``scaled_dot_product_attention``, beside its bound, that of
              the 3xTF32 products it runs on the tensor cores, and the f32
              one outside them), gemma3's local layers
              (window 1024, S 4096; timed), hd 160 (G 4), hd 256 (G 1 and
              G 4), bf16 inputs (also with a window), ragged S of 4100 and
              9, a window off the key tiles and a score cap (softcap 2,
              window 512); its build's ptxas registers and spills are
              logged per head dim, and ``cuobjdump -sass`` of the
              library must show tensor-core mma (``HMMA``) and
              asynchronous copies (``LDGSTS`` or ``UTMALDG``).
              Where ``socket_score``'s keys with equal bits on
              different ranks score differently, the check first
              relaunches the same inputs 200 times and logs how many
              launches differ and where (bh, key, rank, by how much),
              each rank's split tables as it held them (a build with
              -DSOCKET_SCORE_DUMP_TABLES, ``ops.table_dump``) against the
              other ranks' and the plain ``exp`` tables, and the card's
              uuid, name and power limit; then it fails.
4. main     — llama31-8b at full width and depth through
              ``repro_torch.launch.serve.run_serve``: batch 2, an 8192-token
              prompt drawn from --seed, 32 greedy decode steps, SOCKET with
              both contiguous-path kernels on.  The decode kernels' launch
              counts must equal layers x decode calls, ``flash_prefill``'s
              layers x 1 (the one whole-prompt prefill).  The same run on
              int8 plane bytes (``socket.bits_storage`` "int8"; the
              ``socket_score[int8]`` entry's launches) must give the same
              greedy tokens as packed words.  The prefill runs
              again through the kernel and once through its plain version
              (the same layout code, the op swapped for its plain version):
              last-token logits within LOGITS_ATOL, layer 0's K/V bit for
              bit, each route's SOCKET bits its own keys' signs outside
              |proj| ~ 0 (so equal where the keys are); the times and
              peak memory of both are logged.  Then layer by layer, each
              layer's kernel and plain op fed the kernel route's q/k/v:
              every layer's K/V within PREFILL_TOL (atol 1e-5); every
              layer's attention output, held to the plain version in
              float64, within ATTN_TOL of it or, where the plain op itself
              is farther, no farther than the plain op (both in ATTN_TOL
              units), and its largest |error| within F64_RATIO of the
              plain op's; the kernel's distance from the plain op is
              logged.  A wrong head order and a mask one key too wide,
              through the plain op, must fail that gate on every layer.
              Decode step 0 is run again
              on a clone of the prefilled cache through the plain versions;
              its logits must agree with the kernel path's, and the greedy
              tokens of the two paths are compared.  Where the plain
              route's SOCKET top-k differs from the kernel route's only at
              rows whose effective scores lie within SCORE_TOL of the
              threshold, it takes the kernel route's selection there
              (``static_ties_shared``; the split tables move scores a few
              ulps) and the swapped rows are logged; a difference outside
              the band fails.
5. continuous — llama31-8b at full width on its first ``QUANT_DEPTH``
              (8) of 32 layers (the script's time limit: phase 5f runs
              ``socket_fused`` at full depth, at bf16), the same
              weights, through ``ContinuousBatchingEngine.warmup()`` and
              ``run(realtime=False)``, once with each fused backend
              (``socket_fused``, ``hard_lsh_fused``, ``quest_fused``): 8
              requests (prompts of 1024/2048/3072/4096 tokens from --seed,
              each twice), 32 greedy tokens each, chunked prefill of 512,
              a pool that never preempts.  Every request must finish with
              32 tokens; the backend's paged kernel must launch exactly
              layers x (engine iterations + the 2 warm-up steps) times,
              and no other kernel at all (``flash_prefill`` 0 times: chunks
              attend over the pool).  One decode iteration of the
              engine's state (the widest batch the run held, on a clone of
              the pool) is run again through the kernel and through the
              plain paged path; their logits must agree.  Where the
              plain path's SOCKET selection differs from the kernel's only
              at rows whose effective scores lie within SCORE_TOL of the
              top-k threshold (the kernel check's band: the two sum the
              same fp32 terms in another order), the plain path takes the
              kernel's selection there, and the swapped rows are logged;
              a difference outside the band fails.  Each run's pool
              and snapshot are freed before the next.  Each backend then
              runs again, the same traffic and depth, on int8 and on fp8
              K/V pages (``serving.kv_dtype``; gemma-7b's phase 5d runs
              quantized pages at GEMMA7B_DEPTH), with the same gates; the
              K/V bytes a block id holds are logged.
5a. prefix — the prefix cache on the same weights, at ``QUANT_DEPTH``
              layers (the script's time limit): 8 requests of
              ``rag_prompts`` (``launch/serve.py::card_prefix_case``),
              prompts of 3072 tokens sharing a 2300-token template (not a
              multiple of the 16-token page), chunks of 512, 16 greedy
              tokens, a pool that never preempts; ``socket_fused`` and
              ``quest_fused`` on f32 pages and ``socket_fused`` on int8
              pages, each cold (cache off) and then warm (cache on: the
              template served alone first, so its partial tail page is
              indexed, then the 8 requests).  Every request must finish;
              the warm tokens must equal the cold ones token for token;
              the warm run must hit >= 7 times with >= 7 x 2300 cached
              tokens (Quest: page-aligned, 7 x 2288); SOCKET must clone a
              page (its hits share the template's tail page) and Quest
              must not; each run's paged kernel must launch exactly
              layers x (engine iterations + warm-up steps) and no other
              kernel at all; every page shared at an iteration's end must
              be bitwise equal, in every leaf, to its copy taken when it
              was first seen shared (``SharedPagesFrozen``); each clone
              must leave every leaf's rows past ``keep`` at the leaf's
              fill and the rows before it the source's (int8: the clones
              must reach ``k_scale`` and ``v_scale``).  The chunks saved,
              cold and warm TTFT and each clone's host ms are logged.
5b. sampling — at ``QUANT_DEPTH`` layers (the script's time limit),
              the 8 requests of phase 5 through ``socket_fused`` at
              temperature 0.8, top-p 0.95, sample seed --seed, 32 tokens,
              twice: the tokens must be identical and every id inside the
              vocabulary; then on the pool ``CARD_PREEMPT_BLOCKS`` names
              (840 blocks), which must preempt, and every emitted token's
              draw index must equal the index it had in the first run.
              How far the preempting run's tokens agree with the first
              run's is logged (a number: another batch composition
              reorders the device's sums, which can flip a near-tied draw).
              The paged SOCKET kernel's launch count is gated as in 5a.
5c. observability — phase 5's traffic and depth (8 requests, 32 greedy
              tokens, f32 pages, ``QUANT_DEPTH`` layers) through
              ``socket_fused`` with the serving observability
              on (``Observability``: the JSONL event trace, the selection
              probe every 8 iterations, a 4-iteration ``torch.profiler``
              window from the first decode-only iteration, logged).  The
              tokens must equal phase 5's ``socket_fused`` tokens bit for
              bit; the trace file must validate and equal the tracer's
              events, every request carry submit/admit/first_token/finish
              and the step events number 0..iterations-1; every probed
              iteration must have a row for each layer, each
              with recall in [0, 1], 0 < budget utilization <= 1 and 0 <
              selected <= budget <= static k; the paged SOCKET kernel must
              launch exactly layers x (iterations + warm-up steps) and no
              other kernel at all (the probe's shadow steps take the plain
              route); the window's Chrome trace must hold the kernel as
              device kernel events exactly layers x the window's iterations
              times, the launch counter's change over the window; the pool
              must be empty at the end.  Then ``hard_lsh_fused`` and
              ``quest_fused`` with the probe alone: their tokens must equal
              their phase-5 f32 tokens (the Quest run is the one where a
              shadow step leaking into the page bounds would show), the
              rows pass the same checks, the launches the same gate.  Mean
              recall, budget utilization and forced share per backend
              (random fp32 weights), the probe's host ms, the traced run's
              wall against phase 5's and the trace's size are logged.
5d. all-global — after llama31-8b's weights are freed (and its legacy
              run, phase 7, is done), gemma-7b (MHA: 16 KV heads, G 1, hd
              256, geglu, vocab 256000; 9.32 B parameters) at full width
              and depth through the static path of phase 4 with its gates
              (``STATIC_CASES``: batch 2, a 4096-token prompt, 16 greedy
              steps; at G 1 the wrong head order the prefill gate must
              catch reads the next head's K/V); then through the
              continuous engine with phase 5's traffic and gates at its
              first GEMMA7B_DEPTH (7) of 28 layers (the script's time
              limit) (``socket_fused``, ``hard_lsh_fused`` and
              ``quest_fused`` on f32 pages; then ``socket_fused`` on
              bf16, int8 and fp8 pages; 1536 blocks each); the resident
              requests
              each page dtype fits in the bf16 pool's byte budget are
              logged and int8 must hold ``RESIDENCY_BAR`` (1.8) x bf16's;
              each run's greedy tokens' agreement with the bf16 run is
              logged (a number).  Then minitron-8b (9.88 B parameters) at
              full width and depth, ``socket_fused`` on f32 pages.  Every
              continuous run (of every phase) also holds the bytes a block
              id takes in the engine's pool to
              ``serving.paged.pool_block_bytes``, and its kernel-vs-plain
              check copies only the blocks the captured batch reads
              (``compact_pool``: gemma-7b's full-depth f32 pool, 23.5 GB,
              and a clone of it do not fit beside its 37.3 GB of
              weights).
              Seconds and peak memory are logged per run.
5e. state and MoE — after gemma-7b's and minitron-8b's weights are freed:
              jamba-v0.1-52b (d_model 4096, 32/8 heads, 16 experts top-2
              of d_ff 14336, Mamba-2 with d_state 16) at full width on 1
              of its 4 groups (8 layers: 1 attention, 7 Mamba, 4 MoE;
              13.27 B parameters, 53.1 GB) through phase 4's static path
              and gates (batch 2, prompt 4096, 16 steps; the attention
              kernels counted on its one attention layer), then through
              the engine with phase 5's traffic and gates
              (``socket_fused``: the paged SOCKET kernel 1 x decode
              calls; the captured decode iteration's snapshot holds the
              Mamba layers' state rows, which the step moves in place).
              Where the kernel and plain routes' MoE routers send a token
              to other experts only inside ``ROUTE_TOL`` of a tie, the
              plain route takes the kernel route's experts
              (``moe_routes_shared``), as SOCKET's band swaps.  Then
              mamba2-780m at full width and depth (48 Mamba layers) with
              phase 5's traffic: every request finishes, the pool holds 0
              blocks at every iteration, no kernel runs, and each
              request's last-step logits lie within ``STATE_CARRY_ATOL``
              of a whole-sequence prefill of its prompt and generated
              tokens (the state carried across 512-token chunks and 31
              recurrent steps against one chunked SSD).  Then
              mixtral-8x22b at full width on 4 of its 56 layers (10.42 B,
              41.7 GB): prompts of 2048/4096/6144/8192 tokens each twice,
              ``socket_fused`` with ``use_ring_kernel``: ``paged_ring``
              exactly 4 x decode calls, the SOCKET kernel 0; the 6144- and
              8192-token prompts' chunks run past the 4096-token ring
              (``ring_wrap_check``); the ring logits check of phase 6.
              Each run's seconds and peak memory are logged.
              ``--only state-moe`` builds the kernels and runs this phase
              alone (no kernels or ok line).
5f. bf16    — after phase 5e, the deployment numerics of
              ``launch/specs.py``'s ``dryrun_model_config`` for a 32K
              decode (bf16 weights and compute, bf16 SOCKET scores in
              chunks of 16384, prefill attention in query chunks of 1024).
              Kernels first: the four paged kernels with a bf16 query on
              bf16 pages (the main case, gemma-7b's hd 256 / G 1 and
              llama4's G 5; the ring on its main case and hd 256 / G 1)
              against their plain versions at the float32 tolerances,
              SOCKET's and hard LSH's selections equal to their own on
              the float32 query, each timed at the main and gemma-7b
              shapes; ``flash_decode`` and ``flash_prefill`` on bf16
              q/k/v (and at llama4's G 5) against their plain versions,
              timed beside SDPA on the same bf16 inputs (its flash
              backend allowed); bounds at the bf16 tensor rate (entry
              ``bf16`` of each kernel's row).  Then llama31-8b at full
              width and depth (8.03 B, 16.1 GB) through phase 4's static
              path and launch gates and the engine with ``socket_fused``
              and, at ``QUANT_DEPTH`` layers (the script's time limit),
              ``hard_lsh_fused`` and ``quest_fused`` (phase 5's traffic,
              bf16 pages), and llama4-maverick-400b-a17b at full width on
              1 of its 24 groups (a dense and an MoE layer of 128 experts:
              18.43 B, 36.9 GB) through the static path (jamba's case)
              and ``socket_fused``; the MoE decode step's expert bytes are
              logged beside its time.  The two routes round to bf16
              between layers in other places, so where phases 4 and 5
              hold the kernel route's logits to the plain route's within
              LOGITS_ATOL, phase 5f holds both to a float32 run of the
              same weights through the plain versions: the kernel route
              no farther from it than F64_RATIO x the plain route
              (``f32_distance_check``; the plain route scores SOCKET from
              float32 u, as the kernels do; its selections and MoE routes
              are not paired).  The layer-by-layer prefill gate runs as
              in phase 4, both ops fed the same bf16 q/k/v; SOCKET bits
              are compared on the layers whose keys the free-running
              routes share.  Greedy tokens against the plain and float32
              routes are logged.  ``--only bf16`` builds the kernels and
              runs this phase alone.
6. gemma3-continuous — after the all-global phase, gemma3-27b
              at full width (d_model 5376, 32/16 heads, d_ff 21504, vocab
              262144, window 1024) with its depth cut to 2 groups: 14 of
              its 62 layers, 12 local and 2 global (all 62 do not fit the
              card in fp32), through the same engine entry points with
              ``socket_fused`` and ``use_ring_kernel``: 8 requests (prompts
              of 2048/3072/4096/6144 tokens from --seed, each twice), 32
              greedy tokens each, a 2048-block pool that never preempts.
              ``paged_ring`` must launch exactly 12 x decode calls, the
              paged SOCKET kernel 2 x decode calls, no other kernel at all;
              one decode iteration runs again through the plain routes
              (ring and global), and the logits must agree.  Then again on
              int8 and on fp8 pages, both kernels in that mode.
7. legacy   — the continuous engine's legacy whole-prompt bucketed prefill
              (``prefill_chunk`` 0), f32 pages, ``socket_fused``: llama31-8b
              (after phase 5, the same weights, depth and the 8 requests
              of its case) and gemma3-27b (after phase 6, 14 layers, the ring
              kernel), both in buckets of 2048, 4096 and max_context (4224,
              6272), so half the prompts run padded (llama31-8b's 1024 and
              3072, gemma3's 3072 and 6144) and are read at their last real
              token; each prefill's padded share is logged.
              ``engine.warmup(requests)`` prefills each bucket the prompts
              hit once.  ``flash_prefill``
              must launch layers x (prefills + warm-up buckets) times, the
              paged kernels layers x (engine iterations + the 1 warm-up
              decode step); the decode-iteration logits check of phase 5;
              wall, TTFT, tokens/s and the greedy tokens' agreement with the
              chunked run of the same case (a number, not a gate) logged.
8. train    — after phase 7, the training path (``loss_and_metrics``,
              ``make_train_step``, ``Trainer``, ``launch.train``), every
              attention layer's causal attention through ``flash_prefill``
              (its autograd function: the CUDA kernel forward, the plain
              version's gradient in query chunks backward).  8a:
              llama31-8b at full width on 2 of its 32 layers (1.49 B
              parameters, f32), one batch of 1 x 4096 tokens from
              ``SyntheticLMSource``, forward and backward through the
              kernel (``flash_prefill`` launched once a layer, no other
              kernel) and through the plain op (no kernel): every
              attention weight's gradient present and not all zero on the
              kernel route, the losses within TRAIN_LOSS_RTOL and every
              gradient leaf within TRAIN_GRAD_RTOL (relative L2) of the
              plain route's (``grad_gate``).  8b: the same weights through
              ``make_train_step`` at ``accum`` 2 (batches of 2 x 4096)
              with 32-bit AdamW moments, 3 steps: launches layers x 2 x 3,
              every loss, gradient norm and parameter finite, every
              trainable leaf moved, the hash planes not, the step counter
              3 (``train_step_gate``).  8c: llama31-8b at full width and
              depth at ``dryrun_model_config(..., SHAPES["train_4k"])``
              (bf16 weights and compute, ``remat_policy="full"``) with
              8-bit moments, 3 steps of 1 x 4096 tokens: launches layers x
              2 (the forward and its recomputation) x 3 and the gates of
              8b; step time, tokens/s, model FLOPs/s (the JAX package's
              ``model_flops_per_token``) over the bf16 peak and peak
              memory logged, then one more step timed part by part
              (``train_breakdown``).  8d: minitron-8b's smoke config (the
              JAX package's runtime tests' config) through ``Trainer`` on
              the card, uninterrupted and with a failure injected at step
              7 (checkpoints every 5 steps, in a temporary directory):
              the resumed run's losses, parameters and moments equal the
              uninterrupted run's bit for bit (``trainer_resume_check``);
              then ``python -m repro_torch.launch.train --smoke`` once as
              a subprocess.  ``--only train`` builds the kernels and runs
              this phase alone.
9. context-parallel — SOCKET decode with the cache's sequence axis over
              4 ranks (``distributed/context_parallel.py``; one process a
              rank started by ``launch.mesh.spawn_ranks``; NCCL, one rank
              a card, where 4 cards are present, else gloo with every
              rank on ``cuda:0`` and the collectives of CUDA tensors
              card to card through the ranks' CUDA IPC mailboxes; the
              backend, world, card count and
              each rank's peak memory logged).  9a: the attention layer
              at ``long_500k`` (llama31-8b's B 1, KVH 8, G 4, hd 128 at
              N 524288; P 10, L 60, tau 0.4, sparsity 10, sink and window
              128; N(0, 1) keys, of which graded warm keys, 14 % of
              shard 0's rows down to 6 % of shard 3's, carry most of the
              attention mass, so shard 0 holds 1.4 x k_local of them),
              4 ranks of 131072 rows on a ``("data",)`` mesh
              (kvhead and pooled selection, the whole cache valid), then
              a 2x2 mesh with both axes as CP axes and a length that
              leaves the last shard without a valid row: ``socket_score``
              launched once on every rank; each rank's selection equal
              to the plain version's for its shard, outside the
              SCORE_TOL band (``cp_selection_gate``); each shard's
              partials finite and an empty shard's merge weight 0
              (``cp_partials_check``); every rank's merged output within
              ATTN_TOL of ``context_parallel_socket_attend_ref`` and at
              most CP_GLOBAL_REL (0.08) from the global route, where
              dense attention must lie at least CP_GLOBAL_REL from it
              (the inputs test the bound), both distances logged
              (``cp_merge_gate``); a
              rank's step, its merge and the global route in one
              process timed (the four ranks sharing one card measure no
              scaling).  9b: llama31-8b at full width, 4 of 32 layers,
              f32, one 32768-token prompt from ``--seed``, 16 greedy
              steps, 32800 cache rows over 4 ranks of 8200 (the new
              tokens land on the last): each rank's ``prefill`` (in
              turn: four prefills' activations at once do not fit beside
              four ranks' weights on one card) and ``decode_step`` under
              ``activate_mesh``; ``socket_score``
              launched layers x steps and ``flash_prefill`` layers times
              a rank, no other kernel (``cp_launch_gate``); the greedy
              tokens equal, and every step's logits within LOGITS_ATOL,
              of one process holding the whole cache on a 1x1 mesh, its
              CP attend replaced by ``context_parallel_socket_attend_ref``
              over 4 shards (``cp_logits_gate``; that reference scores
              through the same ``socket_score``, so 9b holds the sharding
              mechanics, the rank-local caches, owned writes and the
              merge, and 9a holds the kernel against its plain version);
              the distance to the non-CP route
              logged, not gated (a union of local top-ks differs from a
              global top-k by design).  9c, in 9b's spawn on its weights
              and prompt: the ``dense``, ``hard_lsh`` and ``quest``
              backends in turn (their CP routes: a global selection from
              the ranks' gathered values, each rank attending the
              selected rows it holds through ``flash_decode`` with its
              softmax partials, the partials merged; dense by plain
              partials), 8 greedy steps each at 32832 cache rows over 4
              ranks of 8208 (whole Quest pages of 16): ``flash_decode``
              launched layers x steps a rank for hard LSH and Quest and
              not at all for dense, ``flash_prefill`` layers a rank, no
              other kernel; the greedy tokens equal, and every step's
              logits within LOGITS_ATOL, of one process holding the
              whole cache on the global route (the route is meant to
              equal it); layer 0's selection at every step equal to that
              process's bit for bit (``cpb_selection_gate``); each
              rank's Quest bounds after decode its block of that
              process's (``cpb_bounds_gate``: bitwise, but within
              CPB_BOUNDS_TOL on the pages the steps wrote past layer 0);
              a rank's step ms and the share of its gathers and merges
              in it (collectives timed) and the bytes it posted logged,
              not gated.  ``--only cp`` builds the kernels and runs this
              phase alone; ``--only cp-backends`` runs 9c alone (its own
              spawn, no ``ok`` line).
10. mesh-train — the sharded train step and the elastic Trainer over 4
              ranks (``distributed/fsdp.py``, ``launch/specs.py``'s
              shardings, ``runtime/train_loop.py``; ranks started as in
              phase 9: NCCL with a card a rank where 4 cards are present,
              else gloo with every rank on ``cuda:0``, the collectives
              of CUDA tensors card to card through the ranks' CUDA IPC
              mailboxes, each counted and logged; that layout
              is a test rig, and its collective share is the rig's).  The single-process references run first and are
              freed before the ranks start.  10a: llama31-8b at full
              width, 2 of 32 layers (as 8a), f32, ``remat_policy="full"``,
              a global batch of 4 x 1024 tokens from ``--seed`` with
              labels padded on row prefixes of different lengths (the
              ranks' valid-token counts differ), 2 steps, on mesh (4, 1)
              with 8-bit moments and on (2, 2) with f32 moments at accum
              2, one spawn for both: every rank's loss and gradient norm
              at each step within TRAIN_LOSS_RTOL / TRAIN_GRAD_RTOL of the
              single-process ``make_train_step`` on the same weights and
              batches (``mesh_metrics_gate``; peak lr 1e-3, as the CPU
              tests), each rank's parameter block of each leaf after 2
              steps no farther (L2) from the reference's than
              MESH_UPDATE_RTOL x the reference's own update of it
              (``mesh_params_gate``; the largest element logged), the
              8-bit case's moments within MESH_MOMENT_CODES codes at a
              block's top of the reference's (``mesh_code_report``),
              every parameter and moment block of
              its spec's shard shape, ``flash_prefill`` launched layers x
              microbatches x 2 x steps a rank and no other kernel.  10d
              (same spawn): ``compressed_psum`` over the 4 ranks of one
              llama31-8b layer's gradient shapes from the seed, 3 rounds:
              each rank's int8 payloads and scales equal
              ``compressed_psum_ref``'s, the means and error buffers
              within COMPRESSION_TOL, the error feedback carried
              (``compression_run``).  10b: llama31-8b at
              ``dryrun_model_config(..., SHAPES["train_4k"])`` (bf16,
              remat full), 8-bit moments, (4, 1), each rank's blocks
              drawn as the Trainer draws them (``fsdp.init_shards``: a
              unit of the model at a time), one 4096-token sequence
              a rank, 3 steps, 8 of 32 layers on one card (all 32 with a
              card a rank): step 0's loss finite and no farther from a
              float32 run of the same weights than F64_RATIO x the
              single-process bf16 forward's; step s, tokens/s, each
              rank's peak memory (beside 8c's 57.20 GB), and, from the
              last step run with the collectives timed, the step's share
              in gathers, reduce-scatters and all-reduces logged.  10c:
              the JAX package's elastic test's Trainer (minitron-8b
              smoke, one group, dense backend) over the 4 ranks, 12 steps,
              a checkpoint every 4, ``lose_device:2`` at step 6: one
              rebuild, ranks 0 and 1 on the new mesh reach step 12, their
              restored blocks equal their blocks of the step-4
              checkpoint bit for bit, ranks 2 and 3 leave and exit 0
              (``elastic_gate``).  ``--only mesh`` builds the kernels and
              runs this phase alone.
11. parallel — the parallel forms the port had refused, over 4 ranks
              started as in phase 10 (one card: gloo, every collective
              card to card through the mailboxes; the rig's times).
              11a (``--only ep``), expert parallelism: mixtral-8x22b at
              full width (d 6144, 8 experts of d_ff 16384, ``tp``
              storage) with ``moe_dispatch="alltoall"`` on a (2, 2)
              mesh.  f32 parity, 1 of 56 layers, 4 x 128 tokens, 2
              steps, 8-bit moments, capacity factor 2 (dropless at
              model 2): loss and gradient norm within TRAIN_LOSS_RTOL /
              TRAIN_GRAD_RTOL and each rank's blocks within
              MESH_UPDATE_RTOL of one process whose MoE layers run the
              plain exchange (``plain_exchange``:
              ``apply_moe_alltoall_ref``, the aux losses averaged over
              the ranks' token blocks as JAX's ``pmean``); each rank
              stores a quarter of every expert leaf and gathers only its
              4 experts (``expert_bytes_gate``, from the spied gathers'
              shapes); ``flash_prefill`` layers x 2 x steps.  The drops
              case: one MoE layer at capacity factor 1.0 on 2 x 512
              tokens through the exchange (serving's layout, every rank
              the whole batch): the ranks' drops the plain exchange's,
              which drops some, and outputs within EP_DROP_REL of it
              (``ep_drop_gate``).  bf16 timed (``SHAPES["train_4k"]``,
              remat full, 8-bit moments, 2 of 56 layers, 4096 tokens a
              data rank, 3 steps): losses finite and equal on every
              rank; step s, tokens/s, peak GB a rank and, from the last
              step run with the collectives timed, the all-to-alls'
              seconds logged.  11b (``--only pipe``), the GPipe pipeline
              (``distributed/pipeline.py``): llama31-8b's blocks as 4
              stages, 8 microbatches of one row.  f32 parity, 2 layers a
              stage, 512 tokens: the output and the gradients of the
              input and of each stage's leaves within PIPE_OUT_REL /
              PIPE_GRAD_REL (relative L2) of the sequential stack in one
              process (``pipe_parity_gates``); each stage holds only its
              layers.  bf16 timed at full depth (8 layers a stage, 4096
              tokens a row, forward, 3 runs): outputs finite and equal
              on every stage, each stage's ``stage_fn`` run once a
              microbatch, the measured bubble (1 - a stage's busy s over
              the forward's wall) logged beside (stages - 1) / (micro +
              stages - 1).  11c (``--only cp-hybrid``), context-parallel
              decode of hybrid SOCKET models (``decode_cp_axes``, every
              rank the whole prefill, the ranks in turn): gemma3-27b 1
              group (local and global layers) on 4 ranks and
              jamba-v0.1-52b 1 of 4 groups (attention, Mamba, MoE) on 2,
              both at bf16 with weights replicated per rank, a
              CP_PROMPT-token prompt and CP_STEPS greedy steps: tokens
              equal and logits within LOGITS_ATOL of one process whose
              CP attend is the plain version over as many shards
              (``cp_logits_gate``); each rank's prefill caches its block
              of the global layers' and the whole rings and Mamba
              states, bitwise the one process's (``cph_layout_gate``);
              ``socket_score`` global layers x steps and
              ``flash_prefill`` attention layers a rank, no other
              kernel (``cph_launch_gate``).  The default run takes 11a,
              11b and 11c after phase 10.
12. frontends — (``--only frontends`` runs it alone, no ``ok`` line)
              the embeddings-input models through the static path on
              Gaussian frame/patch embeddings drawn from the seed, and
              the paper's baselines.  12a musicgen-medium at full width
              (MHA, hd 64, G 1), f32, batch 4 x 1500 frames, 16 steps:
              all 48 layers through ``phase_main`` (launch counts,
              every layer's attention layer by layer, the routes'
              logits distances logged), then the first
              FRONTEND_GATE_DEPTH layers with its every gate (logits
              within LOGITS_ATOL).  12b internvl2-26b at bf16: all 48
              layers (38.6 GB) through the kernel route and the plain
              route (``frontend_full_depth``: prefill s, decode step ms,
              peak memory, launches gated, the routes' distance logged),
              then ``phase_main``'s bf16 gates at FRONTEND_GATE_DEPTH
              layers.  12c (``phase_baselines``) the oracle, hard LSH,
              HashAttention, MagicPig, PQCache and SOCKET's
              paper-literal form at one llama31-8b attention layer of
              32768 keys (BASELINE_SHAPE), each held to the same
              function on the CPU fed the same inputs (the first KV
              head's slice), ``socket_score`` to
              ``soft_scores_gather(bucket_probs_explicit)``; recall of
              the oracle's top 10 %, bits a token and index build
              seconds logged.  Its kernel cases (musicgen's
              ``flash_decode`` and ``flash_prefill`` at hd 64 / G 1, and
              ``socket_score`` at BH 96 / N 1516 / G 1) run in phase 3,
              timed into entry ``musicgen``.
13. dryrun  — (``--only dryrun`` runs it alone, no ``ok`` line) 13a: rank
              0 of three production cells at ``decode_32k`` on the 16 x
              16 mesh (``DRYRUN_CELLS``: llama31-8b ``base``, whose
              cache splits over the sequence and is gathered before a
              layer attends, and ``opt``, the context-parallel route;
              gemma-7b ``base``, its cache split over the heads): each
              cell's dry run on fake tensors (``launch/dryrun.py``;
              in the full run made while the kernels build), then the
              same step for real on the card through the
              collectives' dry-run route, rank 0's parameter and cache
              blocks drawn from the seed (8 of the 128 sequences): the
              real run's FLOPs, kernel calls and collective bytes equal
              the fake run's, its peak lies within DRYRUN_PEAK_REL of
              ``hbm_per_device_gb``, DRYRUN_WARM warm and DRYRUN_TIMED
              timed steps (CUDA events) each no faster than its floor
              allows (DRYRUN_FLOOR_SHARE), the logits finite,
              ``socket_score`` (and on ``base`` ``flash_decode``)
              launched layers x steps; the roofline terms, step ms,
              shares of the floor and of the memory term, the gathers'
              seconds and each ``trace_s`` logged.  13b: each kernel
              operator's host microseconds a call, through the
              dispatcher and straight to the launch.

The last line of output is ``{"ok": true, "device": {...}}``; the line before
it lists every kernel's numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Tuple
from unittest import mock

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

from repro_torch.roofline import HW  # noqa: E402

# the H100 SXM data sheet's rates (``repro_torch.roofline.HW``)
HBM_BYTES_PER_S = HW["hbm_bw"]
FP32_FLOP_PER_S = HW["fp32_flops"]     # fp32 outside the tensor cores
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)    # fp32, another summation order
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)     # fp32 online vs two-pass softmax
# End-to-end step-0 logits, kernel path vs plain path: fp32 through 32
# layers with other summation orders in the two kernels.  Measured 4.5e-6
# on an H100 (|logits| <= 9.3, seed 0); the limit leaves 20x headroom, well
# below the ~1e-2 that one dropped or swapped top-k row moves them.
LOGITS_ATOL = 1e-4
# The prefill kernel against its plain version on N(0, 1) cases: the
# harness's f32 tolerance, for bf16 inputs too (both sides read the same
# bf16 values and compute in f32).  The main phase holds every layer's
# K/V to it layer by layer, both routes fed the kernel route's input to
# the layer (free-running, the routes' float32 differences compound with
# depth: K/V up to 1.8e-5 apart in deep layers, logged, not gated).  The
# layer's attention output is held to the plain version computed in
# float64: the model's scores are far larger than N(0, 1) ones, and
# there the f32 plain op is itself 1.55 to 2.97 x ATTN_TOL from float64
# (llama31-8b, seed 0, an H100), so a kernel that sums its products in
# another order (on the tensor cores, say) cannot come within ATTN_TOL
# of it (3.3 x measured).  So the kernel must come within ATTN_TOL of
# the float64 version or, where the plain op is farther than that, no
# farther than the plain op (measured at most 0.64 of that limit); and
# its largest |error| from the float64 version within F64_RATIO of the
# plain op's (0.49 x).  A wrong head order or mask reads above 1e5 x
# the limit.
PREFILL_TOL = dict(rtol=0.0, atol=1e-5)
F64_RATIO = 2.0
# SDPA on bf16 inputs returns bf16 (and its flash backend rounds the
# softmax weights to bf16 before P.V): its output against the float32
# plain version, checked before it is timed, within two bf16 ulps of the
# value and 2**-8 absolute (a wrong mask or head order is off by ~0.1)
BF16_SDPA_TOL = dict(rtol=2 ** -6, atol=2 ** -8)
# dense tensor-core rates (the prefill kernel's 3xTF32 products run at
# TF32's)
TF32_FLOP_PER_S = HW["tf32_flops"]
BF16_FLOP_PER_S = HW["peak_flops"]
# the stored K/V page modes the paged kernels are checked in besides f32
# (serving.kv_dtype); int8 and fp8 also get timed entries and main-path
# runs
QUANT_KV_DTYPES = ("bf16", "int8", "fp8")
# llama31-8b's continuous runs at fp32 (phase 5 on f32, int8 and fp8
# pages, the prefix and sampling phases, and the observability and legacy
# runs read against phase 5) and its bf16 hard LSH and Quest runs (phase
# 5f) take its first 8 of 32 layers: with gemma-7b's phase (5d, on bf16,
# int8 and fp8 pages too), phase 5f's socket_fused at full depth and the
# training, context-parallel, mesh and parallel phases (8 to 11) the
# script must stay well inside its time limit on a slow host
QUANT_DEPTH = 8
TIMED_ITERS = 50
GRAPH_REPLAYS = 4
L2_BYTES = 50 * 2 ** 20


def log(*parts) -> None:
    print(*parts, flush=True)


def device_time_ms(fn, input_sets, iters=TIMED_ITERS,
                   replays=GRAPH_REPLAYS) -> float:
    """Device milliseconds of one ``fn(*inputs)``.  ``iters`` calls,
    cycling through ``input_sets`` (sized together past the L2 cache, so
    every call reads its inputs from device memory), are captured in one
    CUDA graph; its ``replays`` are timed with CUDA events, which leaves
    the host's launch cost out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up before capture
        for inputs in input_sets[:3]:
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def back_to_back_ms(fn, input_sets, iters=TIMED_ITERS) -> float:
    """Milliseconds per call of ``iters`` calls launched one after the
    other from Python (CUDA events): the host's launch rate wherever it
    exceeds the device time."""
    for inputs in input_sets[:3]:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*input_sets[i % len(input_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotations(bytes_per_set: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, tol) -> float:
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out.double() - ref.double()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.double().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} exceeds atol "
            f"{tol['atol']} + rtol {tol['rtol']} * |ref|")
    return float(err.max().item())


# ------------------------------------------------------------ phase 2+3

def socket_score_case(dev, gen, *, bh, n, g, l, p, int8, vnorm):
    from repro_torch.core import hashing, socket as sk
    if int8:
        bits = (torch.randint(0, 2, (bh, n, l * p), generator=gen,
                              device=dev, dtype=torch.int8) * 2 - 1)
    else:
        w = hashing.num_words(l, p)
        bits = torch.randint(-2 ** 31, 2 ** 31, (bh, n, w), generator=gen,
                             device=dev, dtype=torch.int32)
    hd = 128
    planes = torch.randn((l, p, hd), generator=gen, device=dev)
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    u = sk.soft_hash_query(planes, q)                     # (BH, G, L, P)
    vn = (torch.rand((bh, n), generator=gen, device=dev) * 4
          if vnorm else None)
    return bits, u, vn


def score_plan_note(ss, label, bits, kw) -> str:
    """The launch plan of a socket_score case, as a log note; raises where
    the case does not exercise what its label names."""
    pl = ss.socket_score_plan(bits, kw["g"], num_tables=kw["l"],
                              num_planes=kw["p"])
    wants = {"main path": pl["C"] > 1 and pl["resident"],
             "BH=256 N=513": pl["C"] == 1 and
             kw["bh"] > pl["clusters_at_once"],
             "P=20 sign-add": pl["instance"] == "sign-add",
             "chunked tables P=16": pl["instance"] == "split" and
             not pl["resident"],
             "chunked sign-add P=24 L=600": pl["instance"] == "sign-add" and
             not pl["resident"]}
    if not wants.get(label, True):
        raise AssertionError(f"socket_score[{label}]: plan {pl} does not "
                             "exercise the case")
    return (f"C {pl['C']}, {pl['clusters_at_once']} clusters at once, "
            f"{pl['smem']} B a CTA, {pl['instance']} instance, tiles of "
            f"<= {pl['tile']} keys, " +
            ("tables resident" if pl["resident"] else
             f"tables in chunks of {pl['tables_a_chunk']}"))


def equal_rows(ss, bits, u, args):
    """A copy of ``bits`` whose keys ``at`` (the first key of every rank's
    run and a key of its second tile) hold key at[0]'s bits; returns
    (bits, at, the cluster size C, the rows a tile)."""
    g = u.shape[1]
    c = ss.socket_score_plan(bits, g, num_tables=args["num_tables"],
                             num_planes=args["num_planes"])["C"]
    rows, runs = ss.key_runs(bits.shape[1], c)
    at = [r0 + k for r0, r1 in runs for k in (0, rows + 3) if r0 + k < r1]
    bits = bits.clone()
    bits[:, at] = bits[:, at[:1]]
    return bits, at, c, rows


def equal_rows_check(ss, bits, u, args) -> None:
    """Keys given equal bits on every rank of the cluster (and in two
    tiles of a rank) must score bit for bit the same.  Where they do not,
    :func:`equal_rows_report` logs what the failure shows before it
    raises."""
    bits, at, c, rows = equal_rows(ss, bits, u, args)
    out = ss.launch_socket_score(bits, u, None, **args)
    if out.is_cuda:
        torch.cuda.synchronize()
    fmt = str(bits.dtype)[6:]
    if not torch.equal(out[:, at], out[:, at[:1]].expand(-1, len(at))):
        for line in equal_rows_report(ss, bits, u, args, at, out):
            log(f"  socket_score ({fmt}) equal rows: {line}")
        raise AssertionError(f"socket_score ({fmt}): keys with equal bits "
                             "on different ranks score differently")
    log(f"socket_score ({fmt}): equal bit rows at keys {at} (C {c}, tiles "
        f"of {rows}) score bit-equal")


EQUAL_ROWS_RELAUNCHES = 200


def _unequal(out, at):
    """|score of key at[j] - score of key at[0]| (BH, len(at))."""
    return (out[:, at] - out[:, at[:1]]).abs()


def equal_rows_report(ss, bits, u, args, at, out) -> list:
    """What a failed equal-bits check shows, as log lines: in the failing
    launch ``out``, which (bh, key, rank) scores differ from key at[0]'s
    and by how much; over ``EQUAL_ROWS_RELAUNCHES`` launches of the same
    inputs, how many differ from the first bit for bit (and where, by
    rank), and how many break the equal rows again; each rank's split
    tables as it held them (the diagnostic build, ``ops.table_dump``)
    against rank 0's copy bit for bit, against the owner's, and against
    the plain version's ``exp`` tables (``ref.split_tables``); the card as
    ``nvidia-smi --query-gpu=uuid,name,power.limit`` names it."""
    from repro_torch.kernels.socket_score.ref import split_tables
    g, l, p = u.shape[1], args["num_tables"], args["num_planes"]
    plan = ss.socket_score_plan(bits, g, num_tables=l, num_planes=p)
    c = plan["C"]
    per = -(-bits.shape[1] // c)
    lines = []
    d = _unequal(out, at)
    bad = d.nonzero().tolist()
    lines.append(f"failing launch: {len(bad)} (bh, key) of {d.numel()} "
                 f"differ from key {at[0]} (rank 0): " + ", ".join(
                     f"bh {b} key {at[j]} rank {at[j] // per} "
                     f"|diff| {d[b, j].item():.3e}" for b, j in bad[:16]))
    outs = [ss.launch_socket_score(bits, u, None, **args)
            for _ in range(EQUAL_ROWS_RELAUNCHES)]
    if bits.is_cuda:
        torch.cuda.synchronize()
    first = outs[0]
    differ = [o for o in outs if not torch.equal(o, first)]
    broken = sum(bool((_unequal(o, at) != 0).any()) for o in outs)
    lines.append(f"{EQUAL_ROWS_RELAUNCHES} relaunches: {len(differ)} differ "
                 f"from the first bit for bit, {broken} break the equal "
                 f"rows, {sum(not torch.equal(o, out) for o in outs)} "
                 "differ from the failing launch")
    if differ:
        where = torch.stack([(o != first) for o in differ]).any(0)
        keys = where.nonzero()
        ranks = sorted({int(k) // per for k in keys[:, 1].tolist()})
        worst = max((o - first).abs().max().item() for o in differ)
        lines.append(f"relaunches differ at {keys.shape[0]} (bh, key) on "
                     f"ranks {ranks}, by up to {worst:.3e}")
    if p <= 16 and plan["resident"]:
        scores, dump = ss.table_dump(bits, u, **args)
        if bits.is_cuda:
            torch.cuda.synchronize()
        t_lo, t_hi = ss.tables_of_dump(dump, g, p)  # (BH, C, G, L, 2^k)
        p_lo, p_hi = split_tables(u, args["tau"])   # (BH, G, L, 2^k)
        held = torch.cat([t_lo, t_hi], -1)
        plain = torch.cat([p_lo, p_hi], -1)
        owner = (torch.arange(l, device=u.device)[None, :] * g +
                 torch.arange(g, device=u.device)[:, None]) % c  # (G, L)
        own = held.gather(1, owner[None, None, :, :, None].expand(
            held.shape[0], 1, g, l, held.shape[-1])).squeeze(1)
        for r in range(c):
            same0 = torch.equal(held[:, r], held[:, 0])
            same_owner = torch.equal(held[:, r], own)
            rel = ((held[:, r] - plain).abs() /
                   plain.abs().clamp_min(1e-30)).max().item()
            lines.append(f"rank {r}'s tables: equal to rank 0's {same0}, to "
                         f"each set's owner's {same_owner}, max rel. "
                         f"difference from the plain exp tables {rel:.3e}")
        lines.append("the diagnostic build's scores equal the first "
                     f"relaunch's: {torch.equal(scores, first)}; its rows "
                     "unequal: "
                     f"{bool((_unequal(scores, at) != 0).any())}")
    try:
        smi = subprocess.run(["nvidia-smi",
                              "--query-gpu=uuid,name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        card = smi.stdout.strip() or smi.stderr.strip()
    except FileNotFoundError:
        card = "nvidia-smi not found"
    lines.append("card: " + card)
    return lines


def socket_score_row(ss, ref_fn, dev, gen, name, kw, args, bits, u, vn,
                     err) -> dict:
    """The timed entry of a socket_score case: kernel and plain version
    over inputs rotated past the L2 cache, beside the bound."""
    bh, n, g = kw["bh"], kw["n"], kw["g"]
    nbytes = bits.numel() * bits.element_size() + u.numel() * 4 + \
        bh * n * 4 * (2 if vn is not None else 1)
    # what the function needs, not what this kernel does: with P split
    # into two halves, each looked up in a per-(g, l) table of exp(.), a
    # (key, g, l) term is one FMA
    flops = bh * n * g * kw["l"] * 2
    sets = [socket_score_case(dev, gen, **kw)
            for _ in range(rotations(nbytes))]
    kernel = functools.partial(ss.launch_socket_score, **args)
    ms = device_time_ms(kernel, sets)
    plain_ms = device_time_ms(functools.partial(ref_fn, **args), sets)
    bms, by = bound(nbytes, flops)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/socket_score/socket_score.cu",
        replaces="src/repro/kernels/socket_score/socket_score.py:45",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        back_to_back_ms=back_to_back_ms(kernel, sets))


# the label of each kernel's case at gemma-7b's shapes (its static path's
# for socket_score, flash_decode and flash_prefill; its continuous
# lengths for the paged kernels), timed into entry ``gemma7b`` of the
# kernel's row; and of socket_score's, flash_decode's and flash_prefill's
# cases at musicgen-medium's static path (phase 12a: batch 4 x 24 heads
# of hd 64, MHA, a 1500-frame prompt and 16 steps), timed into entry
# ``musicgen``
GEMMA7B_TIMED = "gemma-7b hd 256, G 1"
MUSICGEN_TIMED = "musicgen hd 64, G 1"
CASE_ENTRIES = {GEMMA7B_TIMED: "gemma7b", MUSICGEN_TIMED: "musicgen"}


def case_entry(label, row) -> dict:
    """Entry ``gemma7b`` or ``musicgen`` of a kernel's row: the case, its
    error and its times beside its bound (the row's name, route and
    sources are the kernel's)."""
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "back_to_back_ms", "bound_f32_ms")
    log(f"{label} timed: kernel {row['ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), plain "
        f"{row['plain_ms']:.4f}")
    return dict(case=label, **{k: row[k] for k in keep if k in row})


def host_us(fn, input_sets, calls=TIMED_ITERS) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls issued one after
    the other with no synchronize between them (the host's cost to issue
    one, allocations included)."""
    for inputs in input_sets[:3]:
        fn(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*input_sets[i % len(input_sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# the SASS opcodes of asynchronous global-to-shared copies (cp.async, or
# TMA's bulk copies)
ASYNC_COPY_SASS = ("LDGSTS", "UTMALDG")


def sass_counts(lib, opcodes, name) -> dict:
    """How often each of ``opcodes`` appears in ``cuobjdump -sass`` of the
    library ``lib`` (all its kernels), logged; raises if the tool is
    missing."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"{tool} not found: the {name} SASS cannot be "
                           "checked")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = re.findall(r"\b(" + "|".join(opcodes) + r")\b", sass)
    counts = {op: ops.count(op) for op in opcodes}
    log(f"  {name} SASS (cuobjdump -sass, all instantiations): " +
        ", ".join(f"{op} {n}" for op, n in counts.items()))
    return counts


def build_report(source, name):
    """A library's build: ptxas's registers and spills (its build log,
    logged), and its SASS, which must hold asynchronous copies
    (``ASYNC_COPY_SASS``)."""
    from repro_torch.kernels import build
    lib = build.build_library(source)
    log_text = lib.with_suffix(".log").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         log_text)]
    log(f"  {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
        f"spill stores <= {max(spills)} B")
    counts = sass_counts(lib, ASYNC_COPY_SASS, name)
    if not any(counts.values()):
        raise AssertionError(f"{name} SASS has no asynchronous copies: "
                             f"{counts}")
    return counts, dict(registers=max(regs), spill_stores=max(spills))


def flash_decode_partials_check(label, fd, q, kk, vv, mask, scale, out,
                                kw):
    """The kernel's softmax partials (``partials=True``, the
    context-parallel ranks' merge input) against the plain version's on
    one case, within ATTN_TOL: the output of that launch equal to ``out``
    (the launch without them) bit for bit, and a fully masked row's m
    exactly -1e30 and l exactly 0.  Returns the m and l errors."""
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    got, ml = fd.launch_flash_decode(q, kk, vv, mask, scale=scale,
                                     partials=True)
    torch.cuda.synchronize()
    if not torch.equal(got, out):
        raise AssertionError(f"flash_decode[{label}]: the output with the "
                             "partials differs from the output without")
    _, m, l = flash_decode_ref(q, kk, vv, mask, scale=scale, partials=True)
    errs = (check_close(f"flash_decode[{label}] m", ml[..., 0], m, ATTN_TOL),
            check_close(f"flash_decode[{label}] l", ml[..., 1], l, ATTN_TOL))
    dead = kw.get("dead_row")
    if dead is not None and not (bool((ml[dead, :, 0] == -1e30).all()) and
                                 bool((ml[dead, :, 1] == 0).all())):
        raise AssertionError(f"flash_decode[{label}]: a fully masked row's "
                             f"partials {ml[dead].tolist()}, not (-1e30, 0)")
    return errs


def flash_decode_rows(dev, gen):
    """``flash_decode`` against its plain version on every case of
    ``cases.CARD_CASES`` (within ATTN_TOL; a fully masked row must return
    exactly 0; its softmax partials too, :func:`flash_decode_partials_check`),
    each logged with its launch plan and failing where the
    plan does not exercise its label; the main case timed beside its
    bound, the plain version, SDPA with a bool mask and the host's
    microseconds a call."""
    from repro_torch.kernels.flash_decode import cases, ops as fd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    sass, ptxas = build_report(fd.SOURCE, "flash_decode.cu")
    rows = {}
    for label, kw in cases.CARD_CASES:
        q, kk, vv, mask = cases.card_case(gen, **kw)
        scale = 1.0 / math.sqrt(kw["hd"])
        out = fd.launch_flash_decode(q, kk, vv, mask, scale=scale)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, kk, vv, mask, scale=scale)
        err = check_close(f"flash_decode[{label}]", out, ref, ATTN_TOL)
        if kw.get("dead_row") is not None and \
                out[kw["dead_row"]].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode[{label}]: a fully masked "
                                 "row must return 0")
        ml_err = flash_decode_partials_check(label, fd, q, kk, vv, mask,
                                             scale, out, kw)
        note = cases.plan_note(fd.flash_decode_plan(q, kk), label, **kw)
        log(f"flash_decode [{label}] BH={kw['bh']} K={kw['k']} G={kw['g']} "
            f"hd={kw['hd']} {str(kw['dtype'])[6:]}: max|err| {err:.3e} "
            f"(rtol {ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}); m/l "
            f"max|err| {ml_err[0]:.3e} / {ml_err[1]:.3e}; {note}")
        if label == "main path" or label in CASE_ENTRIES:
            bh, k, g, hd = kw["bh"], kw["k"], kw["g"], kw["hd"]
            sets = [cases.card_case(gen, **kw)
                    for _ in range(rotations(2 * bh * k * hd * 4))]
            # only the rows the mask keeps need reading and multiplying
            valid = sum(int(s[3].sum().item()) for s in sets) / len(sets)
            nbytes = 2 * bh * g * hd * 4 + 2 * valid * hd * 4 + bh * k
            flops = valid * g * (4 * hd + 4)
            kernel = functools.partial(fd.launch_flash_decode, scale=scale)
            ms = device_time_ms(kernel, sets)
            plain_ms = device_time_ms(
                functools.partial(flash_decode_ref, scale=scale), sets)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = device_time_ms(
                lambda a, b, c, m: sdpa(a[:, None], b[:, None], c[:, None],
                                        attn_mask=m[:, None, None, :],
                                        scale=scale), sets)
            bms, by = bound(nbytes, flops)
            if label in CASE_ENTRIES:
                # the main case's row comes first in CARD_CASES
                rows["flash_decode"][CASE_ENTRIES[label]] = case_entry(
                    label, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                back_to_back_ms=back_to_back_ms(kernel,
                                                                sets)))
                continue
            rows["flash_decode"] = dict(
                name="flash_decode", route="cuda",
                source="src/repro_torch/kernels/flash_decode/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode/flash_decode.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                library_call="scaled_dot_product_attention, bool mask",
                back_to_back_ms=back_to_back_ms(kernel, sets),
                host_us=host_us(kernel, sets), plan=note, sass=sass,
                ptxas=ptxas)
            log(f"flash_decode timed: kernel {ms:.4f} ms, bound {bms:.5f} "
                f"({by}), plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, host "
                f"{rows['flash_decode']['host_us']:.1f} us a call")
    return rows


# the sources the static path's kernels build from (phase 3's first
# part and phase 4 need these alone)
CONTIGUOUS_SOURCES = ("socket_score", "flash_decode", "flash_prefill")


def start_builds():
    """One nvcc per CUDA source, all started together, each in a thread of
    its own; returns (the start's clock, {source stem: future})."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    sources = (ss.SOURCE, fd.SOURCE, pa.SOURCE, pa.QUEST_SOURCE,
               pa.RING_SOURCE, fp.SOURCE)
    log(f"build {' + '.join(s.name for s in sources)}: started")
    ex = concurrent.futures.ThreadPoolExecutor(len(sources))
    futures = {s.stem: ex.submit(build.load_library, s) for s in sources}
    ex.shutdown(wait=False)
    return time.perf_counter(), futures


def wait_builds(builds, stems=None) -> None:
    """Wait for the builds of ``stems`` (every one left where None),
    raising where one failed; logs each one's time and ptxas report."""
    from repro_torch.kernels import build
    t0, futures = builds
    for stem in list(futures) if stems is None else stems:
        if stem not in futures:
            continue
        futures.pop(stem).result()
        secs, report = build.BUILD_LOGS.get(stem, (0.0, "built before"))
        log(f"  nvcc {stem}: {secs:.2f} s (ready "
            f"{time.perf_counter() - t0:.2f} s after the builds began)\n  "
            + report.replace("\n", "\n  "))


def build_kernels() -> None:
    """Every kernel built (:func:`start_builds`, then waited for)."""
    wait_builds(start_builds())


def phase_kernels(dev, seed, builds):
    """Phase 3's contiguous kernels (``socket_score``, ``flash_decode``,
    ``flash_prefill``), once their builds are done; the paged kernels'
    builds may still run (:func:`phase_paged_kernels`)."""
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.kernels.socket_score.ref import socket_score_ref

    wait_builds(builds, CONTIGUOUS_SOURCES)
    gen = torch.Generator(device=dev).manual_seed(seed)

    rows = {}
    # -- socket_score: main-path shapes first, then the edges
    L, P, G = 60, 10, 4
    main = dict(bh=16, n=8224, g=G, l=L, p=P)
    score_cases = [
        ("main path", dict(main, int8=False, vnorm=False)),
        ("main path + vnorm", dict(main, int8=False, vnorm=True)),
        ("int8 planes", dict(main, int8=True, vnorm=True)),
        ("pooled G=1", dict(main, g=1, int8=False, vnorm=False)),
        ("ragged N, G=1", dict(bh=3, n=1001, g=1, l=L, p=P, int8=False,
                               vnorm=True)),
        ("smoke P=6 L=12", dict(bh=4, n=77, g=2, l=12, p=6, int8=False,
                                vnorm=False)),
        ("G=3 L=9 P=7", dict(bh=6, n=300, g=3, l=9, p=7, int8=False,
                             vnorm=True)),
        ("int8 G=3 L=9 P=7", dict(bh=6, n=300, g=3, l=9, p=7, int8=True,
                                  vnorm=False)),
        ("P=1", dict(bh=6, n=300, g=2, l=5, p=1, int8=False, vnorm=True)),
        ("P=20 sign-add", dict(bh=6, n=300, g=2, l=3, p=20, int8=False,
                               vnorm=True)),
        ("BH=256 N=513", dict(bh=256, n=513, g=G, l=L, p=P, int8=False,
                              vnorm=False)),
        ("chunked tables P=16", dict(bh=4, n=700, g=G, l=L, p=16,
                                     int8=False, vnorm=True)),
        ("chunked sign-add P=24 L=600", dict(bh=2, n=300, g=G, l=600, p=24,
                                             int8=False, vnorm=False)),
        # gemma-7b's static path: batch 2 x 16 KV heads, 4112 rows, G 1
        (GEMMA7B_TIMED, dict(bh=32, n=4112, g=1, l=L, p=P, int8=False,
                             vnorm=False)),
        # musicgen-medium's (phase 12a): batch 4 x 24 heads, 1500 frames
        # and 16 steps, MHA
        (MUSICGEN_TIMED, dict(bh=96, n=1516, g=1, l=L, p=P, int8=False,
                              vnorm=False)),
    ]
    for label, kw in score_cases:
        bits, u, vn = socket_score_case(dev, gen, **kw)
        args = dict(num_tables=kw["l"], num_planes=kw["p"], tau=0.4)
        out = ss.launch_socket_score(bits, u, vn, **args)
        torch.cuda.synchronize()
        ref = socket_score_ref(bits, u, vn, **args)
        err = check_close(f"socket_score[{label}]", out, ref, SCORE_TOL)
        log(f"socket_score [{label}] {tuple(bits.shape)} "
            f"{str(bits.dtype)[6:]} G={kw['g']}: max|err| {err:.3e} "
            f"(rtol {SCORE_TOL['rtol']}, atol {SCORE_TOL['atol']}); "
            f"{score_plan_note(ss, label, bits, kw)}")
        if label in ("main path", "int8 planes"):
            equal_rows_check(ss, bits, u, args)
            name = "socket_score" + ("[int8]" if kw["int8"] else "")
            rows[name] = socket_score_row(ss, socket_score_ref, dev, gen,
                                          name, kw, args, bits, u, vn, err)
        if label in CASE_ENTRIES:
            rows["socket_score"][CASE_ENTRIES[label]] = case_entry(
                label, socket_score_row(ss, socket_score_ref, dev, gen,
                                        "socket_score", kw, args, bits, u,
                                        vn, err))

    rows.update(flash_decode_rows(dev, gen))
    rows.update(flash_prefill_rows(dev, seed))
    return rows


def phase_paged_kernels(dev, seed, builds):
    """Phase 3's paged kernels on every page dtype, once every build is
    done (run after phase 4, which the paged kernels' builds overlap)."""
    wait_builds(builds)
    rows = {}
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES:
        rows.update(paged_rows(dev, seed, kv_dtype))
        rows.update(ring_rows(dev, seed, kv_dtype))
    return rows


# The prefill kernel's cases, (label, BH, BKV, S, hd, window, softcap,
# dtype): the main paths' shapes first (llama31-8b's static prefill of
# batch 2; one gemma3 local layer's prompt of 4096), then the edges.
PREFILL_CASES = [
    ("main path: llama31-8b prefill", 64, 16, 8192, 128, 0, 0.0,
     torch.float32),
    ("gemma3 local, window 1024", 32, 16, 4096, 128, 1024, 0.0,
     torch.float32),
    ("stablelm hd 160, G 4", 32, 8, 2048, 160, 0, 0.0, torch.float32),
    # gemma-7b's static prefill: batch 2 x 16 heads, MHA
    ("gemma-7b hd 256, G 1", 32, 32, 4096, 256, 0, 0.0, torch.float32),
    # musicgen-medium's static prefill (phase 12a): batch 4 x 24 heads of
    # hd 64, MHA, a 1500-frame prompt
    (MUSICGEN_TIMED, 96, 96, 1500, 64, 0, 0.0, torch.float32),
    ("bf16 inputs", 64, 16, 2048, 128, 0, 0.0, torch.bfloat16),
    ("ragged S 4100", 32, 8, 4100, 128, 0, 0.0, torch.float32),
    ("softcap 2, window 512", 32, 16, 2048, 128, 512, 2.0, torch.float32),
    ("ragged S 9, G 4", 8, 2, 9, 128, 0, 0.0, torch.float32),
    ("window 1000 off the key tiles, S 2100", 16, 4, 2100, 128, 1000, 0.0,
     torch.float32),
    ("hd 256, G 4", 16, 4, 1100, 256, 0, 0.0, torch.float32),
    ("bf16, window 300", 32, 8, 1500, 128, 300, 0.0, torch.bfloat16),
]
PREFILL_PLAIN_CHUNK = 512        # the plain version's query chunk
# the SASS opcodes of the prefill kernel's design: tensor-core mma
# (HMMA) and asynchronous global-to-shared copies
PREFILL_SASS = ("HMMA",) + ASYNC_COPY_SASS


def prefill_build_report(fp):
    """The prefill library's build: ptxas's registers and spills per
    instantiation (its build log), and the SASS
    opcode counts that show the tensor cores and the asynchronous copies
    at work (``cuobjdump -sass``; raises if the tool is missing or an
    opcode family is absent)."""
    from repro_torch.kernels import build
    lib = build.build_library(fp.SOURCE)
    per_kernel, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"flash_prefill_kernelILi(\d+)E(f|13__nv_bfloat16)",
                      line)
        if "Compiling entry function" in line and m:
            name = (int(m.group(1)), "f32" if m.group(2) == "f" else "bf16")
            per_kernel[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            per_kernel[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            per_kernel[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    for (hd, dt), info in sorted(per_kernel.items()):
        log(f"  flash_prefill hd {hd} {dt}: {info.get('registers')} "
            f"registers, spill stores/loads {info.get('spill_stores')}/"
            f"{info.get('spill_loads')} B")
    if len(per_kernel) != 2 * len(fp.HEAD_DIMS):
        raise AssertionError(f"flash_prefill build log names "
                             f"{sorted(per_kernel)}, not every head dim")
    counts = sass_counts(lib, PREFILL_SASS, "flash_prefill")
    if not counts["HMMA"] or not (counts["LDGSTS"] or counts["UTMALDG"]):
        raise AssertionError(f"flash_prefill SASS lacks tensor-core mma or "
                             f"asynchronous copies: {counts}")
    return counts, {f"hd{hd}_{dt}": info
                    for (hd, dt), info in sorted(per_kernel.items())}


def prefill_cost(bh, bkv, s, hd, window, dtype):
    """Bytes (q and out at BH, k and v at BKV, each once) and operations
    (4 * hd a kept (query, key) pair: q.k and p.v) of the causal
    function."""
    keys = s * (s + 1) // 2 if not window else sum(
        min(i + 1, window) for i in range(s))
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = bh * s * hd * (esize + 4) + 2 * bkv * s * hd * esize
    return float(nbytes), float(4 * hd * bh * keys)


def prefill_bound(nbytes, flops, dtype):
    """The prefill kernel's bound on the compute unit it runs on: its
    products as TF32 tensor-core products at the data sheet's TF32 rate,
    three a product for f32 inputs (3xTF32), and for bf16 ones (exact in
    TF32) one for q.k and two for p.v."""
    products = 3.0 if dtype == torch.float32 else 1.5
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (products * flops / TF32_FLOP_PER_S * 1e3, "operations"))


def flash_prefill_rows(dev, seed):
    """The prefill kernel against its plain version on ``PREFILL_CASES``;
    the main case (and gemma3's local one, logged) timed beside its
    bound, the plain version and ``scaled_dot_product_attention`` (causal,
    or a bool window mask; GQA by ``enable_gqa``)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    sass, ptxas = prefill_build_report(fp)

    def inputs(bh, bkv, s, hd, dtype):
        return tuple(torch.randn((n, s, hd), generator=gen, device=dev)
                     .to(dtype) for n in (bh, bkv, bkv))

    rows = {}
    for label, bh, bkv, s, hd, window, cap, dtype in PREFILL_CASES:
        scale = 1.0 / math.sqrt(hd)
        kw = dict(scale=scale, window=window, softcap=cap)
        plain = functools.partial(flash_prefill_ref, q_chunk=PREFILL_PLAIN_CHUNK,
                                  **kw)
        case = inputs(bh, bkv, s, hd, dtype)
        out = fp.launch_flash_prefill(*case, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash_prefill[{label}]", out, plain(*case),
                          PREFILL_TOL)
        nbytes, flops = prefill_cost(bh, bkv, s, hd, window, dtype)
        bms, by = prefill_bound(nbytes, flops, dtype)
        log(f"flash_prefill [{label}] BH {bh} BKV {bkv} S {s} hd {hd} window "
            f"{window} softcap {cap} {str(dtype)[6:]}: max|err| {err:.3e} "
            f"(atol {PREFILL_TOL['atol']}); bound {bms:.3f} ms ({by})")
        del out
        if not label.startswith(("main path", "gemma3 local")) and \
                label not in CASE_ENTRIES:
            continue
        sets = [case] + [inputs(bh, bkv, s, hd, dtype)
                         for _ in range(rotations(nbytes) - 1)]
        kernel = functools.partial(fp.launch_flash_prefill, **kw)
        ms = device_time_ms(kernel, sets, iters=4, replays=2)
        plain_ms = device_time_ms(plain, sets, iters=2, replays=1)
        # the library call: SDPA in fp32 through the memory-efficient
        # backend (fp32 rules out flash; the math backend would build the
        # (BH, S, S) logits), GQA by enable_gqa, the window as a bool mask
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & \
                (i[:, None] - i[None, :] < window)

        def lib(q, k, v, gqa=True):
            return sdpa(q[None], k[None], v[None], attn_mask=mask,
                        is_causal=mask is None, scale=scale,
                        enable_gqa=gqa)[0]

        lib_sets, call = sets, "enable_gqa"
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # why each backend
                    want = lib(*case)                 # declined
            except RuntimeError as e:
                # this backend takes no GQA: K/V repeated to the query
                # heads beforehand (not timed)
                log(f"  SDPA with enable_gqa: {e}".splitlines()[0])
                g = bh // bkv
                lib_sets = [(q, k.repeat_interleave(g, 0),
                             v.repeat_interleave(g, 0)) for q, k, v in sets]
                lib = functools.partial(lib, gqa=False)
                call = "K/V repeated to the query heads beforehand"
                want = lib(*lib_sets[0])
            check_close(f"flash_prefill[{label}, SDPA yardstick]", want,
                        plain(*case), ATTN_TOL)
            del want
            lib_ms = device_time_ms(lib, lib_sets, iters=4, replays=2)
        del lib_sets
        b2b = back_to_back_ms(kernel, sets, iters=4)
        log(f"flash_prefill [{label}] kernel {ms:.3f} ms, plain {plain_ms:.3f}"
            f" ms, SDPA {lib_ms:.3f} ms, back to back {b2b:.3f} ms; bound "
            f"{bms:.3f} ms by {by} on the tensor cores, {ms / bms:.2f}x "
            f"(3xTF32 {3 * flops / TF32_FLOP_PER_S * 1e3:.3f}, TF32 "
            f"{flops / TF32_FLOP_PER_S * 1e3:.3f}, bf16 "
            f"{flops / BF16_FLOP_PER_S * 1e3:.3f} ms; f32 outside them "
            f"{flops / FP32_FLOP_PER_S * 1e3:.3f} ms)")
        if label in CASE_ENTRIES:
            rows["flash_prefill"][CASE_ENTRIES[label]] = case_entry(
                label, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=lib_ms,
                            bound_f32_ms=flops / FP32_FLOP_PER_S * 1e3,
                            back_to_back_ms=b2b))
        if label.startswith("main path"):
            rows["flash_prefill"] = dict(
                name="flash_prefill", route="cuda",
                source="src/repro_torch/kernels/flash_prefill/"
                       "flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill/"
                         "flash_prefill.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                library_call="scaled_dot_product_attention, fp32, "
                             f"is_causal, {call} (memory-efficient "
                             "backend)",
                bound_3xtf32_ms=3 * flops / TF32_FLOP_PER_S * 1e3,
                bound_f32_ms=flops / FP32_FLOP_PER_S * 1e3,
                bound_tf32_ms=flops / TF32_FLOP_PER_S * 1e3,
                bound_bf16_ms=flops / BF16_FLOP_PER_S * 1e3,
                back_to_back_ms=b2b, sass=sass, ptxas=ptxas)
        del sets, case
    return rows


# phase 5f: the contiguous attention kernels on a bf16 model's inputs,
# (label, shape): the static paths' shapes (llama31-8b's, gemma-7b's hd
# 256 / G 1, timed) and llama4-maverick's G 5 (checked)
BF16_DECODE_CASES = [
    ("main path", dict(bh=16, k=823, g=4, hd=128)),
    (GEMMA7B_TIMED, dict(bh=32, k=412, g=1, hd=256)),
    ("llama4 G 5", dict(bh=16, k=412, g=5, hd=128)),
]
BF16_PREFILL_CASES = [
    ("main path: llama31-8b prefill", dict(bh=64, bkv=16, s=8192, hd=128)),
    (GEMMA7B_TIMED, dict(bh=32, bkv=32, s=4096, hd=256)),
    ("llama4 G 5", dict(bh=80, bkv=16, s=4096, hd=128)),
]


def sdpa_bf16(q, k, v, *, scale, mask=None, causal=False):
    """``scaled_dot_product_attention`` on bf16 inputs, its flash backend
    allowed (the memory-efficient one where flash declines), GQA by
    ``enable_gqa``: the library call for a bf16 attention."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal, scale=scale,
            enable_gqa=q.shape[-3] != k.shape[-3])


def bf16_attention_rows(dev, seed):
    """Phase 5f's ``flash_decode`` and ``flash_prefill`` entries: each
    kernel on bf16 q/k/v against its plain version (ATTN_TOL, PREFILL_TOL:
    both compute in float32 on the same bf16 values) on
    ``BF16_DECODE_CASES`` and ``BF16_PREFILL_CASES``; the main and
    gemma-7b cases timed beside their bound (bytes at the HBM rate,
    operations at the bf16 tensor rate), the plain version and SDPA on
    the same bf16 inputs.  Returns {kernel: its ``bf16`` entry}."""
    from repro_torch.kernels.flash_decode import cases, ops as fd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    bf = torch.bfloat16
    out = {}

    def decode_case(bh, k, g, hd):
        q, kk, vv, mask = cases.card_case(gen, bh=bh, k=k, g=g, hd=hd,
                                          dtype=bf)
        return q.to(bf), kk, vv, mask

    for label, kw in BF16_DECODE_CASES:
        bh, k, g, hd = kw["bh"], kw["k"], kw["g"], kw["hd"]
        scale = 1.0 / math.sqrt(hd)
        case = decode_case(**kw)
        got = fd.launch_flash_decode(*case, scale=scale)
        torch.cuda.synchronize()
        err = check_close(f"flash_decode[bf16, {label}]", got,
                          flash_decode_ref(*case, scale=scale), ATTN_TOL)
        log(f"flash_decode [bf16, {label}] BH={bh} K={k} G={g} hd={hd}: "
            f"max|err| {err:.3e} (rtol {ATTN_TOL['rtol']}, atol "
            f"{ATTN_TOL['atol']})")
        if label.startswith("llama4"):
            continue
        sets = [case] + [decode_case(**kw) for _ in
                         range(rotations(2 * bh * k * hd * 2) - 1)]
        valid = sum(int(c[3].sum().item()) for c in sets) / len(sets)
        nbytes = bh * g * hd * (2 + 4) + 2 * valid * hd * 2 + bh * k
        flops = valid * g * (4 * hd + 4)
        kernel = functools.partial(fd.launch_flash_decode, scale=scale)
        entry = dict(
            case=label, max_abs_err=err, ms=device_time_ms(kernel, sets),
            plain_ms=device_time_ms(
                functools.partial(flash_decode_ref, scale=scale), sets),
            library_ms=device_time_ms(
                lambda a, b, c, m: sdpa_bf16(
                    a[:, None], b[:, None], c[:, None],
                    mask=m[:, None, None, :], scale=scale), sets),
            library_call="scaled_dot_product_attention, bf16, bool mask",
            back_to_back_ms=back_to_back_ms(kernel, sets))
        entry["bound_ms"], entry["bound_by"] = bound_bf16(nbytes, flops)
        log(f"flash_decode [bf16, {label}] timed: kernel {entry['ms']:.4f} "
            f"ms, bound {entry['bound_ms']:.5f} ({entry['bound_by']}), "
            f"plain {entry['plain_ms']:.4f}, SDPA {entry['library_ms']:.4f}")
        if label == GEMMA7B_TIMED:
            out["flash_decode"]["gemma7b"] = entry
        else:
            out["flash_decode"] = entry
        del sets

    def prefill_case(bh, bkv, s, hd):
        return tuple(torch.randn((n, s, hd), generator=gen, device=dev)
                     .to(bf) for n in (bh, bkv, bkv))

    for label, kw in BF16_PREFILL_CASES:
        bh, bkv, s, hd = kw["bh"], kw["bkv"], kw["s"], kw["hd"]
        scale = 1.0 / math.sqrt(hd)
        plain = functools.partial(flash_prefill_ref, scale=scale,
                                  q_chunk=PREFILL_PLAIN_CHUNK)
        case = prefill_case(**kw)
        got = fp.launch_flash_prefill(*case, scale=scale)
        torch.cuda.synchronize()
        err = check_close(f"flash_prefill[bf16, {label}]", got,
                          plain(*case), PREFILL_TOL)
        log(f"flash_prefill [bf16, {label}] BH {bh} BKV {bkv} S {s} hd "
            f"{hd}: max|err| {err:.3e} (atol {PREFILL_TOL['atol']})")
        del got
        if label.startswith("llama4"):
            continue
        nbytes, flops = prefill_cost(bh, bkv, s, hd, 0, bf)
        sets = [case] + [prefill_case(**kw)
                         for _ in range(rotations(nbytes) - 1)]
        kernel = functools.partial(fp.launch_flash_prefill, scale=scale)

        def lib(q, k, v):
            return sdpa_bf16(q[None], k[None], v[None], scale=scale,
                             causal=True)[0]

        lib_sets, call = sets, "enable_gqa"
        try:
            want = lib(*case)
        except RuntimeError as e:
            # no backend took GQA: K/V repeated to the query heads
            # beforehand (not timed)
            log(f"  SDPA bf16 with enable_gqa: {e}".splitlines()[0])
            lib_sets = [(q, k.repeat_interleave(bh // bkv, 0),
                         v.repeat_interleave(bh // bkv, 0))
                        for q, k, v in sets]
            call = "K/V repeated to the query heads beforehand"
            want = lib(*lib_sets[0])
        check_close(f"flash_prefill[bf16, {label}, SDPA yardstick]",
                    want.float(), plain(*case), BF16_SDPA_TOL)
        del want
        entry = dict(
            case=label, max_abs_err=err,
            ms=device_time_ms(kernel, sets, iters=4, replays=2),
            plain_ms=device_time_ms(plain, sets, iters=2, replays=1),
            library_ms=device_time_ms(lib, lib_sets, iters=4, replays=2),
            library_call="scaled_dot_product_attention, bf16, is_causal, "
                         f"{call} (flash or memory-efficient backend)",
            bound_design_ms=prefill_bound(nbytes, flops, bf)[0],
            back_to_back_ms=back_to_back_ms(kernel, sets, iters=4))
        entry["bound_ms"], entry["bound_by"] = bound_bf16(nbytes, flops)
        log(f"flash_prefill [bf16, {label}] timed: kernel {entry['ms']:.3f} "
            f"ms, bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}, "
            f"bf16 rate; on TF32 products as the kernel runs them "
            f"{entry['bound_design_ms']:.3f}), plain "
            f"{entry['plain_ms']:.3f}, SDPA {entry['library_ms']:.3f}")
        if label == GEMMA7B_TIMED:
            out["flash_prefill"]["gemma7b"] = entry
        else:
            out["flash_prefill"] = entry
        del sets, case, lib_sets
    return out


# The fused paged kernels' cases: the continuous phase's shapes first
# (8 KV heads, G=4, hd=128, bs=16; contexts 1-4K, a 264-block table), then
# the edges.  The last ones exercise the cluster split of
# paged_attention.cu and paged_quest.cu: 32K contexts (several tiles or
# chunks of bounds a rank), a tie-heavy case at sparsity 2 whose selected
# ties span ranks, requests shorter than one rank's range (whole ranks
# idle) and, for SOCKET and hard LSH, pooled selection (GS 1).
MAIN_LENS = [1024, 2048, 3072, 4096, 1024, 2048, 3072, 4096]
_CLUSTER_CASES = [
    ("32K contexts", dict(lengths=[32768, 20000, 9000, 32000], nb=2048)),
    ("ties across ranks", dict(lengths=[600, 1500, 2900, 333], nb=200,
                               sink=16, window=16, ties=True,
                               sparsity=2.0)),
    ("idle ranks", dict(lengths=[5, 4096, 17, 1000], nb=264)),
    ("pooled GS 1", dict(lengths=MAIN_LENS, nb=264, pooled=True)),
]
# the head dims of the all-global architectures the continuous phases
# serve besides llama31-8b's hd 128: gemma-7b (MHA, KVH 16, G 1, hd 256;
# its continuous lengths are MAIN_LENS) and stablelm-12b (G 4, hd 160).
# The kernels size their K/V chunk stages by hd (25 rows a chunk at hd 160
# on f32 pages: no multiple of the 16-row page).
_HEAD_DIM_CASES = [
    (GEMMA7B_TIMED, dict(lengths=MAIN_LENS, nb=264, kvh=16, g=1, hd=256)),
    ("stablelm hd 160, G 4", dict(lengths=MAIN_LENS, nb=264, kvh=8, g=4,
                                  hd=160)),
]
# the cases also run on stored pools (bf16, int8, fp8)
STORED_CASES = ("main path", "tie-heavy") + tuple(
    c[0] for c in _CLUSTER_CASES + _HEAD_DIM_CASES)
# phase 5f's bf16-query cases (on bf16 pages): the main case, gemma-7b's
# hd 256 / G 1, and llama4-maverick's G 5 (40 query heads over 8 KV heads,
# the engine's shape of its phase-5f run)
BF16_Q_EXTRA = [("llama4 G 5", dict(lengths=MAIN_LENS, nb=264, kvh=8,
                                    g=5))]
BF16_Q_CASES = ("main path", GEMMA7B_TIMED, "llama4 G 5")
PAGED_CASES = {
    "paged_attention": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("short tables, sink/window 16", dict(lengths=[33, 600, 1500, 57],
                                              nb=96, sink=16, window=16)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16,
                           window=16, ties=True)),
        # the gemma3 continuous phase's global layers: KVH 16, G 2
        ("gemma3 global layers, KVH 16 G 2",
         dict(lengths=[2080, 3104, 4128, 6176, 2079, 3103, 4127, 6175],
              nb=392, kvh=16, g=2)),
        *_CLUSTER_CASES,
        *_HEAD_DIM_CASES,
    ],
    "paged_hard_lsh": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("l=37 unaligned tables", dict(lengths=[33, 600, 1500, 57], nb=96,
                                       l=37, sink=16, window=16)),
        *_CLUSTER_CASES,
        *_HEAD_DIM_CASES,
    ],
    "paged_quest": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > live pages", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("ps=8, two pages a block", dict(lengths=[33, 600, 1500, 57], nb=96,
                                         ps=8, sink=16, window=16)),
        _CLUSTER_CASES[0],
        # a table of more than 256 pages (two ranks or more) and a request
        # with more live pages than the budget, so ties are cut
        ("ties across ranks", dict(lengths=[600, 1500, 5800, 333], nb=520,
                                   sink=16, window=16, ties=True,
                                   sparsity=2.0)),
        _CLUSTER_CASES[2],
        *_HEAD_DIM_CASES,
    ],
}


def bf16_queries(sets, quest=False):
    """The input sets of a paged case with the query (first input) in
    bf16, and for Quest (``quest``) its page bounds too, as a bf16 model's
    pool holds them."""
    bf = torch.bfloat16
    if quest:
        return [(q.to(bf), kp, vp, kmin.to(bf), kmax.to(bf), *rest)
                for q, kp, vp, kmin, kmax, *rest in sets]
    return [(q.to(bf), *rest) for q, *rest in sets]


def bound_bf16(nbytes: float, flops: float):
    """:func:`bound` for bf16 inputs: their operations at the data sheet's
    dense bf16 tensor rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kv_row_bytes(case, scales) -> int:
    """Bytes of one K and one V row of ``case``'s pool, with their scales
    when it has them (int8/fp8: 2 * (hd + 4))."""
    kp = case[1]
    return 2 * (kp.shape[-1] * kp.element_size() + (4 if scales else 0))


def lsh_cost(case, args, hard, row_bytes):
    """Bytes and operations the SOCKET (or hard-LSH) function must spend
    on ``case``: the bits and vnorm of each scored token, and the query
    hash, only for requests whose budget exceeds their forced sink and
    window rows (elsewhere the selection is those rows, whatever the
    scores); the selected K/V rows (``row_bytes`` each, scales included),
    forced ones included; q, the table, the output.  Operations: one FMA
    (P split into table lookups) or one compare per (scored token, g, l);
    q.k and p.v per selected row.  Returns (bytes, operations, bytes of
    the pool rows touched)."""
    q, bits, qhash, bt = case[0], case[3], case[5], case[6]
    lens, budget = case[7].cpu().long(), case[8].cpu().long()
    b, kvh, g, hd = q.shape
    w = bits.shape[-1]
    gs, l, p = qhash.shape[2:]
    forced = torch.clamp(lens, max=args["sink_tokens"] + args["window_tokens"])
    live = budget > forced
    scored = int(torch.where(live, lens - forced, 0).sum())
    nsel = int(torch.minimum(budget, lens).sum())
    touched = kvh * (scored * (w * 4 + 2) + nsel * row_bytes)
    nbytes = touched + kvh * (b * g * hd * (q.element_size() + 4) +
                              int(live.sum()) * gs * l * p * 4) + \
        bt.numel() * 4
    flops = kvh * (scored * g * l * (1 if hard else 2) + nsel * g * 4 * hd)
    return float(nbytes), float(flops), float(touched)


def quest_cost(case, args, sel, row_bytes):
    """As :func:`lsh_cost` for Quest: kmin and kmax (in their dtype) of
    each live page that is neither sink nor window (for requests whose
    page budget exceeds those forced pages), the selected live K/V rows,
    q, the table, the output; 4 operations per (scored page, g, d), q.k
    and p.v per row."""
    q, bt, length, budget = case[0], case[5], case[6], case[7]
    b, kvh, g, hd = q.shape
    ps, sink = args["page_size"], args["sink_tokens"]
    window = args["window_tokens"]
    scored = 0
    for n, kp in zip(length.tolist(), budget.tolist()):
        start = torch.arange(-(-n // ps)) * ps
        free = (start >= sink) & (start < n - window - ps)
        if kp > len(start) - int(free.sum()):
            scored += int(free.sum())
    nsel = int(sel.sum())
    touched = kvh * scored * 2 * hd * case[3].element_size() + \
        nsel * row_bytes
    nbytes = touched + b * kvh * g * hd * (q.element_size() + 4) + \
        bt.numel() * 4
    flops = kvh * scored * g * hd * 4 + nsel * g * 4 * hd
    return float(nbytes), float(flops), float(touched)


def paged_kernels():
    """name -> (source, replaces, seed offset, case builder, launch, check
    returning (max |err|, note), plain version of a case's args, cost).
    Checks take the case's scale pools (``cases.store_kv``), plain versions
    and costs the same, costs the bytes of one K and V row too."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    from repro_torch.kernels.paged_attention import ref

    def top_k(sets, kw):
        return min(kw["nb"] * 16, int(sets[0][8].max()))

    def check_socket(out, sel, case, args, kw, scales):
        err, near = cases.check_paged(out, sel, case, args,
                                      ties=kw.get("ties", False),
                                      attn_tol=ATTN_TOL, score_tol=SCORE_TOL,
                                      scales=scales)
        return err, (f"budgets {case[8].tolist()}; selection equal" +
                     (f" but {near} rows within the threshold band"
                      if near else ""))

    def check_hard(out, sel, case, args, kw, scales):
        err = cases.check_hard_lsh(out, sel, case, args, attn_tol=ATTN_TOL,
                                   scales=scales)
        eff = cases.plain_hard_eff(case, args)
        return err, (f"budgets {case[8].tolist()}; selection equal bit for "
                     f"bit; {int((eff == 0).sum())} of {eff.numel()} scored "
                     "rows score exactly 0")

    def check_quest(out, sel, case, args, kw, scales):
        err = cases.check_quest(out, sel, case, args, attn_tol=ATTN_TOL,
                                scales=scales)
        return err, (f"page budget {int(case[7][0])} of "
                     f"{kw['nb'] * 16 // args['page_size']}; selection equal "
                     f"bit for bit, {int(sel.sum().item())} rows")

    def plain_socket(sets, args, kw, scales):
        tk = top_k(sets, kw)
        return lambda q, kp, vp, bits, vn, u, bt, length, budget: \
            ref.paged_socket_attend_ref(q, kp, vp, bits, vn, u, bt,
                                        length=length, budget=budget,
                                        top_k=tk, **args, **scales)

    def plain_hard(sets, args, kw, scales):
        tk = top_k(sets, kw)
        return lambda q, kp, vp, bits, vn, us, bt, length, budget: \
            ref.paged_hard_lsh_attend_ref(q, kp, vp, bits, vn, us, bt,
                                          length=length, budget=budget,
                                          top_k=tk, **args, **scales)

    def plain_quest(sets, args, kw, scales):
        pb = int(sets[0][7][0])
        return lambda q, kp, vp, kmin, kmax, bt, length, _budget: \
            ref.paged_quest_attend_ref(q, kp, vp, kmin, kmax, bt,
                                       length=length, page_budget=pb, **args,
                                       **scales)

    src = "src/repro_torch/kernels/paged_attention/"
    tpu = "src/repro/kernels/paged_attention/"
    return {
        "paged_attention": (
            src + "paged_attention.cu", tpu + "paged_attention.py:69", 7,
            cases.paged_case, pa.launch_paged_socket_attend, check_socket,
            plain_socket,
            lambda case, args, sel, rb: lsh_cost(case, args, False, rb)),
        "paged_hard_lsh": (
            src + "paged_attention.cu", tpu + "paged_hard_lsh.py:45", 11,
            cases.hard_lsh_case, pa.launch_paged_hard_lsh_attend, check_hard,
            plain_hard,
            lambda case, args, sel, rb: lsh_cost(case, args, True, rb)),
        "paged_quest": (
            src + "paged_quest.cu", tpu + "paged_quest.py:46", 13,
            cases.quest_case, pa.launch_paged_quest_attend, check_quest,
            plain_quest, quest_cost),
    }


def cluster_note(name, label, case, args, sel) -> str:
    """The cluster split ``paged_attention.cu`` or ``paged_quest.cu`` ran
    ``case`` with, and that the cluster cases exercise it: selected ties
    of one (request, head) on two or more ranks; ranks with no live
    block; Quest's main path split over two ranks or more."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    quest = name == "paged_quest"
    q, kp = case[0], case[1]
    bt, length, budget = case[5:8] if quest else case[6:9]
    if quest:
        plan = pa.paged_quest_plan(q, kp, bt, page_size=args["page_size"])
    else:
        plan = pa.paged_attention_plan(q, kp, case[3], case[5], bt,
                                       hard=name == "paged_hard_lsh")
    c, bs = plan["cluster"], kp.shape[2]
    note = (f"KVH {q.shape[1]} G {q.shape[2]} hd {q.shape[3]}: C {c} "
            f"({plan['clusters_at_once']} clusters at once), "
            f"{plan['smem_bytes']} B a CTA, {plan['stages']} K/V stages of "
            f"{plan['chunk_rows']} rows")
    if quest and label.startswith("main path") and c < 2:
        raise AssertionError("paged_quest: the main path ran on one rank a "
                             "(request, head), not a cluster")
    if label == "ties across ranks" and name != "paged_hard_lsh":
        if quest:
            ps = args["page_size"]
            eff = cases.quest_page_eff(case, args).cpu()
            spread = cases.tie_ranks(
                eff, cases.quest_page_selection(sel.cpu(), ps),
                (length.cpu() + ps - 1) // ps, budget.cpu(), bs=bs // ps,
                c=c)
        else:
            eff = cases.plain_eff(case, args).cpu()
            spread = cases.tie_ranks(eff, sel.reshape(eff.shape).cpu(),
                                     length.cpu(), budget.cpu(), bs=bs, c=c)
        if spread < 2 or quest and not cases.ties_cut(
                eff, cases.quest_page_selection(sel.cpu(), args["page_size"])):
            raise AssertionError("the tie case's selected ties lie on one "
                                 "rank, or all of them are selected: it does "
                                 "not test the carried count")
        note += f"; selected ties on up to {spread} ranks"
    if label == "idle ranks":
        idle = sum(r0 == r1 for n in length.tolist()
                   for r0, r1 in cases.cta_ranges(n, bs, c))
        if not idle:
            raise AssertionError("the idle-ranks case left no rank idle")
        note += f"; {idle} idle ranks"
    return note


def paged_rows(dev, seed, kv_dtype="auto", q_bf16=False):
    """Each fused paged kernel against its plain version at the continuous
    path's shapes and edges, its pool's K/V pages stored as ``kv_dtype``
    (``auto``: f32 and every case of ``PAGED_CASES``; else the main case
    and the tie-heavy one, stored by ``cases.store_kv``, where SOCKET's
    and hard LSH's selections must also equal the kernel's on the f32
    pages of the same case); times at the main shapes, entries named
    ``name`` or ``name[kv_dtype]``.  ``q_bf16`` (phase 5f, on bf16 pages):
    the query (and Quest's page bounds) in bf16, as a bf16 model passes
    them, on the main case,
    gemma-7b's hd 256 / G 1 and llama4's G 5, both of the first timed
    (entries ``name[bf16]``, bound at the bf16 rate)."""
    from repro_torch.kernels.paged_attention import cases
    rows = {}
    for name, (source, replaces, offset, build, launch, check, plain,
               cost) in paged_kernels().items():
        gen = torch.Generator(device=dev).manual_seed(seed + offset)
        quest = name == "paged_quest"
        for label, kw in PAGED_CASES[name] + (BF16_Q_EXTRA if q_bf16
                                              else []):
            if q_bf16:
                if not label.startswith(BF16_Q_CASES):
                    continue
            elif kv_dtype != "auto" and not label.startswith(STORED_CASES):
                continue
            sets, args = build(gen, **kw)
            out32, sel32 = None, None
            scales = {}
            if kv_dtype != "auto":
                if not quest:
                    out32, sel32 = launch(*sets[0], with_selection=True,
                                          **args)
                sets, scales = cases.store_kv(sets, kv_dtype, quest=quest)
            if q_bf16:
                sets = bf16_queries(sets, quest)
            out, sel = launch(*sets[0], with_selection=True, **args,
                              **scales)
            torch.cuda.synchronize()
            try:
                err, note = check(out, sel, sets[0], args, kw, scales)
                if sel32 is not None and not torch.equal(sel, sel32):
                    raise AssertionError(
                        f"{name}: the selection on {kv_dtype} pages differs "
                        "from the one on the f32 pages of the same case")
            except AssertionError as e:
                raise AssertionError(f"[{kv_dtype}, {label}] {e}") from None
            if sel32 is not None:
                note += "; selection equal to the f32 pages' bit for bit"
            note += "; " + cluster_note(name, label, sets[0], args, sel)
            log(f"{name} [{kv_dtype}{', bf16 q' if q_bf16 else ''}, "
                f"{label}] lengths {kw['lengths']}: "
                f"max|err| {err:.3e} (rtol {ATTN_TOL['rtol']}, atol "
                f"{ATTN_TOL['atol']}); {note}")
            del out32, sel32
            hd_timed = label == GEMMA7B_TIMED and (kv_dtype == "auto" or
                                                   q_bf16)
            if not (label.startswith("main path") or hd_timed) or \
                    kv_dtype == "bf16" and not q_bf16:
                continue
            row_b = kv_row_bytes(sets[0], scales)
            nbytes, flops, touched = cost(sets[0], args, sel, row_b)
            sets, args = build(gen, copies=rotations(touched), **kw)
            if kv_dtype != "auto":
                sets, scales = cases.store_kv(sets, kv_dtype, quest=quest)
            if q_bf16:
                sets = bf16_queries(sets, quest)
            kernel = functools.partial(launch, **args, **scales)
            ms = device_time_ms(kernel, sets)
            plain_ms = device_time_ms(plain(sets, args, kw, scales),
                                      sets[:2])
            bms, by = (bound_bf16 if q_bf16 else bound)(nbytes, flops)
            key = name if kv_dtype == "auto" else f"{name}[{kv_dtype}]"
            if hd_timed:
                # the main case's row comes first in PAGED_CASES
                rows[key]["gemma7b"] = case_entry(label, dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    back_to_back_ms=back_to_back_ms(kernel, sets)))
                del sets
                continue
            rows[key] = dict(
                name=key, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                back_to_back_ms=back_to_back_ms(kernel, sets))
            del sets
    return rows


def ring_rows(dev, seed, kv_dtype="auto", q_bf16=False):
    """The ring kernel against its plain version on ``cases.RING_CASES``
    (dead slots and the trash page hold NaN, which the kernel must skip),
    its pool stored as ``kv_dtype`` (``auto``: f32; else stored by
    ``cases.store_kv``, dead rows NaN in their scales and fp8 payloads
    too), each case logged with its launch plan (``ops.paged_ring_plan``,
    raising where it does not exercise the case's label); times at the
    main shape, and at B 2 (``b2``), beside the bound, the plain version
    and, for f32 pages, ``scaled_dot_product_attention`` over the
    pre-gathered ring views (``library_ms``) and the gather from the
    pool, the window mask and SDPA timed as one callable
    (``library_with_gather_ms``; no one PyTorch call dequantizes and
    attends: ``library_ms`` null).  ``q_bf16`` (phase 5f, on bf16 pages):
    the query in bf16 on the main case and hd 256 / G 1, the main case
    timed (entry ``paged_ring[bf16]``, bound at the bf16 rate)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    timed = {}
    for label, kw in cases.RING_CASES:
        if q_bf16 and not label.startswith(("main path", "hd 256")):
            continue
        sets, args = cases.ring_case(gen, **kw)
        sets, scales = (sets, {}) if kv_dtype == "auto" else \
            cases.store_kv(sets, kv_dtype)
        if q_bf16:
            sets = bf16_queries(sets)
        case = sets[0]
        out = pa.launch_paged_ring_attend(*case, **args, **scales)
        torch.cuda.synchronize()
        try:
            err = cases.check_ring(out, case, args, attn_tol=ATTN_TOL,
                                   scales=scales)
            note = cases.ring_plan_note(
                pa.paged_ring_plan(case[0], case[1], case[3],
                                   window=args["window"]), case, args, label)
        except AssertionError as e:
            raise AssertionError(f"[{kv_dtype}, {label}] {e}") from None
        q, kp, _, bt, pos = case
        b, kvh, g, hd = q.shape
        cap = bt.shape[1] * kp.shape[2]
        live = cases.ring_live(pos, cap, args["window"])
        log(f"paged_ring [{kv_dtype}{', bf16 q' if q_bf16 else ''}, "
            f"{label}] positions {kw['positions']} "
            f"KVH {kvh} G {g} hd {hd} window {args['window']} softcap "
            f"{args['softcap']}: max|err| {err:.3e} (rtol "
            f"{ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}); "
            f"{int(live.sum())} live of {b * cap} slots, dead ones NaN; "
            f"{note}")
        if label.startswith(cases.RING_TIMED) and (kv_dtype != "bf16" or
                                                   q_bf16):
            timed[label] = ring_timing(dev, gen, kw, kv_dtype, case, scales,
                                       err, note, q_bf16)
    if not timed:                         # bf16: checked, not timed
        return {}
    row = timed.pop(next(k for k in timed if k.startswith("main path")))
    if not q_bf16:
        row["b2"] = timed.pop("B 2")
    key = "paged_ring" if kv_dtype == "auto" else f"paged_ring[{kv_dtype}]"
    return {key: dict(
        name=key, route="cuda",
        source="src/repro_torch/kernels/paged_attention/paged_ring.cu",
        replaces="src/repro/kernels/paged_attention/paged_ring.py:42",
        **row)}


def ring_timing(dev, gen, kw, kv_dtype, case, scales, err, note,
                q_bf16=False) -> dict:
    """The ring kernel's time on the shape of ``case`` (a ring case's
    ``kw``, inputs rotated past the L2 cache) beside its bound, its plain
    version and, on f32 pages, SDPA without and with the gather (see
    :func:`ring_rows`)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_ring_attend_ref
    from repro_torch.models.backends.base import gather_block_leaf
    q, kp, _, bt, pos = case
    b, kvh, g, hd = q.shape
    cap = bt.shape[1] * kp.shape[2]
    window = kw.get("window", 1024)
    nlive = int(cases.ring_live(pos, cap, window).sum())
    # the live K/V rows once (scales included), q, the output, the table
    # and positions
    nbytes = kvh * nlive * kv_row_bytes(case, scales) + \
        b * kvh * g * hd * (q.element_size() + 4) + bt.numel() * 4 + b * 4
    flops = kvh * nlive * g * 4 * hd
    sets, args = cases.ring_case(gen, copies=rotations(nbytes), **kw)
    if kv_dtype != "auto":
        sets, scales = cases.store_kv(sets, kv_dtype)
    if q_bf16:
        sets = bf16_queries(sets)
    kernel = functools.partial(pa.launch_paged_ring_attend, **args, **scales)
    ms = device_time_ms(kernel, sets)
    plain_ms = device_time_ms(
        lambda q, kp, vp, bt, pos: paged_ring_attend_ref(
            q, kp, vp, bt, pos=pos, **args, **scales), sets[:2])
    lib_ms, extra = None, {}
    if kv_dtype == "auto":
        # the library call: SDPA over the ring views gathered beforehand
        # (the gather, which the kernel does itself, is not timed), the
        # query group as SDPA's L axis, the window mask as a bool mask
        views = [(q, gather_block_leaf(kp, bt).nan_to_num(0.0),
                  gather_block_leaf(vp, bt).nan_to_num(0.0),
                  cases.ring_live(pos, cap, args["window"])[:, None, None])
                 for q, kp, vp, bt, pos in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = functools.partial(sdpa, scale=args["scale"])
        check_close("paged_ring[SDPA yardstick]",
                    lib(*views[0][:3], attn_mask=views[0][3]),
                    cases.plain_ring(sets[0], args), ATTN_TOL)
        lib_ms = device_time_ms(
            lambda q, k, v, m: lib(q, k, v, attn_mask=m), views)
        del views

        # the same call with the gather from the pool and the window mask
        # inside it: the whole function, as the kernel does it
        def gather_sdpa(q, kp, vp, bt, pos):
            live = cases.ring_live(pos, cap, args["window"])
            return lib(q, gather_block_leaf(kp, bt).nan_to_num(0.0),
                       gather_block_leaf(vp, bt).nan_to_num(0.0),
                       attn_mask=live[:, None, None])

        check_close("paged_ring[gather + SDPA yardstick]",
                    gather_sdpa(*sets[0]), cases.plain_ring(sets[0], args),
                    ATTN_TOL)
        gather_ms = device_time_ms(gather_sdpa, sets)
        extra = dict(library_call="scaled_dot_product_attention over "
                     "the ring views gathered beforehand (gather not "
                     "timed), bool window mask",
                     library_with_gather_ms=gather_ms,
                     library_with_gather_call="gather_block_leaf of "
                     "K and V, nan_to_num, the window mask and "
                     "scaled_dot_product_attention, one callable")
    bms, by = (bound_bf16 if q_bf16 else bound)(nbytes, flops)
    log(f"paged_ring [{kv_dtype}{', bf16 q' if q_bf16 else ''}] B {b} "
        f"timed: kernel {ms:.4f} ms, bound "
        f"{bms:.4f} ({by}), plain {plain_ms:.4f}" +
        (f", SDPA over gathered views {lib_ms:.4f}, gather + mask + SDPA "
         f"{extra['library_with_gather_ms']:.4f}" if lib_ms else "") +
        f"; {note}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, **extra,
                back_to_back_ms=back_to_back_ms(kernel, sets))


# --------------------------------------------------------------- phase 4

@torch.no_grad()
def prefill_routes(cfg, params, prompt, capacity, dev, gate_logits=True):
    """The static prefill three more times, the plain op swapped in for
    ``attention``'s reference to ``flash_prefill`` (the same head layout,
    flattening and merge):

    * through the kernel and through the plain op, each route's layers fed
      by its own earlier layers: the last-token logits within
      LOGITS_ATOL, layer 0's K/V bit for bit, each route's SOCKET bits
      its own keys' signs outside |proj| ~ 0 (bitwise alike where the
      keys are); the deeper layers' K/V drift logged;
    * layer by layer: every layer's call runs the kernel and the plain op
      on the same q/k/v, the kernel route's, and goes on with the
      kernel's output.  Both routes' K/V of a layer are then projected
      from the same input before any attention (equal to the kernel
      route's bit for bit, gated at PREFILL_TOL), and each layer's
      attention output is held to the plain version in float64: within
      ATTN_TOL of it or, where the plain op is farther, no farther than
      the plain op (in ATTN_TOL units), its largest |error| within
      F64_RATIO of the plain op's; the kernel's distance from the plain
      op is logged.  The same inputs through two deliberately wrong ops
      (K/V row ``bh % BKV`` for ``bh // G``, a head order G = 1 cannot
      tell apart; each query seeing one key too many) give the readings
      a fault would, which must fail that gate.

    At bf16 compute (phase 5f) the two free-running routes round to bf16
    between layers in other places, so their logits are held to a
    float32 run of the same weights through the plain op instead
    (:func:`f32_distance_check`), and SOCKET's bits compare outside the
    band of the K rows' bf16 difference.

    ``gate_logits`` False logs the free-running routes' logits distance
    without gating it (a depth at which f32 routes part by more than
    LOGITS_ATOL; phase 12a).

    Returns the kernel route's (logits, caches), the stats (times and
    peak memory of the first two) and, at bf16, the float32 run's
    (logits, caches) (else None)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.models import attention
    from repro_torch.runtime.steps import make_prefill_step

    def plain_op(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
        return flash_prefill_ref(q, k, v, scale=scale, window=window,
                                 softcap=softcap,
                                 q_chunk=q_chunk or PREFILL_PLAIN_CHUNK)

    layers = []

    def both_ops(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
        kw = dict(scale=scale, window=window, softcap=softcap)
        out = fp.launch_flash_prefill(q, k, v, **kw)
        plain = plain_op(q, k, v, **kw)
        exact = plain_op(q.double(), k.double(), v.double(), **kw)
        row = dict(err=(out - plain).abs().max().item(),
                   ratio=tol_ratio(out, plain),
                   ratio_f64=tol_ratio(out, exact),
                   plain_ratio_f64=tol_ratio(plain, exact),
                   max_abs=plain.abs().max().item(),
                   kernel_vs_f64=(out - exact).abs().max().item(),
                   plain_vs_f64=(plain - exact).abs().max().item())
        del plain
        # two faults a kernel could have: K/V row bh % BKV for bh // G (at
        # G 1, where the two agree: K/V row bh + 1, the next head's), and
        # one key too many (each query also sees the next: the mask
        # shifted by one)
        g = q.shape[0] // k.shape[0]
        wrong = plain_op(q, *((k.repeat(g, 1, 1), v.repeat(g, 1, 1)) if g > 1
                              else (k.roll(-1, 0), v.roll(-1, 0))), **kw)
        row["head_order_ratio"] = tol_ratio(wrong, exact)
        ahead = torch.cat([q[:, :1], q[:, :-1]], dim=1)
        wrong = plain_op(ahead, k, v, **kw)[:, 1:]
        row["next_key_ratio"] = tol_ratio(wrong, exact[:, :-1])
        # the gate's limit: ATTN_TOL, or the plain op's own distance
        row["limit"] = max(1.0, row["plain_ratio_f64"])
        layers.append(row)
        return out

    def prefill(op, config=cfg):
        with mock.patch.object(attention.fp_ops, "flash_prefill", op):
            # token ids, or an embeddings-input model's embeddings
            key = "tokens" if cfg.input_mode == "tokens" else "embeds"
            return make_prefill_step(config, capacity)(params,
                                                       {key: prompt})

    def timed_prefill(route, op, stats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = prefill(op)
        torch.cuda.synchronize()
        stats[f"prefill_s_{route}"] = time.perf_counter() - t0
        stats[f"prefill_peak_bytes_above_weights_{route}"] = \
            torch.cuda.max_memory_allocated(dev) - base
        return out

    stats, routes, rerouted = {}, {}, []
    with paired(moe_routes_shared, cfg, rerouted) as to_plain:
        for route, op in (("kernel", fp.flash_prefill), ("plain", plain_op)):
            if route == "plain":
                to_plain()
            routes[route] = timed_prefill(route, op, stats)
    stats["prefill_moe_tokens_rerouted"] = rerouted
    (lk, ck), (lp, cp) = routes.pop("kernel"), routes.pop("plain")
    err = (lk - lp).abs().max().item()
    ref = None
    if is_bf16(cfg):
        torch.cuda.empty_cache()     # room for a widened expert stack
        ref = prefill(plain_op, f32_reference(cfg))
        stats["prefill_bf16_vs_f32"] = f32_distance_check(
            "prefill", lk, lp, ref[0])
    # attention layers only (a Mamba layer's cache is its state)
    drift = [max((a[n] - b[n]).abs().max().item() for n in "kv")
             for a, b in zip(ck, cp) if "k" in a]
    stats.update(prefill_socket_checks(cfg, params, prompt, ck, cp))
    del lp, cp                  # before the layer-by-layer caches
    _, cf = prefill(both_ops)
    kv_err = [max((a[n] - b[n]).abs().max().item() for n in "kv")
              for a, b in zip(ck, cf) if "k" in a]
    del cf
    worst = max(range(len(layers)),
                key=lambda i: layers[i]["ratio_f64"] / layers[i]["limit"])
    f64 = max(r["kernel_vs_f64"] / r["plain_vs_f64"] for r in layers)
    stats.update(prefill_logits_err=err, prefill_kv_drift_by_layer=drift,
                 prefill_kv_err_by_layer=kv_err,
                 prefill_attention_by_layer=layers)
    w = layers[worst]
    log(f"prefill, kernel vs plain op: max|logits err| {err:.3e} ("
        + ("not a gate at bf16" if ref else f"atol {LOGITS_ATOL}" if
           gate_logits else "not a gate at this depth")
        + f"); layer 0 K/V {drift[0]:.1e}; free-running K/V "
        f"drift {max(drift):.3e} (not a gate); "
        f"{stats['prefill_bit_flips']} SOCKET signs differ between the "
        f"routes, {stats['prefill_bit_flips_by_key_drift']} of them where "
        f"the routes' keys part across zero and the rest among the "
        f"{stats['prefill_bits_near_zero']} with |proj| ~ 0, each route's "
        f"bits its own keys' signs (of "
        f"{stats['prefill_bits_layers_compared']} layers); kernel "
        f"{stats['prefill_s_kernel']:.3f} s, plain "
        f"{stats['prefill_s_plain']:.3f} s")
    log(f"prefill layer by layer, both ops fed the kernel route's q/k/v: "
        f"max|K/V err| {max(kv_err):.1e} (atol {PREFILL_TOL['atol']}); "
        f"attention output from the float64 version, in ATTN_TOL units "
        f"(rtol {ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}): the kernel "
        f"{min(r['ratio_f64'] for r in layers):.3f} to "
        f"{max(r['ratio_f64'] for r in layers):.3f}, the plain op "
        f"{min(r['plain_ratio_f64'] for r in layers):.3f} to "
        f"{max(r['plain_ratio_f64'] for r in layers):.3f}; the kernel at "
        f"most {w['ratio_f64'] / w['limit']:.3f} of its limit (layer "
        f"{worst}: kernel {w['ratio_f64']:.3f}, limit {w['limit']:.3f}, "
        f"max|out| {w['max_abs']:.3f}, max|err| kernel "
        f"{w['kernel_vs_f64']:.3e}, plain {w['plain_vs_f64']:.3e}); over "
        f"all layers max|err| of the kernel at most {f64:.3f}x the plain "
        f"op's (limit {F64_RATIO}); kernel vs plain op (not a gate) "
        f"{min(r['ratio'] for r in layers):.3f} to "
        f"{max(r['ratio'] for r in layers):.3f} of ATTN_TOL, max|err| "
        f"{max(r['err'] for r in layers):.3e}; a wrong head order reads "
        f"{min(r['head_order_ratio'] / r['limit'] for r in layers):.3g}x "
        f"the limit or more, one key too many "
        f"{min(r['next_key_ratio'] / r['limit'] for r in layers):.3g}x or "
        f"more")
    if (err > LOGITS_ATOL and ref is None and gate_logits) or \
            drift[0] != 0.0 or \
            max(kv_err) > PREFILL_TOL["atol"] or \
            w["ratio_f64"] > w["limit"] or f64 > F64_RATIO:
        raise AssertionError(f"prefill routes differ: logits {err:.3e}, "
                             f"layer 0 K/V {drift[0]:.3e}, layer by layer "
                             f"K/V {max(kv_err):.3e}; layer {worst}'s "
                             "attention from float64 at "
                             f"{w['ratio_f64']:.3f} of ATTN_TOL, limit "
                             f"{w['limit']:.3f}; the kernel's max|err| "
                             f"{f64:.3f}x the plain op's")
    if len(layers) != len(drift) or min(
            min(r["head_order_ratio"], r["next_key_ratio"]) / r["limit"]
            for r in layers) <= 1.0:
        raise AssertionError("the layer-by-layer gate cannot see a wrong "
                             "head order or mask")
    return lk, ck, stats, ref


def tol_ratio(out, ref, tol=ATTN_TOL) -> float:
    """max |out - ref| / (atol + rtol |ref|): above 1 fails ``tol``."""
    err = (out.double() - ref.double()).abs()
    return (err / (tol["atol"] + tol["rtol"] * ref.double().abs())) \
        .max().item()


def prefill_socket_checks(cfg, params, prompt, ck, cp):
    """SOCKET bits of the kernel route's caches ``ck`` and the plain
    route's ``cp``: each route's bits equal the signs of its own keys'
    projections wherever a projection is clear of rounding (|proj| >
    1e-5 x the sum of |terms|, float64).  Where the routes' keys are
    equal (layer 0, whose K/V are gated bit for bit) that holds the two
    routes' bits equal outside the band; in deeper f32 layers the
    free-running routes' keys part by the K/V drift (logged), which may
    carry a projection across zero: such signs differ between the routes
    and are counted, each route still held to its own keys.  At bf16 the
    free-running routes' keys part after layer 0 by bf16 roundings (see
    :func:`f32_distance_check`), so only the layers whose K rows the two
    routes share are compared (layer 0 at least; the layer-by-layer run
    holds every layer's K/V)."""
    from repro_torch.core import hashing
    s, t = cfg.socket, prompt.shape[1]
    flips, band, drift, compared = 0, 0, 0, 0
    for i, (a, b) in enumerate(zip(ck, cp)):
        if "bits" not in a:                     # a Mamba layer's state
            continue
        if is_bf16(cfg) and not torch.equal(a["k"], b["k"]):
            continue
        compared += 1
        w = params["layers"][i]["attn"]["hash_w"].double()
        signs, near = {}, {}
        for route, c in (("kernel", a), ("plain", b)):
            got = hashing.unpack_signs(c["bits"], s.num_tables,
                                       s.num_planes)[:, :, :t]
            keys = c["k"][:, :, :t].double()
            proj = torch.einsum("bhnd,lpd->bhnlp", keys, w)
            mag = torch.einsum("bhnd,lpd->bhnlp", keys.abs(), w.abs())
            near[route] = proj.abs() <= 1e-5 * mag
            want = torch.where(proj >= 0, 1.0, -1.0)
            if bool((got != want)[~near[route]].any()):
                raise AssertionError(
                    f"layer {i}: the {route} route's SOCKET bits differ "
                    "from its keys' signs where |proj| is clear of "
                    "rounding")
            signs[route] = got
            del proj, mag, want
        differ = signs["kernel"] != signs["plain"]
        flips += int(differ.sum().item())
        band += int(near["kernel"].sum().item())
        drift += int((differ & ~near["kernel"] & ~near["plain"]).sum()
                     .item())
        del signs, near, differ
    if not compared:
        raise AssertionError("no layer's SOCKET bits were compared")
    return dict(prefill_bit_flips=flips, prefill_bits_near_zero=band,
                prefill_bit_flips_by_key_drift=drift,
                prefill_bits_layers_compared=compared)


# ------------------------------------------------ bf16 numerics (5f)

def is_bf16(cfg) -> bool:
    return cfg.compute_dtype == "bfloat16"


def kernel_scoring(cfg):
    """``cfg`` with SOCKET's plain scores taken from float32 u: the
    kernels score from float32 u whatever ``score_dtype`` says (as the TPU
    kernels do), so the plain route they are held to does too; the
    model's own bf16 scores are held to the JAX package on the CPU."""
    return cfg.replace(socket=dataclasses.replace(cfg.socket,
                                                  score_dtype="float32"))


def f32_reference(cfg):
    """``cfg`` computing in float32 through the plain versions (no
    kernel flag on): run on the same bf16 weights, which every product
    widens, it is the yardstick both bf16 routes are held to."""
    return cfg.replace(
        compute_dtype="float32", use_ring_kernel=False,
        socket=dataclasses.replace(cfg.socket, score_dtype="float32",
                                   use_score_kernel=False,
                                   use_flash_decode=False,
                                   use_paged_kernel=False),
        quest=dataclasses.replace(cfg.quest, use_paged_kernel=False))


def f32_distance_check(label, kernel, plain, ref, ratio=F64_RATIO) -> dict:
    """At bf16 the kernel and plain routes round to bf16 between layers
    in other places: from the first layer on, a few float32 ulps between
    the two attentions round, here and there, to neighbouring bf16
    values, so later layers see other queries, SOCKET selections and MoE
    routes may part outside any rounding band (the routes are not paired,
    :func:`paired`), and the logits cannot meet LOGITS_ATOL.  Each route
    is held to a float32 run of the same weights instead: the kernel
    route's largest |logits error| from it no more than ``ratio``
    (F64_RATIO) times the plain route's.  Returns the three distances."""
    kernel, plain, ref = kernel.float(), plain.float(), ref.float()
    for name, t in (("kernel", kernel), ("plain", plain), ("f32", ref)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite {name} logits")
    out = dict(kernel_vs_f32=(kernel - ref).abs().max().item(),
               plain_vs_f32=(plain - ref).abs().max().item(),
               kernel_vs_plain=(kernel - plain).abs().max().item(),
               max_abs_f32=ref.abs().max().item())
    log(f"{label}, bf16 routes against a float32 run of the same weights: "
        f"max|logits err| kernel {out['kernel_vs_f32']:.3e}, plain "
        f"{out['plain_vs_f32']:.3e} (the kernel's at most {ratio}x the "
        f"plain's); kernel vs plain {out['kernel_vs_plain']:.3e} (not a "
        f"gate); max|logits| {out['max_abs_f32']:.3f}")
    if not out["kernel_vs_f32"] <= ratio * out["plain_vs_f32"]:
        raise AssertionError(f"{label}: the bf16 kernel route lies "
                             f"{out['kernel_vs_f32']:.3e} from float32, more "
                             f"than {ratio}x the plain route's "
                             f"{out['plain_vs_f32']:.3e}")
    return out


def paired(pairing, cfg, swapped):
    """``pairing(swapped)`` (a context pairing the kernel route's SOCKET
    selections or MoE routes with the plain route's) at float32 compute;
    at bf16 a context that pairs nothing (:func:`f32_distance_check`)."""
    if is_bf16(cfg):
        return contextlib.nullcontext(lambda: None)
    return pairing(swapped)


def widened(pages):
    """A float32 copy of a pool or per-layer caches: bf16 leaves widened
    (K/V), the others cloned (bits, bf16 value norms, scales, state)."""
    return [{k: v.float() if v.dtype == torch.bfloat16 and k != "vnorm"
             else v.clone() for k, v in layer.items()} for layer in pages]


# arch -> (batch, prompt length, greedy decode steps) of the static path:
# llama31-8b (phases 4 and 5f), gemma-7b, MHA at hd 256 (phase 5d),
# jamba's one attention layer among Mamba and MoE layers (phase 5e),
# llama4's group of a dense and an MoE layer (phase 5f, jamba's traffic),
# and the embeddings-input models of phase 12: musicgen-medium on 30 s of
# 50 Hz EnCodec frames (the clip length it generates), internvl2-26b on
# its trained context (a few 256-patch image tiles and text), each 16
# steps (32 put the whole script past its 1050 s budget on a slow host)
STATIC_CASES = {"llama31-8b": (2, 8192, 32), "gemma-7b": (2, 4096, 16),
                "jamba-v0.1-52b": (2, 4096, 16),
                "llama4-maverick-400b-a17b": (2, 4096, 16),
                "musicgen-medium": (4, 1500, 16),
                "internvl2-26b": (2, 8192, 16)}


def phase_main(dev, seed, card, arch="llama31-8b", numerics="f32",
               num_groups=None, int8_run=True, gate_logits=True):
    """The static path of ``arch`` at full width, and at the depth of its
    continuous card case (``CARD_CASES``: all of it but for jamba's and
    llama4's one group; see the module docstring, phases 4, 5d, 5e, 5f
    and 12) or ``num_groups`` groups, at ``numerics`` ("f32", or "bf16":
    the deployment's, phase 5f, where the kernel and plain routes are
    held to a float32 run of the same weights); an embeddings-input
    model's prompt and step inputs are ``launch.serve``'s Gaussian
    embeddings; ``int8_run`` also runs the path on int8 plane bytes (f32
    only); ``gate_logits`` False logs the f32 routes' free-running
    prefill and step-0 logits distances instead of gating them at
    LOGITS_ATOL (every layer's attention stays gated); returns (launches,
    the weights).  The attention kernels' gates
    count the attention layers alone."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import (CARD_CASES, apply_backend_arg,
                                          card_config, run_serve,
                                          serve_inputs, step_input)
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_serve_step

    batch, prompt_len, steps = STATIC_CASES[arch]
    cfg = apply_backend_arg(card_config(arch, numerics), "socket")
    if numerics == "f32":
        cfg = cfg.replace(attn_q_chunk=512)
    groups = num_groups or (CARD_CASES[arch][3] if arch in CARD_CASES
                            else None)
    if groups is not None:
        cfg = cfg.replace(num_groups=groups)
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed, dev)
    (prompt,) = serve_inputs(cfg, batch, prompt_len, seed, dev).values()
    torch.cuda.synchronize()
    log(f"main: {arch} {cfg.param_count() / 1e9:.3f} B params "
        f"({cfg.param_dtype}, compute {cfg.compute_dtype}, SOCKET scores "
        f"{cfg.socket.score_dtype} in chunks of {cfg.socket.score_chunk}) "
        f"drawn in {time.perf_counter() - t0:.1f} s; "
        f"{cfg.num_layers} layers ({n_attn} attention); batch {batch}, "
        f"prompt {prompt_len}, {steps} decode steps")

    torch.cuda.reset_peak_memory_stats(dev)
    ss.LAUNCHES = fd.LAUNCHES = fp.LAUNCHES = 0
    toks, prefill_s, decode_s = run_serve(cfg, batch, prompt_len, steps,
                                          seed=seed, prompt=prompt,
                                          params=params, device=dev)
    launches = {"socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES,
                "flash_prefill": fp.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    # the decode kernels: attention layers x (steps + the warm-up step);
    # the prefill kernel: attention layers x the one whole-prompt prefill
    expected = {"socket_score": n_attn * (steps + 1),
                "flash_decode": n_attn * (steps + 1),
                "flash_prefill": n_attn}
    for name, count in launches.items():
        if count != expected[name]:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {expected[name]}")
    if tuple(toks.shape) != (batch, steps + 1) or not bool(
            ((toks >= 0) & (toks < cfg.padded_vocab())).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    if cfg.uses_moe:
        expert = sum(t.numel() * t.element_size() for layer in params[
            "layers"] for k, t in layer.get("moe", {}).items()
            if k.startswith("w_"))
        step_ms = decode_s / steps * 1e3
        log(f"{arch}: a decode step ({step_ms:.2f} ms on the host's clock) "
            f"reads every expert's weights, {expert / 1e9:.2f} GB "
            f"({cfg.param_dtype}): {expert / step_ms / 1e9:.3f} TB/s")
    log(json.dumps({
        "main_path": arch, "numerics": numerics,
        "batch": batch, "prompt_len": prompt_len,
        "decode_steps": steps, "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": batch * steps / decode_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "expected_launches": expected, "card": card}))

    # the same run on int8 plane bytes (socket.bits_storage "int8"): the
    # kernel forms the same words from their sign bits, so the scores, and
    # with them every greedy token, equal the packed run's (f32 only: the
    # scoring kernel's inputs are the same at bf16)
    bf16 = is_bf16(cfg)
    if int8_run and not bf16:
        cfg8 = cfg.replace(socket=dataclasses.replace(cfg.socket,
                                                      bits_storage="int8"))
        ss.LAUNCHES = 0
        toks8, _, decode8_s = run_serve(cfg8, batch, prompt_len, steps,
                                        seed=seed, prompt=prompt,
                                        params=params, device=dev)
        launches["socket_score[int8]"] = ss.LAUNCHES
        if ss.LAUNCHES != expected["socket_score"]:
            raise AssertionError(f"socket_score[int8]: {ss.LAUNCHES} "
                                 f"launches, expected "
                                 f"{expected['socket_score']}")
        if not torch.equal(toks8, toks):
            raise AssertionError("int8 plane bytes gave other greedy tokens "
                                 "than packed words")
        log(f"main path on int8 plane bytes: {ss.LAUNCHES} socket_score "
            f"launches, greedy tokens equal to the packed run's; decode "
            f"{batch * steps / decode8_s:.2f} tokens/s")

    # the prefill through the kernel and through the plain op
    capacity = prompt_len + steps
    logits, caches, stats, ref = prefill_routes(cfg, params, prompt,
                                                capacity, dev, gate_logits)
    log(json.dumps({"main_path_prefill": arch, **stats, "card": card}))
    # decode step 0 again on a clone of the prefilled cache, kernel path vs
    # the plain versions (both kernel flags off; at bf16 scoring from
    # float32 u as the kernel does)
    cfg_plain = cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=False, use_flash_decode=False))
    if bf16:
        cfg_plain = kernel_scoring(cfg_plain)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if not torch.equal(tok[:, 0], toks[:, 0]):
        raise AssertionError("prefill is not deterministic: first token "
                             "differs between two runs")
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    serve_plain = make_serve_step(cfg_plain)
    inp = step_input(cfg, tok, seed, 0)
    if bf16:
        serve_f32 = make_serve_step(f32_reference(cfg))
        f32_caches = ref[1]
        torch.cuda.empty_cache()
        lf, _ = serve_f32(params, f32_caches, inp, prompt_len)
    swapped, rerouted = [], []
    with paired(static_ties_shared, cfg, swapped) as to_plain, \
            paired(moe_routes_shared, cfg, rerouted) as moe_to_plain:
        lk, _ = make_serve_step(cfg)(params, caches, inp, prompt_len)
        to_plain()
        moe_to_plain()
        lp, _ = serve_plain(params, plain_caches, inp, prompt_len)
    del caches
    if not bf16:
        log(f"decode step 0: the plain top-k took the kernel route's "
            f"selection in {len(swapped)} of {n_attn} layers (rows inside "
            f"the score band: {swapped})"
            + (f"; MoE tokens the plain route sent to the kernel route's "
               f"experts: {rerouted}" if cfg.uses_moe else ""))
    for name, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {name} path")
    err = (lk - lp).abs().max().item()
    if bf16:
        f32_distance_check("decode step 0", lk, lp, lf)
    else:
        log(f"decode step 0, kernels vs plain versions: max|logits err| "
            f"{err:.3e} ("
            + (f"atol {LOGITS_ATOL}" if gate_logits else
               "not a gate at this depth")
            + f"; max|logits| {lp.abs().max().item():.3f})")
        if err > LOGITS_ATOL and gate_logits:
            raise AssertionError(f"step-0 logits differ by {err:.3e} > "
                                 f"{LOGITS_ATOL}")
    others = {"plain": (serve_plain, plain_caches, lp)}
    if bf16:
        others["float32"] = (serve_f32, f32_caches, lf)
    for label, (serve, cache, lt) in others.items():
        got = [tok, torch.argmax(lt[:, -1], dim=-1)[:, None]]
        for t in range(1, steps):
            lt, _ = serve(params, cache, step_input(cfg, got[-1], seed, t),
                          prompt_len + t)
            got.append(torch.argmax(lt[:, -1], dim=-1)[:, None])
        same = (torch.cat(got, dim=1) == toks)
        prefix = [int(same[b].long().cumprod(0).sum().item())
                  for b in range(batch)]
        log(f"greedy tokens shared by the kernel path and the {label} "
            f"path: {int(same.sum().item())}/{same.numel()} (identical "
            f"prefix per request: {prefix})")
    return launches, params


# --------------------------------------------------------------- phase 5

# fused backend -> (its paged kernel's row name, its counter in
# kernels.paged_attention.ops, the config field whose use_paged_kernel
# turns it on)
FUSED = {"socket_fused": ("paged_attention", "LAUNCHES", "socket"),
         "hard_lsh_fused": ("paged_hard_lsh", "HARD_LSH_LAUNCHES", "socket"),
         "quest_fused": ("paged_quest", "QUEST_LAUNCHES", "quest")}


def layer_kinds(cfg) -> list:
    """Each layer's kind: ``local`` or ``global`` attention, or
    ``mamba``."""
    return [s.attn_type if s.kind == "attn" else s.kind
            for s in cfg.layer_specs]


def draw_params(dev, seed, arch, numerics="f32"):
    """The continuous card case's weights of ``arch``, drawn from
    ``seed`` at ``numerics``' parameter dtype (logged with the depth the
    case cuts to)."""
    from repro_torch.launch.serve import card_config, card_continuous_case
    from repro_torch.models import transformer as tfm
    full = card_config(arch, numerics)
    cfg, _ = card_continuous_case(full, seed, 32)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed, dev)
    torch.cuda.synchronize()
    kinds = layer_kinds(cfg)
    moe = sum(s.mlp == "moe" for s in cfg.layer_specs)
    log(f"{arch}: {cfg.param_count() / 1e9:.3f} B params "
        f"({cfg.param_dtype}) drawn "
        f"in {time.perf_counter() - t0:.1f} s; {cfg.num_layers} of "
        f"{full.num_layers} layers ("
        + ", ".join(f"{kinds.count(k)} {k}" for k in
                    ("local", "global", "mamba") if k in kinds)
        + (f"; {moe} MoE" if moe else "") + ")"
        + ("" if cfg.num_groups == full.num_groups else
           f": depth cut to num_groups {cfg.num_groups} of "
           f"{full.num_groups}, widths as published"))
    return params


@torch.no_grad()
def forced_logits_err(cfg, cfg_plain, params, kernel_pages, plain_pages,
                      tokens, pos, bt, live):
    """One decode iteration through the kernel route and the plain route
    layer by layer, each layer of both routes fed the kernel route's
    input to it (teacher forcing): both append the same quantized row,
    so only the attention routes differ.  Every layer's two outputs go
    through the final norm and the head; returns the largest |logits
    difference| over layers and the live requests."""
    from repro_torch.models import transformer as tfm
    x = tfm.embed_tokens(cfg, params["embed"], tokens)
    worst = 0.0
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        xk, _ = tfm._block_decode(cfg, lp, spec, x, kernel_pages[i], pos, bt)
        xp, _ = tfm._block_decode(cfg_plain, lp, spec, x, plain_pages[i],
                                  pos, bt)
        lk, lp_ = (tfm.lm_head(cfg, params["embed"],
                               tfm.rmsnorm(params["final_norm"], y))[live]
                   for y in (xk, xp))
        if not (torch.isfinite(lk).all() and torch.isfinite(lp_).all()):
            raise AssertionError(f"non-finite logits at layer {i}")
        worst = max(worst, (lk - lp_).abs().max().item())
        x = xk
    return worst


def share_in_band(cfg, scores, vnorm, ksel, idx, mask, *, k, length,
                  n_total, budget, swapped):
    """The plain SOCKET top-k ``(idx, mask)`` of ``scores`` against the
    kernel route's selection ``ksel`` (B, KVH, N) bool.  Where the two
    differ only at rows whose plain effective score lies within SCORE_TOL
    of the top-k threshold (the kernel check's band: both sum the same
    fp32 terms in other orders), returns the kernel's selection and
    appends the count of differing rows to ``swapped``; a difference
    outside the band raises."""
    from repro_torch.core import socket as sk
    if ksel.shape != scores.shape or scores.shape[-1] != n_total:
        raise AssertionError(f"kernel selection {tuple(ksel.shape)} vs "
                             f"plain scores {tuple(scores.shape)}")
    psel = torch.zeros_like(ksel).scatter_(-1, idx, mask)
    diff = psel != ksel
    if not bool(diff.any()):
        return idx, mask
    # the plain effective scores and the k-th largest, as value_aware_topk
    # ranks them
    pos = torch.arange(n_total, device=scores.device)
    ln = sk.per_batch(length, scores.ndim)
    eff = scores.float() * vnorm.float()
    eff = torch.where((pos < cfg.sink_tokens) |
                      (pos >= ln - cfg.window_tokens), sk.FLT_MAX, eff)
    eff = torch.where(pos < ln, eff, sk.NEG_INF)
    top = torch.as_tensor(k if budget is None else budget,
                          device=scores.device).long().clamp(1, k) - 1
    top = top.reshape(-1, 1, 1).expand(*scores.shape[:2], 1)
    thr = torch.sort(eff, dim=-1, descending=True).values.gather(-1, top)
    close = (eff - thr).abs() <= SCORE_TOL["atol"] + \
        SCORE_TOL["rtol"] * thr.abs()
    if bool((diff & ~close).any()) or int(ksel.sum(-1).max()) > k:
        raise AssertionError("the plain and kernel SOCKET selections "
                             "differ outside the threshold band")
    swapped.append(int(diff.sum().item()))
    vals, order = torch.sort(ksel.int(), dim=-1, descending=True,
                             stable=True)
    return order[..., :k], vals[..., :k].bool()


@contextlib.contextmanager
def socket_ties_shared(swapped):
    """While active, each call of the fused paged SOCKET kernel keeps its
    selection, and the plain SOCKET top-k (``core.socket.
    value_aware_topk``) of the call it pairs with (the same layer: calls
    pair in order) is held to it by :func:`share_in_band`."""
    from repro_torch.core import socket as sk
    from repro_torch.kernels.paged_attention import ops as pa
    kernel, topk = pa.paged_socket_attend, sk.value_aware_topk
    pending, inside = collections.deque(), []

    def spy(*args, **kw):
        inside.append(True)     # a plain version of the kernel (CPU
        try:                    # tensors) ranks with the real top-k
            out, sel = kernel(*args, with_selection=True, **kw)
        finally:
            inside.pop()
        pending.append(sel)
        return out

    def shared_topk(cfg, scores, vnorm, *, k, length, n_total, budget=None):
        idx, mask = topk(cfg, scores, vnorm, k=k, length=length,
                         n_total=n_total, budget=budget)
        if inside:
            return idx, mask
        if not pending:
            raise AssertionError("a plain SOCKET top-k with no kernel call "
                                 "to pair with")
        ksel = pending.popleft()
        ksel = ksel.reshape(*ksel.shape[:2], -1).bool()
        return share_in_band(cfg, scores, vnorm, ksel, idx, mask, k=k,
                             length=length, n_total=n_total, budget=budget,
                             swapped=swapped)

    with mock.patch.object(pa, "paged_socket_attend", spy), \
            mock.patch.object(sk, "value_aware_topk", shared_topk):
        yield
    if pending:
        raise AssertionError(f"{len(pending)} kernel SOCKET calls with no "
                             "plain top-k to pair with")


@contextlib.contextmanager
def static_ties_shared(swapped):
    """The static path's step-0 gate: while active, the SOCKET top-k
    (``core.socket.value_aware_topk``) calls made before the yielded
    ``to_plain()`` is called are the kernel route's (``socket_score``'s
    scores) and keep their selections; each call after it is the plain
    route's, pairs in order with one of them (the same layer) and is held
    to it by :func:`share_in_band`."""
    from repro_torch.core import socket as sk
    topk = sk.value_aware_topk
    kept, plain = collections.deque(), []

    def shared_topk(cfg, scores, vnorm, *, k, length, n_total, budget=None):
        idx, mask = topk(cfg, scores, vnorm, k=k, length=length,
                         n_total=n_total, budget=budget)
        if not plain:
            kept.append(torch.zeros(scores.shape, dtype=torch.bool,
                                    device=scores.device)
                        .scatter_(-1, idx, mask))
            return idx, mask
        if not kept:
            raise AssertionError("a plain SOCKET top-k with no kernel-route "
                                 "top-k to pair with")
        return share_in_band(cfg, scores, vnorm, kept.popleft(), idx, mask,
                             k=k, length=length, n_total=n_total,
                             budget=budget, swapped=swapped)

    with mock.patch.object(sk, "value_aware_topk", shared_topk):
        yield lambda: plain.append(True)
    if kept:
        raise AssertionError(f"{len(kept)} kernel-route SOCKET top-k calls "
                             "with no plain top-k to pair with")


# An MoE token's route may differ between two routes of one computation
# (kernel and plain attention feed the router inputs a few ulps apart) only
# where its k-th and (k+1)-th router probabilities are this close: then the
# plain route takes the kernel route's experts (``moe_routes_shared``).
ROUTE_TOL = dict(rtol=1e-5, atol=1e-7)


@contextlib.contextmanager
def moe_routes_shared(swapped):
    """The MoE counterpart of :func:`static_ties_shared`: while active,
    the router calls (``models.moe._router``) made before the yielded
    ``to_plain()`` is called are the kernel route's and keep their expert
    choices; each call after it is the plain route's and pairs in order
    with one of them (the same layer).  Where the two choices differ only
    at tokens whose plain probabilities at the choice boundary (the k-th
    and (k+1)-th largest) lie within ROUTE_TOL of each other, the plain
    route takes the kernel route's experts, weighted by its own
    probabilities, and the count of such tokens is appended to
    ``swapped``; any other difference raises.  A model without MoE layers
    never calls the router."""
    from repro_torch.models import moe
    router = moe._router
    kept, plain = collections.deque(), []

    def shared(cfg, params, x2d):
        idx, probs, aux = router(cfg, params, x2d)
        if not plain:
            kept.append(idx)
            return idx, probs, aux
        if not kept:
            raise AssertionError("a plain MoE routing with no kernel-route "
                                 "routing to pair with")
        kidx = kept.popleft()
        diff = (torch.sort(idx, -1).values !=
                torch.sort(kidx, -1).values).any(-1)
        if not bool(diff.any()):
            return idx, probs, aux
        full = torch.softmax(x2d.float() @ params["router"].float(), -1)
        k = cfg.num_experts_per_tok
        top = torch.sort(full[diff], -1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).abs()
        if bool((gap > ROUTE_TOL["atol"] +
                 ROUTE_TOL["rtol"] * top[:, k - 1]).any()):
            raise AssertionError("the plain and kernel routes send MoE "
                                 "tokens to other experts outside the "
                                 "probability band")
        swapped.append(int(diff.sum().item()))
        p = full.gather(-1, kidx)
        return kidx, p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9), aux

    with mock.patch.object(moe, "_router", shared):
        yield lambda: plain.append(True)
    if plain and kept:
        raise AssertionError(f"{len(kept)} kernel-route MoE routings with "
                             "no plain routing to pair with")


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    for c in FUSED.values():
        setattr(pa, c[1], 0)
    ss.LAUNCHES = fd.LAUNCHES = pa.RING_LAUNCHES = fp.LAUNCHES = 0


def read_launches() -> dict:
    """Every kernel's launches since :func:`reset_launches`, by row name."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    launches = {c[0]: getattr(pa, c[1]) for c in FUSED.values()}
    launches.update(socket_score=ss.LAUNCHES, flash_decode=fd.LAUNCHES,
                    paged_ring=pa.RING_LAUNCHES, flash_prefill=fp.LAUNCHES)
    return launches


def launch_gate(label, launches, name, layers, calls) -> None:
    """The paged kernel ``name`` launched exactly ``layers`` x ``calls``
    times, and no other kernel at all."""
    if launches[name] != layers * calls:
        raise AssertionError(f"{label}: {name} launched {launches[name]} "
                             f"times, expected {layers * calls} ({layers} "
                             f"layers x {calls} calls)")
    others = {k: v for k, v in launches.items() if k != name and v}
    if others:
        raise AssertionError(f"{label}: other kernels ran: {others}")


def kv_block_bytes(pages):
    """Bytes of the K/V leaves (scales included) one block id holds
    across all layers: as stored, and as ``auto`` (f32) would store
    them."""
    names = ("k", "v", "k_scale", "v_scale")
    stored = sum(layer[n][0].numel() * layer[n].element_size()
                 for layer in pages for n in names if n in layer)
    auto = sum(2 * layer["k"][0].numel() * 4 for layer in pages
               if "k" in layer)
    return stored, auto


def compact_pool(cfg, pages, bt):
    """A copy of the blocks of the pool ``pages`` that the block tables
    ``bt`` (trash-padded) name, the trash block 0 first, and ``bt``
    renumbered onto it, with a copy of every state (Mamba) layer's slot
    rows whole (the step moves them on in place): a decode step over the
    copy computes what it would over the pool, for the bytes of the
    batch's blocks alone (the pool of gemma-7b's f32 case, 23.5 GB, and a
    clone of it do not fit beside its 37.3 GB of weights)."""
    from repro_torch.serving.paged import raw_view
    ids = torch.unique(torch.cat([torch.zeros(1, dtype=bt.dtype,
                                              device=bt.device),
                                  bt.flatten()]))
    renumber = torch.zeros(cfg.serving.num_blocks, dtype=bt.dtype,
                           device=bt.device)
    renumber[ids.long()] = torch.arange(len(ids), dtype=bt.dtype,
                                        device=bt.device)
    copy = [{k: v.clone() for k, v in layer.items()}
            if cfg.plan_for(spec).kind == "state" else
            {k: raw_view(v)[ids.long()].view(v.dtype)
             for k, v in layer.items()}
            for spec, layer in zip(cfg.layer_specs, pages)]
    return copy, renumber[bt.long()]


def pool_block_bytes_check(cfg, pages) -> int:
    """The bytes one block id holds in every leaf of the engine's pool
    ``pages`` (state layers' slot rows are no block's), which must equal
    ``serving.paged.pool_block_bytes``'s ``per_block_id`` (the accounting
    the serving benchmark reads)."""
    from repro_torch.serving.paged import pool_block_bytes
    held = sum(leaf[0].numel() * leaf.element_size()
               for spec, layer in zip(cfg.layer_specs, pages)
               if cfg.plan_for(spec).kind != "state"
               for leaf in layer.values())
    want = pool_block_bytes(cfg)["per_block_id"]
    if held != want:
        raise AssertionError(f"a block id holds {held} B in the pool, "
                             f"pool_block_bytes reckons {want}")
    return held


def phase_continuous(dev, seed, card, params, backend, arch="llama31-8b",
                     kv_dtype="auto", ref_tokens=None, legacy=False,
                     num_groups=None, after=None, numerics="f32"):
    """One continuous run of ``arch`` with ``backend`` on K/V pages stored
    as ``kv_dtype`` (see the module docstring, phases 5 to 7 and 5e), on
    the card case's weights ``params``; ``legacy``: whole-prompt bucketed
    prefill; ``num_groups``: the depth cut to that many groups, on the
    first layers of ``params``.  ``ref_tokens``: (label, the generated
    tokens of another run of the same case), whose agreement with this
    run's is logged (a number, not a gate).  ``after(engine, reqs)``: a
    further check of the finished run.  ``numerics`` "bf16": the
    deployment's (phase 5f), where the captured iteration's kernel and
    plain routes are held to a float32 run of it on the same weights.
    Returns (the launches of the kernels the run is read for, the
    generated tokens, the run's wall seconds)."""
    import numpy as np
    from repro_torch.launch.serve import card_config, card_continuous_case
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving.engine import ContinuousBatchingEngine

    new_tokens = 32
    name, counter, gate = FUSED[backend]
    full = card_config(arch, numerics)
    cfg, reqs = card_continuous_case(full, seed, new_tokens, backend,
                                     kv_dtype, legacy=legacy)
    if num_groups is not None:
        cfg = cfg.replace(num_groups=num_groups)
        params = dict(params, layers=params["layers"][:cfg.num_layers])
    sv = cfg.serving
    kinds = layer_kinds(cfg)
    # kernel -> layers it runs on
    layers = {name: kinds.count("global")}
    if cfg.use_ring_kernel:
        layers["paged_ring"] = kinds.count("local")
    if legacy:
        layers["flash_prefill"] = len(kinds) - kinds.count("mamba")
    engine = ContinuousBatchingEngine(cfg, params=params, device=dev)
    block_bytes, block_bytes_auto = kv_block_bytes(engine.pages)
    pool_bytes = pool_block_bytes_check(cfg, engine.pages)
    # the widest decode batch of the run, captured with a copy of the
    # pool's blocks it reads and of its state rows for the kernel-vs-plain
    # check below (never an iteration whose next decode opens a block:
    # every write then lands in a real page)
    snap = {}

    def hook(eng, it):
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) <= len(snap.get("reqs", ())) or any(
                r.done or eng.scheduler._blocks_for(r.pos + 1) >
                len(r.blocks) for r in running):
            return
        snap.pop("pages", None)          # the last capture's, before this
        tokens, bt, pos = eng._batch_inputs(running)
        pages, bt = compact_pool(cfg, eng.pages, bt)
        snap.update(reqs=[r.rid for r in running], iteration=it,
                    inputs=(tokens, bt, pos), pages=pages)

    engine.iter_hook = hook
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    engine.warmup(reqs)
    warm_s = time.perf_counter() - t0
    m = engine.run(reqs, realtime=False)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [r.rid for r in reqs if r.state != "finished"
           or len(r.generated) != new_tokens]
    if bad:
        raise AssertionError(f"{backend}: requests {bad} did not finish "
                             f"with {new_tokens} tokens")
    # decode calls: the engine's iterations + the warm-up's decode step
    # (chunked: + its mixed step); whole-prompt prefills: the run's + one
    # a warm-up bucket
    warm_prefills = sum(k.startswith("prefill_") for k in engine.warmup_s)
    warm_steps = len(engine.warmup_s) - warm_prefills
    calls = {k: m.decode_iters + warm_steps for k in layers}
    if legacy:
        calls["flash_prefill"] = len(engine.prefill_trace) + warm_prefills
        if len(engine.prefill_trace) != len(reqs):
            raise AssertionError(f"{len(engine.prefill_trace)} whole-prompt "
                                 f"prefills for {len(reqs)} requests")
    expected = {k: n * calls[k] for k, n in layers.items()}
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(
                f"{k}: {launches[k]} launches, expected {want} ({layers[k]} "
                f"layers x {calls[k]} calls)")
    others = {k: v for k, v in launches.items() if k not in layers and v}
    if others:
        raise AssertionError(f"{backend}: other kernels ran on its paged "
                             f"path: {others}")
    if m.preemptions:
        raise AssertionError(f"{m.preemptions} preemptions in a pool sized "
                             "to need none")
    if after is not None:
        after(engine, reqs)
    # offline run: every request arrives at the run's start, and the
    # engine stamps no TTFT (0); take it from the first token's wall time
    first = np.array([r.token_walls[0] for r in reqs])
    report = dict(m.to_json(), ttft_s_mean=float(first.mean()),
                  ttft_s_p99=float(np.percentile(first, 99)))
    generated = [list(r.generated) for r in reqs]
    if ref_tokens is not None:
        label, tokens = ref_tokens
        same = np.array(generated) == np.array(tokens)
        report.update({
            f"tokens_equal_to_{label}": f"{int(same.sum())}/{same.size}",
            f"identical_prefix_with_{label}": [int(np.cumprod(row).sum())
                                               for row in same],
            f"first_parting_with_{label}": first_parting(generated,
                                                         tokens)})
    if legacy:
        per_bucket = {}
        for _, _, bucket, secs in engine.prefill_trace:
            per_bucket.setdefault(bucket, []).append(secs)
        prompt_len = {r.rid: len(r.prompt) for r in reqs}
        padded = [1 - prompt_len[rid] / bucket
                  for _, rid, bucket, _ in engine.prefill_trace]
        report.update(prefill_buckets=list(sv.prefill_buckets),
                      prefill_s_by_bucket={b: v for b, v in
                                           sorted(per_bucket.items())},
                      prefill_padded_share=padded,
                      warmup_call_s=engine.warmup_s)
    log(json.dumps({
        "continuous_path": arch, "numerics": numerics, "backend": backend,
        "kv_dtype": kv_dtype,
        "prefill": "whole-prompt buckets" if legacy else "chunked",
        "kv_bytes_per_block_id": block_bytes,
        "kv_bytes_per_block_id_auto": block_bytes_auto,
        "pool_bytes_per_block_id": pool_bytes,
        "use_ring_kernel": cfg.use_ring_kernel,
        "layers": cfg.num_layers, "reduced": (
            None if cfg.num_groups == full.num_groups else
            f"num_groups {cfg.num_groups} of {full.num_groups}: "
            f"{cfg.num_layers} of {full.num_layers} layers"),
        "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
        "max_new_tokens": new_tokens, "prefill_chunk": sv.prefill_chunk,
        "num_blocks": sv.num_blocks, "warmup_s": warm_s,
        **report, "max_memory_allocated_bytes": peak,
        "launches": launches, "expected_launches": expected,
        "card": card}))

    # one decode iteration of the captured state, kernel vs plain path
    if "pages" not in snap:
        raise AssertionError("no decode iteration was captured")
    engine.pages = None                                   # free the pool
    del engine
    tokens, bt, pos = snap["inputs"]
    plain_pages = snap.pop("pages")
    clone = lambda pool: [{k: v.clone() for k, v in layer.items()}  # noqa
                          for layer in pool]
    kernel_pages = clone(plain_pages)
    cfg_plain = cfg.replace(use_ring_kernel=False, **{
        gate: dataclasses.replace(getattr(cfg, gate),
                                  use_paged_kernel=False)})
    live = pos > 0                   # idle slots decode the trash page
    lf = None
    if is_bf16(cfg):
        cfg_plain = kernel_scoring(cfg_plain)
        torch.cuda.empty_cache()     # room for a widened expert stack
        lf, _ = make_serve_step(f32_reference(cfg))(
            params, widened(plain_pages), tokens, pos, bt)
        lf = lf[live]
    forced, swapped, rerouted = None, [], []
    with (paired(socket_ties_shared, cfg, swapped)
          if backend == "socket_fused" else contextlib.nullcontext()):
        if kv_dtype != "auto":
            forced = forced_logits_err(cfg, cfg_plain, params, kernel_pages,
                                       clone(plain_pages), tokens, pos, bt,
                                       live)
            kernel_pages = clone(plain_pages)
        with paired(moe_routes_shared, cfg, rerouted) as moe_to_plain:
            lk, _ = make_serve_step(cfg)(params, kernel_pages, tokens, pos,
                                         bt)
            del kernel_pages
            moe_to_plain()
            lp, _ = make_serve_step(cfg_plain)(params, plain_pages, tokens,
                                               pos, bt)
            del plain_pages
    lk, lp = lk[live], lp[live]
    for label, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {label} path")
    err = (lk - lp).abs().max().item()
    same = (lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
    log(f"{arch} continuous{' legacy' if legacy else ''} decode iteration "
        f"{snap['iteration'] + 1} ({len(snap['reqs'])} requests), {backend} "
        f"on {kv_dtype} pages, "
        f"kernels vs plain paged path: max|logits err| {err:.3e} "
        + ("(not a gate at bf16: held to float32 below; " if lf is not None
           else f"(atol {LOGITS_ATOL}; " if forced is None else
           "(not a gate: the two routes' rows round to the quantization "
           f"grid apart; layer by layer, teacher-forced: {forced:.3e}, "
           f"atol {LOGITS_ATOL}; ")
        + f"max|logits| {lp.abs().max().item():.3f}); greedy tokens "
        f"shared {int(same.sum().item())}/{same.numel()}"
        + ("" if backend != "socket_fused" else
           f"; SOCKET rows inside the top-k threshold band that the plain "
           f"path took from the kernel's selection: {sum(swapped)} in "
           f"{len(swapped)} calls")
        + ("" if not cfg.uses_moe else
           f"; MoE tokens the plain path sent to the kernel path's "
           f"experts: {sum(rerouted)}"))
    if lf is not None:
        f32_distance_check(f"{arch} {backend} bf16 decode iteration", lk,
                           lp, lf)
        return {k: launches[k] for k in layers}, generated, m.wall_s
    gated = err if forced is None else forced
    if gated > LOGITS_ATOL:
        raise AssertionError(f"{arch} {backend} {kv_dtype}: continuous "
                             f"logits differ by {gated:.3e} > {LOGITS_ATOL}")
    return {k: launches[k] for k in layers}, generated, m.wall_s


# ------------------------------------------------------------ prefix phase

class SharedPagesFrozen:
    """The prefix phase's ``iter_hook``: the CoW invariant of the JAX
    package's ``test_cow_invariant_shared_pages_bitwise_frozen``.  Every
    page shared (pool refcount > 1) at an iteration's end must be bitwise
    equal, in every leaf of every layer, to its copy taken at the first
    iteration end it was seen shared (the iteration that indexed or
    matched it); a page that stops being shared is dropped.  The copies
    live in a mirror of the pool."""

    def __init__(self, engine):
        from repro_torch.serving import paged
        self.raw = paged.raw_view
        self.mirror = [{k: torch.empty_like(self.raw(v))
                        for k, v in layer.items()} for layer in engine.pages]
        self.frozen = set()
        self.checked = 0          # (page, iteration) pairs held equal
        self.most = 0             # most pages shared at once

    def __call__(self, eng, _it):
        pool = eng.pool
        shared = {b for b in range(1, pool.num_blocks) if pool.is_shared(b)}
        self.frozen &= shared
        fresh = shared - self.frozen
        old, new = (torch.tensor(sorted(b), dtype=torch.long,
                                 device=eng.device)
                    for b in (self.frozen, fresh))
        for i, (layer, mirror) in enumerate(zip(eng.pages, self.mirror)):
            for k, leaf in layer.items():
                raw = self.raw(leaf)
                if len(old) and not torch.equal(raw[old], mirror[k][old]):
                    raise AssertionError(f"a shared page was written in "
                                         f"place (layer {i}, leaf {k})")
                if len(new):
                    mirror[k][new] = raw[new]
        self.checked += len(old)
        self.frozen |= fresh
        self.most = max(self.most, len(shared))


@contextlib.contextmanager
def clone_spy(clones):
    """While active, each copy-on-write clone the engine makes
    (``serving.paged.clone_block``) is timed on the host (synchronized
    before and after) and checked: in every leaf of every layer the rows
    past ``keep`` hold the leaf's fill value and the rows before it the
    source page's.  Appends ``dict(ms, keep, leaves)`` to ``clones``."""
    from repro_torch.models import backends as bk
    from repro_torch.serving import paged
    real = paged.clone_block

    def spy(cfg, pages, src, dst, keep):
        sync = torch.cuda.synchronize if pages[0]["k"].is_cuda else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = real(cfg, pages, src, dst, keep)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        ok, names = [], set()
        for spec, layer in zip(cfg.layer_specs, pages):
            leaves = bk.layer_cache_handler(cfg, spec).spec(cfg).leaves
            for name, leaf in layer.items():
                raw = paged.raw_view(leaf)
                fill = paged.raw_view(torch.full(
                    (), leaves[name].fill, dtype=leaf.dtype,
                    device=leaf.device))
                ok += [(raw[dst, :, keep:] == fill).all(),
                       (raw[dst, :, :keep] == raw[src, :, :keep]).all()]
                names.add(name)
        if not bool(torch.stack(ok).all()):
            raise AssertionError(f"clone of page {src} into {dst} (keep "
                                 f"{keep}): rows past keep not at the fill "
                                 "value, or rows before it not the source's")
        clones.append(dict(ms=ms, keep=keep, leaves=sorted(names)))
        return out

    with mock.patch.object(paged, "clone_block", spy):
        yield


def first_parting(a, b):
    """(request, token) where two runs' token lists first differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for t, (p, q) in enumerate(zip(x, y)):
            if p != q:
                return i, t
    return None


def free_engine(engine) -> None:
    engine.iter_hook = None
    engine.pages = None
    gc.collect()
    torch.cuda.empty_cache()


def cut_depth(cfg, params, num_groups):
    """``cfg`` and ``params`` cut to their first ``num_groups`` groups
    (None: as they are)."""
    if num_groups is None:
        return cfg, params
    cfg = cfg.replace(num_groups=num_groups)
    return cfg, dict(params, layers=params["layers"][:cfg.num_layers])


def phase_prefix(dev, seed, card, params, backend, kv_dtype="auto",
                 num_groups=None) -> dict:
    """The prefix phase for ``backend`` on ``kv_dtype`` pages (see the
    module docstring): the RAG traffic of ``card_prefix_case`` cold (cache
    off), then warm (cache on: the shared template served alone first,
    then the 8 requests, ``SharedPagesFrozen`` and ``clone_spy`` on), at
    ``num_groups`` groups.  Returns the launches of each run's paged
    kernel."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import PREFIX_CASE, card_prefix_case
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine

    new_tokens = 16
    name = FUSED[backend][0]
    cfg, template, prompts = card_prefix_case(get_config("llama31-8b"),
                                              seed, new_tokens, backend,
                                              kv_dtype)
    cfg, params = cut_depth(cfg, params, num_groups)
    bs = cfg.serving.block_size
    tail = backend != "quest_fused"      # Quest's bounds: page-aligned
    matched = PREFIX_CASE["template"] if tail else \
        PREFIX_CASE["template"] // bs * bs
    label = f"prefix phase ({backend}, {kv_dtype})"
    runs = {}
    for warm in (False, True):
        run_cfg = cfg if warm else cfg.replace(
            serving=cfg.serving.replace(prefix_cache=False))
        engine = ContinuousBatchingEngine(run_cfg, params=params, device=dev)
        reset_launches()
        engine.warmup()
        iters, clones, frozen, prime = 0, [], None, None
        with clone_spy(clones):
            if warm:
                prime = Request(prompt=list(template),
                                max_new_tokens=new_tokens)
                mp = engine.run([prime], realtime=False)
                iters += mp.decode_iters
                if engine.prefix_cache.index.num_tail_blocks != int(tail):
                    raise AssertionError(
                        f"{label}: the template indexed "
                        f"{engine.prefix_cache.index.num_tail_blocks} tail "
                        f"pages, expected {int(tail)}")
                frozen = SharedPagesFrozen(engine)
                engine.iter_hook = frozen
            reqs = [Request(prompt=list(p), max_new_tokens=new_tokens)
                    for p in prompts]
            m = engine.run(reqs, realtime=False)
        torch.cuda.synchronize()
        iters += m.decode_iters
        launches = read_launches()
        launch_gate(label, launches, name, cfg.num_layers,
                    iters + len(engine.warmup_s))
        bad = [r.rid for r in reqs + ([prime] if prime else [])
               if r.state != "finished" or len(r.generated) != new_tokens]
        if bad or m.preemptions:
            raise AssertionError(f"{label}: requests {bad} unfinished, "
                                 f"{m.preemptions} preemptions")
        reg = engine.registry
        first = np.array([r.token_walls[0] for r in reqs])
        runs[warm] = dict(
            tokens=[list(r.generated) for r in reqs],
            prefill_chunks=m.prefill_chunks, decode_iters=m.decode_iters,
            wall_s=m.wall_s, ttft_s_mean=float(first.mean()),
            ttft_s_p99=float(np.percentile(first, 99)),
            hits=reg.value("prefix_cache_hits_total"),
            cached_tokens=reg.value("prefix_cache_cached_tokens_total"),
            cow=reg.value("prefix_cache_cow_total"),
            clones=clones, launches={name: launches[name]},
            expected_launches={name: cfg.num_layers * (
                iters + len(engine.warmup_s))})
        if warm:
            runs[warm].update(template_chunks=mp.prefill_chunks,
                              shared_pages_checked=frozen.checked,
                              most_pages_shared=frozen.most)
        free_engine(engine)
        del engine
    cold, warm = runs[False], runs[True]
    clone_ms = [c["ms"] for c in warm["clones"]]
    log(json.dumps({
        "prefix_path": "llama31-8b", "backend": backend,
        "kv_dtype": kv_dtype, "requests": len(prompts),
        "prompt_len": PREFIX_CASE["prompt_len"],
        "template_len": PREFIX_CASE["template"],
        "max_new_tokens": new_tokens,
        "prefill_chunk": cfg.serving.prefill_chunk,
        "num_blocks": cfg.serving.num_blocks,
        "cold": {k: v for k, v in cold.items() if k != "tokens"},
        "warm": {k: v for k, v in warm.items() if k != "tokens"},
        "chunks_saved": cold["prefill_chunks"] - warm["prefill_chunks"],
        "clone_host_ms": clone_ms, "card": card}))
    parted = first_parting(cold["tokens"], warm["tokens"])
    if parted is not None:
        raise AssertionError(f"{label}: warm tokens part from cold at "
                             f"request {parted[0]}, token {parted[1]}")
    n = len(prompts)
    if warm["hits"] < n - 1 or warm["cached_tokens"] < (n - 1) * matched:
        raise AssertionError(f"{label}: {warm['hits']} hits, "
                             f"{warm['cached_tokens']} cached tokens; "
                             f"expected >= {n - 1} and >= {(n - 1) * matched}")
    if (warm["cow"] >= 1) != tail or len(clone_ms) != warm["cow"]:
        raise AssertionError(f"{label}: {warm['cow']} copy-on-write clones "
                             f"({len(clone_ms)} seen): expected " +
                             ("at least 1" if tail else "none"))
    if warm["shared_pages_checked"] == 0:
        raise AssertionError(f"{label}: no shared page was held across "
                             "iterations")
    scales = {"k_scale", "v_scale"}
    if kv_dtype == "int8" and not all(scales <= set(c["leaves"])
                                      for c in warm["clones"]):
        raise AssertionError(f"{label}: a clone did not reach the scale "
                             "leaves")
    log(f"{label}: warm tokens equal the cold run's "
        f"({n} x {new_tokens}); {warm['hits']} hits, "
        f"{warm['cached_tokens']} cached tokens, {warm['cow']} clones"
        + (f" ({min(clone_ms):.2f}-{max(clone_ms):.2f} host ms each)"
           if clone_ms else "") +
        f"; chunks {cold['prefill_chunks']} cold, {warm['prefill_chunks']} "
        f"warm (+{warm['template_chunks']} for the template); TTFT mean "
        f"{cold['ttft_s_mean']:.3f} s cold, {warm['ttft_s_mean']:.3f} s warm;"
        f" {warm['shared_pages_checked']} shared-page checks, at most "
        f"{warm['most_pages_shared']} pages shared")
    suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
    return {f"{name}{suffix}[prefix {k}]": runs[w]["launches"][name]
            for k, w in (("cold", False), ("warm", True))}


# ----------------------------------------------------- observability phase

OBS_PROBE_EVERY = 8
OBS_PROFILE_STEPS = 4


def profiled_kernel_events(trace: dict, kernel: str) -> int:
    """Device kernel events of a ``torch.profiler`` Chrome trace whose
    (demangled or mangled) name holds ``kernel``."""
    return sum(1 for e in trace.get("traceEvents", ())
               if e.get("cat") == "kernel" and kernel in e.get("name", ""))


def window_steps(events) -> list:
    """The ``step`` events between the trace's ``profile_start`` and
    ``profile_stop`` events."""
    kinds = [e["ev"] for e in events]
    if kinds.count("profile_start") != 1 or kinds.count("profile_stop") != 1:
        raise AssertionError(f"{kinds.count('profile_start')} profile_start "
                             f"and {kinds.count('profile_stop')} "
                             "profile_stop events, expected one of each")
    lo, hi = kinds.index("profile_start"), kinds.index("profile_stop")
    return [e for e in events[lo:hi] if e["ev"] == "step"]


def trace_check(label, events, reqs, iterations) -> None:
    """Every request's lifecycle (submit, admit, first_token, finish) is
    in the trace and the step events number 0..iterations-1."""
    rids = sorted(r.rid for r in reqs)
    for kind in ("submit", "admit", "first_token", "finish"):
        got = sorted(e["rid"] for e in events if e["ev"] == kind)
        if got != rids:
            raise AssertionError(f"{label}: {kind} events for requests "
                                 f"{got}, expected {rids}")
    steps = [e["iter"] for e in events if e["ev"] == "step"]
    if steps != list(range(iterations)):
        raise AssertionError(f"{label}: step events {steps[:8]}... do not "
                             f"number 0..{iterations - 1}")


def probe_rows_check(label, rows, events, layers, every) -> None:
    """A row for each of ``layers`` layers at every iteration the probe
    was due with a decode batch (``every``), and each row in range:
    recall in [0, 1], 0 < budget utilization <= 1, 0 < selected <=
    budget <= static k."""
    due = {e["iter"] for e in events if e["ev"] == "step"
           and e["iter"] % every == 0 and e["occupancy"] > 0}
    by_iter = collections.defaultdict(list)
    for r in rows:
        by_iter[r["iter"]].append(r["layer"])
    if set(by_iter) != due or not due:
        raise AssertionError(f"{label}: probed iterations "
                             f"{sorted(by_iter)}, expected {sorted(due)}")
    for it, got in by_iter.items():
        if sorted(got) != list(range(layers)):
            raise AssertionError(f"{label}: iteration {it} probed layers "
                                 f"{sorted(got)}, expected 0..{layers - 1}")
    for r in rows:
        if not (0.0 <= r["recall"] <= 1.0
                and 0.0 < r["budget_utilization"] <= 1.0
                and 0 < r["selected_mean"] <= r["budget_mean"]
                <= r["static_k"]):
            raise AssertionError(f"{label}: probe row out of range: {r}")


def phase_observability(dev, seed, card, params, f32_runs,
                        num_groups=None) -> dict:
    """Phase 5c (see the module docstring): ``socket_fused`` fully
    observed, then ``hard_lsh_fused`` and ``quest_fused`` with the probe,
    at ``num_groups`` groups (the depth of the phase-5 runs);
    ``f32_runs``: each backend's phase-5 f32 (tokens, wall seconds).
    Returns each run's paged-kernel launches."""
    import os
    import tempfile

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.obs import Observability, Profiler, events

    class WindowProfiler(Profiler):
        """The engine's profiler, reading the paged SOCKET kernel's launch
        counter as its window opens and as it closes."""
        launches = ()

        def maybe_start(self, iteration, tracer=None):
            was = self.active
            super().maybe_start(iteration, tracer)
            if self.active and not was:
                self.launches = [pa.LAUNCHES]

        def stop(self, tracer=None):
            if self.active:
                self.launches.append(pa.LAUNCHES)
            super().stop(tracer)

    new_tokens = 32
    full = get_config("llama31-8b")
    out, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("socket_fused", "hard_lsh_fused", "quest_fused"):
            t0 = time.perf_counter()
            name = FUSED[backend][0]
            label = f"observability phase ({backend})"
            cfg, reqs = card_continuous_case(full, seed, new_tokens, backend)
            if num_groups is not None:
                cfg = cfg.replace(num_groups=num_groups)
            layers = cfg.num_layers
            traced = backend == "socket_fused"
            trace_path = os.path.join(tmp, f"{backend}.jsonl")
            prof_dir = os.path.join(tmp, "prof")
            # the first decode-only iteration: every chunk before it
            start = sum(-(-len(r.prompt) // cfg.serving.prefill_chunk)
                        for r in reqs)
            obs = Observability(trace_path if traced else None,
                                probe_every=OBS_PROBE_EVERY)
            if traced:
                obs.profiler = WindowProfiler(prof_dir,
                                              steps=OBS_PROFILE_STEPS,
                                              start_step=start)
            engine = ContinuousBatchingEngine(
                cfg, params=dict(params, layers=params["layers"][:layers]),
                device=dev, obs=obs)
            probe_s = []                 # each probe step's host seconds
            inner = engine._run_probe

            def run_probe(*args, inner=inner, probe_s=probe_s):
                probe_s.append(inner(*args))
                return probe_s[-1]

            engine._run_probe = run_probe
            reset_launches()
            engine.warmup(reqs)
            m = engine.run(reqs, realtime=False)
            torch.cuda.synchronize()
            obs.close()
            launches = read_launches()
            launch_gate(label, launches, name, layers,
                        m.decode_iters + len(engine.warmup_s))
            tokens = [list(r.generated) for r in reqs]
            want, phase5_wall = f32_runs[backend]
            if tokens != want:
                raise AssertionError(f"{label}: tokens part from phase 5's "
                                     f"at {first_parting(tokens, want)}")
            evs = obs.tracer.events
            probe_rows_check(label, obs.probe.rows, evs, layers,
                             OBS_PROBE_EVERY)
            if engine.registry.get("pool_blocks_used").value != 0:
                raise AssertionError(f"{label}: blocks still used at the end")
            row = obs.probe_summary()
            row.update(probe_ms=[1e3 * x for x in probe_s],
                       wall_s=m.wall_s, phase5_wall_s=phase5_wall,
                       decode_iters=m.decode_iters, launches=launches[name])
            if traced:
                with open(trace_path) as f:
                    if events.validate_jsonl(f) != evs:
                        raise AssertionError(f"{label}: the trace file "
                                             "differs from tracer.events")
                trace_check(label, evs, reqs, m.decode_iters)
                window = window_steps(evs)
                prof = obs.profiler
                with open(prof.trace_path) as f:
                    chrome = json.load(f)
                seen = profiled_kernel_events(chrome, "paged_socket_kernel")
                delta = prof.launches[1] - prof.launches[0]
                want_seen = layers * len(window)
                if not (seen == delta == want_seen):
                    raise AssertionError(
                        f"{label}: the profiler saw {seen} paged SOCKET "
                        f"kernels, the counter moved {delta}, expected "
                        f"{want_seen} ({layers} layers x {len(window)} "
                        "window iterations)")
                spans = collections.Counter(
                    e["name"] for e in chrome["traceEvents"]
                    if e.get("name") in ("mixed", "decode", "probe")
                    and e.get("cat") == "user_annotation")
                at = {e["ev"]: e["ts"] for e in evs
                      if e["ev"] in ("profile_start", "profile_stop")}
                before = next(e["ts"] for e in evs if e["ev"] == "step"
                              and e["iter"] == start - 1)
                outside = [e["step_s"] for e in evs if e["ev"] == "step"
                           and e["kind"] == "decode" and e not in window]
                row.update(
                    profile_start_step=start,
                    # the previous step's event to profile_start: the
                    # profiler's start; the window's end to profile_stop:
                    # its export
                    profile_start_s=at["profile_start"] - before,
                    profile_export_s=at["profile_stop"] - window[-1]["ts"],
                    window_step_s=[e["step_s"] for e in window],
                    decode_step_s_outside_mean=float(np.mean(outside)),
                    window_iterations=[e["iter"] for e in window],
                    window_kinds=[e["kind"] for e in window],
                    profiled_kernel_events=seen, annotations=dict(spans),
                    trace_events=len(evs),
                    trace_bytes=os.path.getsize(trace_path),
                    chrome_trace_bytes=os.path.getsize(prof.trace_path),
                    compile_s={e["fn"]: e["seconds"] for e in evs
                               if e["ev"] == "compile"})
            row["phase_s"] = time.perf_counter() - t0
            summary[backend] = row
            out[f"{name}[observability]"] = launches[name]
            free_engine(engine)
            del engine
    log(json.dumps({"observability_path": "llama31-8b",
                    "probe_every": OBS_PROBE_EVERY,
                    "weights": "random fp32 (seeded), not trained",
                    **summary, "card": card}))
    for backend, row in summary.items():
        log(f"observability phase ({backend}): probe on random fp32 "
            f"weights: recall {row['recall']}, budget utilization "
            f"{row['budget_utilization']}, forced share "
            f"{row['forced_share']} over {row['rows']} rows; probe step "
            f"{np.mean(row['probe_ms']):.1f} host ms (mean of "
            f"{len(row['probe_ms'])}); wall {row['wall_s']:.3f} s against "
            f"phase 5's {row['phase5_wall_s']:.3f} s")
    return out


# ---------------------------------------------------------- sampling phase

def phase_sampling(dev, seed, card, params, num_groups=None) -> dict:
    """The sampling phase (see the module docstring): phase 5's traffic
    through ``socket_fused`` at temperature 0.8, top-p 0.95, seeded from
    ``seed``, twice, then on the pool ``CARD_PREEMPT_BLOCKS`` names, which
    preempts; at ``num_groups`` groups.  Returns each run's paged-kernel
    launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (CARD_PREEMPT_BLOCKS,
                                          card_continuous_case)
    from repro_torch.serving.engine import ContinuousBatchingEngine

    new_tokens, temperature, top_p = 32, 0.8, 0.95
    full = get_config("llama31-8b")
    name = FUSED["socket_fused"][0]
    runs = {}
    for label, blocks in (("first", None), ("again", None),
                          ("preempting", CARD_PREEMPT_BLOCKS)):
        cfg, reqs = card_continuous_case(full, seed, new_tokens,
                                         num_blocks=blocks)
        cfg, run_params = cut_depth(cfg, params, num_groups)
        engine = ContinuousBatchingEngine(
            cfg, params=run_params, device=dev, temperature=temperature,
            top_p=top_p, sample_seed=seed)
        reset_launches()
        engine.warmup()
        m = engine.run(reqs, realtime=False)
        torch.cuda.synchronize()
        launches = read_launches()
        launch_gate(f"sampling phase ({label})", launches, name,
                    cfg.num_layers, m.decode_iters + len(engine.warmup_s))
        tokens = [list(r.generated) for r in reqs]
        if any(r.state != "finished" or len(t) != new_tokens
               for r, t in zip(reqs, tokens)):
            raise AssertionError(f"sampling phase ({label}): a request did "
                                 f"not finish with {new_tokens} tokens")
        if max(max(t) for t in tokens) >= cfg.vocab_size or \
                min(min(t) for t in tokens) < 0:
            raise AssertionError(f"sampling phase ({label}): an id outside "
                                 f"the vocabulary ({cfg.vocab_size})")
        runs[label] = dict(
            tokens=tokens, emitted=[list(r.sample_key.emitted) for r in reqs],
            preemptions=m.preemptions,
            preempted=[r.preemptions for r in reqs],
            decode_iters=m.decode_iters, prefill_chunks=m.prefill_chunks,
            wall_s=m.wall_s, num_blocks=cfg.serving.num_blocks,
            launches=launches[name])
        free_engine(engine)
        del engine
    first, again, hot = runs["first"], runs["again"], runs["preempting"]
    same = np.array(hot["tokens"]) == np.array(first["tokens"])
    log(json.dumps({
        "sampling_path": "llama31-8b", "backend": "socket_fused",
        "temperature": temperature, "top_p": top_p, "sample_seed": seed,
        "max_new_tokens": new_tokens, **{
            label: {k: v for k, v in r.items()
                    if k not in ("tokens", "emitted")}
            for label, r in runs.items()},
        "preempting_tokens_equal_to_first": f"{int(same.sum())}/{same.size}",
        "preempting_identical_prefix": [int(np.cumprod(row).sum())
                                        for row in same],
        "card": card}))
    if again["tokens"] != first["tokens"]:
        parted = first_parting(first["tokens"], again["tokens"])
        raise AssertionError("sampling phase: two runs with the same seed "
                             f"part at request {parted[0]}, token "
                             f"{parted[1]}")
    if hot["preemptions"] == 0:
        raise AssertionError("sampling phase: the cut pool did not preempt")
    if hot["emitted"] != first["emitted"] or any(
            e != list(range(new_tokens)) for e in first["emitted"]):
        raise AssertionError("sampling phase: an emitted token's draw index "
                             "differs from the unpreempted run's")
    log(f"sampling phase: same-seed runs identical ({same.size} tokens); "
        f"the {hot['num_blocks']}-block pool preempted "
        f"{hot['preemptions']} times (requests {hot['preempted']}), every "
        f"emitted token at the draw index of the unpreempted run; tokens "
        f"equal to the first run's {int(same.sum())}/{same.size} (not a "
        "gate: another batch composition reorders the device's sums)")
    return {f"{name}[sampling {label}]": r["launches"]
            for label, r in runs.items()}


# ------------------------------------------- all-global architectures

# int8 pages must hold this many times bf16's resident requests in the
# bf16 pool's byte budget (the serving benchmark's bar for quantized
# pages, benchmarks/bench_serving.py)
RESIDENCY_BAR = 1.8
GEMMA7B_RUNS = (("socket_fused", "auto"), ("hard_lsh_fused", "auto"),
                ("quest_fused", "auto"), ("socket_fused", "bf16"),
                ("socket_fused", "int8"), ("socket_fused", "fp8"))
# gemma-7b's continuous runs take its first 7 of 28 layers: with phase
# 11 the whole script ran 1036 s at full depth, against its 1050 s
# budget, and with phase 13 1044 s at 14 layers (its static run and the
# residency check keep full depth)
GEMMA7B_DEPTH = 7


def residency(block_bytes, pool_blocks, blocks_per_request) -> dict:
    """Requests of ``blocks_per_request`` blocks each that the byte
    budget of a ``pool_blocks``-block pool of bf16 pages holds when the
    pages are stored as each dtype of ``block_bytes`` (dtype -> bytes a
    block id)."""
    budget = pool_blocks * block_bytes["bf16"]
    return {k: int(budget // (blocks_per_request * v))
            for k, v in block_bytes.items()}


def residency_check(resident) -> float:
    """int8 pages must hold ``RESIDENCY_BAR`` x the resident requests of
    bf16 pages (:func:`residency`); returns the ratio."""
    ratio = resident["int8"] / resident["bf16"]
    if resident["int8"] < RESIDENCY_BAR * resident["bf16"]:
        raise AssertionError(
            f"int8 pages hold {resident['int8']} resident requests in the "
            f"bf16 pool's byte budget against {resident['bf16']} at bf16: "
            f"{ratio:.3f}x, below the {RESIDENCY_BAR}x bar")
    return ratio


def gemma7b_residency(seed, new_tokens=32) -> dict:
    """The residency of gemma-7b's continuous card case (its 1536-block
    pool of bf16 pages, requests of the case's mean context) at each page
    dtype, from ``pool_block_bytes``; logged, int8 held to the bar."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.serving.paged import pool_block_bytes
    block_bytes, pool_blocks, per_req = {}, None, None
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES:
        cfg, reqs = card_continuous_case(get_config("gemma-7b"), seed,
                                         new_tokens, kv_dtype=kv_dtype)
        block_bytes[kv_dtype] = pool_block_bytes(cfg)["per_block_id"]
        pool_blocks = cfg.serving.num_blocks
        mean_ctx = np.mean([len(r.prompt) for r in reqs]) + new_tokens
        per_req = -(-int(mean_ctx) // cfg.serving.block_size)
    resident = residency(block_bytes, pool_blocks, per_req)
    ratio = residency_check(resident)
    log(json.dumps({"gemma7b_residency": resident,
                    "pool_bytes_per_block_id": block_bytes,
                    "bf16_pool_blocks": pool_blocks,
                    "blocks_per_request": per_req,
                    "int8_over_bf16": ratio, "bar": RESIDENCY_BAR}))
    return resident


def card_memory(label, dev) -> None:
    """Logs this process's allocated and reserved device memory and the
    card's free memory (before ranks are spawned on the same card)."""
    free, total = torch.cuda.mem_get_info(dev)
    log(f"{label}: this process {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
        f"reserved; the card {free / 1e9:.2f} of {total / 1e9:.2f} GB free")


@contextlib.contextmanager
def phase_clock(label, dev):
    """Logs the seconds and the peak device memory of the phase run in
    its body."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"{label}: {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated")


def phase_all_global(dev, seed, card) -> dict:
    """Phase 5d (see the module docstring): gemma-7b through the static
    path, then its continuous runs (three fused backends on f32 pages,
    ``socket_fused`` on bf16, int8 and fp8), then minitron-8b's; each
    architecture's weights freed after it.  Returns the runs' launches,
    named ``kernel[arch ...]``."""
    launches = {}
    with phase_clock("gemma-7b static phase", dev):
        counts, params = phase_main(dev, seed, card, "gemma-7b")
    launches.update({f"{k}[gemma-7b static]": v for k, v in counts.items()})
    gemma7b_residency(seed)
    tokens = {}
    for backend, kv_dtype in GEMMA7B_RUNS:
        label = f"gemma-7b {backend}, {kv_dtype}"
        with phase_clock(f"continuous phase ({label})", dev):
            counts, tokens[backend, kv_dtype], _ = phase_continuous(
                dev, seed, card, params, backend, arch="gemma-7b",
                kv_dtype=kv_dtype, num_groups=GEMMA7B_DEPTH)
            gc.collect()
            torch.cuda.empty_cache()
        launches.update({f"{k}[gemma-7b {kv_dtype}]": v
                         for k, v in counts.items()})
    ref = tokens["socket_fused", "bf16"]
    for (backend, kv_dtype), toks in tokens.items():
        same = sum(a == b for x, y in zip(toks, ref) for a, b in zip(x, y))
        log(f"gemma-7b {backend} on {kv_dtype} pages, greedy tokens equal "
            f"to socket_fused on bf16 pages: {same}/{32 * len(ref)} (first "
            f"parting {first_parting(toks, ref)}; a number, not a gate)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = draw_params(dev, seed, "minitron-8b")
    with phase_clock("continuous phase (minitron-8b socket_fused, auto)",
                     dev):
        counts, _, _ = phase_continuous(dev, seed, card, params,
                                        "socket_fused", arch="minitron-8b")
    launches.update({f"{k}[minitron-8b auto]": v for k, v in counts.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"all_global_launches": launches}))
    return launches


def legacy_phase(dev, seed, card, params, arch, chunked, launches,
                 num_groups=None):
    """Phase 7 for ``arch``: the legacy whole-prompt prefill run (at
    ``num_groups`` groups: the depth of the chunked run it is read
    against), its tokens compared with the chunked f32 run's
    (``chunked[arch]``); its launches land in ``launches`` as
    ``name[legacy arch]``."""
    t0 = time.perf_counter()
    counts, _, _ = phase_continuous(dev, seed, card, params, "socket_fused",
                                    arch=arch, legacy=True,
                                    ref_tokens=("chunked", chunked[arch]),
                                    num_groups=num_groups)
    launches.update({f"{k}[legacy {arch}]": v for k, v in counts.items()})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"legacy phase ({arch}): {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase 5e

# mamba2's state carry (phase 5e): each request's logits of its last
# engine step (chunks of 512 = 4 x ssm_chunk carried through its slot's
# state rows, then 31 recurrent decode steps) against one whole-sequence
# prefill of its prompt and all but its last token (one chunked SSD).
# Measured 6.4e-6 to 1.03e-5 on an H100 (|logits| <= 9.8, seed 0); the
# limit leaves ~10x headroom, and a carry zeroed at a chunk boundary
# moves the logits far past it (tests/test_torch_smoke_checks.py).
STATE_CARRY_ATOL = 1e-4


def last_step_logits(engine) -> dict:
    """Wraps ``engine._pick``: fills rid -> the logits row (padded vocab)
    of the last step that picked a token for the request (its final
    prefill chunk, then each decode step), and returns that dict."""
    inner, last = engine._pick, {}

    def pick(logits, reqs=()):
        for i, r in enumerate(reqs):
            if r is not None:
                last[r.rid] = logits[i, -1].detach().clone()
        return inner(logits, reqs)

    engine._pick = pick
    return last


@torch.no_grad()
def state_carry_check(cfg, params, reqs, last, atol=STATE_CARRY_ATOL):
    """Each finished request's last-step logits ``last[rid]`` against a
    whole-sequence prefill of its prompt and all but its last generated
    token: the state the engine carried across chunks and decode steps
    against the state one chunked SSD builds.  Returns the max |logits
    error| of each request; raises above ``atol``."""
    from repro_torch.runtime.steps import make_prefill_step
    errs = []
    for r in reqs:
        seq = list(r.prompt) + list(r.generated[:-1])
        ref = last[r.rid]
        logits, _ = make_prefill_step(cfg, len(seq))(
            params, {"tokens": torch.tensor([seq], device=ref.device)})
        errs.append((logits[0, -1] - ref).abs().max().item())
        del logits
    if max(errs) > atol:
        raise AssertionError(f"the engine's carried state gives last-step "
                             f"logits {max(errs):.3e} from a whole-sequence "
                             f"prefill's (atol {atol}): {errs}")
    return errs


def ring_wrap_check(cfg, engine, reqs) -> dict:
    """Every request whose prompt is longer than its ring (``cfg.
    ring_geometry()``'s rows) wrapped it: its prefill chunks ran past the
    ring's rows, into pages the ring had already written.  Returns rid ->
    (prompt length, the last chunk's end)."""
    rows = cfg.ring_geometry()[1]
    ends = {}
    for _, rid, start, n in engine.chunk_trace:
        ends[rid] = max(ends.get(rid, 0), start + n)
    long = {r.rid: (len(r.prompt), ends.get(r.rid, 0)) for r in reqs
            if len(r.prompt) > rows}
    bad = [rid for rid, (_, end) in long.items() if end <= rows]
    if not long or bad:
        raise AssertionError(f"rings that did not wrap: {bad} of "
                             f"{sorted(long)} (ring rows {rows})")
    return long


def phase_state_carry(dev, seed, card, params) -> None:
    """mamba2-780m at full width and depth through the continuous engine
    (see the module docstring, phase 5e)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.paged import gather_footprint
    new_tokens = 32
    cfg, reqs = card_continuous_case(get_config("mamba2-780m"), seed,
                                     new_tokens)
    engine = ContinuousBatchingEngine(cfg, params=params, device=dev)
    used = []
    engine.iter_hook = lambda eng, it: used.append(eng.pool.num_used)
    last = last_step_logits(engine)
    reset_launches()
    t0 = time.perf_counter()
    engine.warmup(reqs)
    warm_s = time.perf_counter() - t0
    m = engine.run(reqs, realtime=False)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    bad = [r.rid for r in reqs if r.state != "finished"
           or len(r.generated) != new_tokens]
    if bad or launches or m.preemptions or not used or max(used):
        raise AssertionError(
            f"mamba2-780m: unfinished {bad}, kernels {launches}, "
            f"{m.preemptions} preemptions, pool blocks used up to "
            f"{max(used, default=None)}")
    t0 = time.perf_counter()
    errs = state_carry_check(cfg, params, reqs, last)
    check_s = time.perf_counter() - t0
    first = np.array([r.token_walls[0] for r in reqs])
    log(json.dumps({
        "continuous_path": cfg.name, "backend": None,
        "layers": cfg.num_layers, "requests": len(reqs),
        "prompt_lens": [len(r.prompt) for r in reqs],
        "max_new_tokens": new_tokens,
        "prefill_chunk": cfg.serving.prefill_chunk,
        "ssm_chunk": cfg.ssm_chunk, "warmup_s": warm_s,
        **dict(m.to_json(), ttft_s_mean=float(first.mean())),
        "pool_blocks_used_max": max(used),
        "state_bytes_per_step":
        gather_footprint(cfg)["state_bytes_per_step"],
        "last_step_logits_err_by_request": errs,
        "state_carry_atol": STATE_CARRY_ATOL,
        "max_abs_logits": max(v.abs().max().item() for v in last.values()),
        "whole_sequence_check_s": check_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "card": card}))


def phase_state_moe(dev, seed, card) -> dict:
    """Phase 5e (see the module docstring): jamba through the static path
    and the engine, mamba2's state carry, mixtral's MoE on wrapped rings;
    each architecture's weights freed after it.  Returns the runs'
    launches, named ``kernel[arch ...]``."""
    launches = {}
    jamba = "jamba-v0.1-52b"
    with phase_clock(f"{jamba} static phase", dev):
        counts, params = phase_main(dev, seed, card, jamba)
    launches.update({f"{k}[{jamba} static]": v for k, v in counts.items()})
    with phase_clock(f"continuous phase ({jamba} socket_fused, auto)", dev):
        counts, _, _ = phase_continuous(dev, seed, card, params,
                                        "socket_fused", arch=jamba)
    launches.update({f"{k}[{jamba} auto]": v for k, v in counts.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = draw_params(dev, seed, "mamba2-780m")
    with phase_clock("state-carry phase (mamba2-780m)", dev):
        phase_state_carry(dev, seed, card, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = "mixtral-8x22b"
    params = draw_params(dev, seed, mixtral)
    wraps = {}

    def after(engine, reqs):
        wraps.update(ring_wrap_check(engine.cfg, engine, reqs))

    with phase_clock(f"continuous phase ({mixtral} socket_fused, ring "
                     "kernel)", dev):
        counts, _, _ = phase_continuous(dev, seed, card, params,
                                        "socket_fused", arch=mixtral,
                                        after=after)
    log(f"{mixtral}: rings wrapped by the prompts longer than the window "
        f"(rid: prompt, last chunk's end): {wraps}")
    launches.update({f"{k}[{mixtral} auto]": v for k, v in counts.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"state_moe_launches": launches}))
    return launches


BF16_ARCHS = ("llama31-8b", "llama4-maverick-400b-a17b")


def phase_bf16(dev, seed, card):
    """Phase 5f (see the module docstring): the kernels on a bf16 model's
    inputs, then llama31-8b and llama4-maverick's one group at the
    deployment numerics through the static path and the engine.  Returns
    ({kernel: its ``bf16`` entry}, the runs' launches, named
    ``kernel[bf16]`` for llama31-8b's and ``kernel[bf16 arch ...]``
    for llama4's)."""
    t0 = time.perf_counter()
    rows = bf16_attention_rows(dev, seed)
    paged = paged_rows(dev, seed, "bf16", q_bf16=True)
    paged.update(ring_rows(dev, seed, "bf16", q_bf16=True))
    rows.update({name.split("[")[0]: row for name, row in paged.items()})
    log(f"bf16 kernel cases: {time.perf_counter() - t0:.1f} s")
    launches = {}
    llama, llama4 = BF16_ARCHS
    with phase_clock(f"{llama} bf16 static phase", dev):
        counts, params = phase_main(dev, seed, card, llama, "bf16")
    launches.update({f"{k}[bf16]": v for k, v in counts.items()})
    for backend in FUSED:
        # hard LSH and Quest at QUANT_DEPTH layers (the script's time
        # limit): socket_fused keeps the full depth
        groups = None if backend == "socket_fused" else QUANT_DEPTH
        with phase_clock(f"continuous phase ({llama} {backend}, bf16)", dev):
            counts, _, _ = phase_continuous(dev, seed, card, params, backend,
                                            numerics="bf16",
                                            num_groups=groups)
        launches.update({f"{k}[bf16]": v for k, v in counts.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock(f"{llama4} bf16 static phase", dev):
        counts, params = phase_main(dev, seed, card, llama4, "bf16")
    launches.update({f"{k}[bf16 {llama4} static]": v
                     for k, v in counts.items()})
    with phase_clock(f"continuous phase ({llama4} socket_fused, bf16)", dev):
        counts, _, _ = phase_continuous(dev, seed, card, params,
                                        "socket_fused", arch=llama4,
                                        numerics="bf16")
    launches.update({f"{k}[bf16 {llama4} auto]": v
                     for k, v in counts.items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"bf16_launches": launches}))
    return rows, launches


# --------------------------------------------------------------- phase 8

# The llama31-8b depth of phases 8a and 8b (2 of 32 layers at full width:
# 1.49 B parameters, 5.9 GB in f32) and the training shape of 8a-8c.
TRAIN_DEPTH = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 3
# Phase 8a, the kernel route's loss and gradients against the plain
# route's on the same weights and batch (f32; both backwards are the
# plain version's gradient, fed the kernel's or the plain op's forward).
# Measured on an H100 (seed 0): the losses 6.9e-8 apart (relative), the
# farthest gradient leaf 1.29e-6 (wq; relative L2).  The limits leave
# about 20x headroom, as LOGITS_ATOL does; a dropped causal mask moves
# the loss by O(1), and a detached kernel output leaves wq/wk/wv without
# a gradient, which the gate fails first.
TRAIN_LOSS_RTOL = 2e-6
TRAIN_GRAD_RTOL = 3e-5
_ATTN_WEIGHT = re.compile(r"\['attn'\]\['w[qkvo]'\]$")


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def plain_prefill(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
    """The plain op in place of ``attention``'s ``flash_prefill`` (the
    plain route of phase 8a): autograd through ``flash_prefill_ref`` in
    the query chunks the kernel route's backward uses."""
    from repro_torch.kernels.flash_prefill.ops import BACKWARD_Q_CHUNK
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    return flash_prefill_ref(q, k, v, scale=scale, window=window,
                             softcap=softcap,
                             q_chunk=q_chunk or BACKWARD_Q_CHUNK)


def train_route(cfg, params, batch, op=None):
    """``loss_and_metrics``' forward and backward through ``op`` in place
    of ``attention``'s ``flash_prefill`` when given: (loss, {path:
    gradient}, seconds)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.runtime.steps import loss_and_grads
    ctx = mock.patch.object(fp, "flash_prefill", op) if op else \
        contextlib.nullcontext()
    _sync(batch["tokens"])
    t0 = time.perf_counter()
    with ctx:
        loss, _, grads = loss_and_grads(cfg, params, batch)
    _sync(batch["tokens"])
    return float(loss), grads, time.perf_counter() - t0


def grad_gate(label, kernel, plain, loss_rtol=TRAIN_LOSS_RTOL,
              grad_rtol=TRAIN_GRAD_RTOL) -> dict:
    """Phase 8a's gate on (loss, {path: gradient}) of the kernel and the
    plain route: every attention weight's gradient present and not all
    zero on the kernel route (a detached kernel output leaves wq/wk/wv
    with none), the losses within ``loss_rtol``, and every gradient leaf
    within a relative L2 distance of ``grad_rtol``.  Returns the loss's
    and the largest leaf distances by leaf name."""
    (lk, gk), (lp, gp) = kernel, plain
    attn = sorted(p for p in gp if _ATTN_WEIGHT.search(p))
    if not attn:
        raise AssertionError(f"{label}: no attention weights")
    for path in attn:
        g = gk.get(path)
        if g is None or not bool(torch.any(g != 0)):
            raise AssertionError(f"{label}: {path} has no gradient on the "
                                 "kernel route (missing or all zero)")
    if set(gk) != set(gp):
        raise AssertionError(f"{label}: the routes' gradient leaves differ: "
                             f"{sorted(set(gk) ^ set(gp))[:4]}")
    loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
    if not (math.isfinite(lk) and loss_rel <= loss_rtol):
        raise AssertionError(f"{label}: loss {lk} on the kernel route, "
                             f"{lp} on the plain route (rtol {loss_rtol})")
    worst = {}
    for path, g in gp.items():
        rel = float(torch.linalg.vector_norm(gk[path].float() - g.float()) /
                    torch.linalg.vector_norm(g.float()).clamp(min=1e-30))
        if not rel <= grad_rtol:
            raise AssertionError(f"{label}: {path}'s gradient {rel:.3e} "
                                 f"from the plain route's (limit "
                                 f"{grad_rtol})")
        name = path.rsplit("[", 1)[1].strip("]'")
        worst[name] = max(worst.get(name, 0.0), rel)
    return {"loss_rel": loss_rel, "grad_rel_max": max(worst.values()),
            "grad_rel_by_leaf": worst}


def train_batch(cfg, rows, seq, seed, step, dev):
    """``SyntheticLMSource``'s batch ``step`` of ``rows`` rows on
    ``dev``."""
    from repro_torch.data import DataConfig, SyntheticLMSource
    src = SyntheticLMSource(DataConfig(seq_len=seq, global_batch=rows,
                                       vocab_size=cfg.vocab_size, seed=seed))
    return {k: torch.from_numpy(v).to(dev).long()
            for k, v in src.batch(0, step, range(rows)).items()}


def train_step_gate(label, params, opt_state, metrics_log, before,
                    hash_before, steps) -> None:
    """After ``steps`` train steps: every loss and gradient norm finite,
    every parameter finite, every trainable leaf changed (its first
    values ``before``), the hash planes unchanged and the step counter
    at ``steps``."""
    from repro_torch.optim.adamw import tree_leaves
    for i, m in enumerate(metrics_log):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{label}: step {i} gave loss {m['loss']}, "
                                 f"grad_norm {m['grad_norm']}")
    for path, p in tree_leaves(params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{label}: {path} is not finite")
        if path in before and torch.equal(p.reshape(-1)[:before[path]
                                                     .numel()],
                                          before[path]):
            raise AssertionError(f"{label}: {path} did not change")
    for i, (lp, h) in enumerate(zip(params["layers"], hash_before)):
        if h is not None and not torch.equal(lp["attn"]["hash_w"], h):
            raise AssertionError(f"{label}: layer {i}'s hash planes moved")
    if int(opt_state["step"]) != steps:
        raise AssertionError(f"{label}: step counter "
                             f"{int(opt_state['step'])}, expected {steps}")


def _train_snapshot(params):
    from repro_torch.optim.adamw import is_trainable_path, tree_leaves
    before = {path: p.reshape(-1)[:4096].clone()
              for path, p in tree_leaves(params) if is_trainable_path(path)}
    hashes = [lp["attn"]["hash_w"].clone() if "attn" in lp else None
              for lp in params["layers"]]
    return before, hashes


def train_flops_per_token(cfg, seq_len: int) -> float:
    """The JAX package's ``model_flops_per_token(..., training=True)``:
    6 x the active parameters, plus the attention products over the
    causal half of each query's keys."""
    attended = sum(seq_len / 2 if s.attn_type == "global" else
                   min(cfg.sliding_window, seq_len / 2)
                   for s in cfg.layer_specs if s.kind == "attn")
    return 6.0 * cfg.active_param_count() + \
        6.0 / 3 * 2 * 2 * cfg.num_heads * cfg.head_dim * attended * 3


def run_train_steps(label, cfg, params, opt_state, step_fn, rows, seed,
                    dev, steps=TRAIN_STEPS):
    """``steps`` train steps on ``SyntheticLMSource``'s batches 0.. of
    ``rows`` rows; returns (params, opt_state, [metrics with step_s])."""
    out = []
    for i in range(steps):
        batch = train_batch(cfg, rows, TRAIN_SEQ, seed, i, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        out.append(m)
        log(f"{label} step {i}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.4f}, {m['step_s']:.3f} s")
    return params, opt_state, out


def train_breakdown(cfg, params, opt_state, step_fn, rows, seed, dev):
    """One more train step with the device synchronised at each part's
    edge: forward (``loss_and_metrics``), backward (to the optimizer's
    entry), of it the plain attention backward
    (``flash_prefill_ref_backward``), the optimizer update, and the
    host's share (the batch drawn and copied, the metrics read).  The
    synchronisations cost a little overlap; the gated steps have none."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.runtime import steps as st
    parts = collections.defaultdict(float)
    marks = {}

    def timed(name, fn, edge=None):
        def wrapper(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if edge:
                parts[edge] += t0 - marks.pop(edge, t0)
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            parts[name] += time.perf_counter() - t0
            if name == "forward_s":
                marks["backward_s"] = time.perf_counter()
            return out
        return wrapper

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    batch = train_batch(cfg, rows, TRAIN_SEQ, seed, TRAIN_STEPS, dev)
    with mock.patch.object(st.tfm, "loss_and_metrics", timed(
            "forward_s", st.tfm.loss_and_metrics)), \
            mock.patch.object(st, "adamw_update", timed(
                "optimizer_s", st.adamw_update, edge="backward_s")), \
            mock.patch.object(fp, "flash_prefill_ref_backward", timed(
                "attention_backward_s", fp.flash_prefill_ref_backward)):
        params, opt_state, m = step_fn(params, opt_state, batch)
        float(m["loss"])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out = dict(parts, step_s=wall)
    out["host_s"] = wall - parts["forward_s"] - parts["backward_s"] - \
        parts["optimizer_s"]
    return params, opt_state, out


def trainer_resume_check(label, straight, resumed, fail_at,
                         ckpt_every) -> None:
    """Phase 8d's gate on two Trainers of one config: ``resumed`` failed
    once at step ``fail_at`` and rolled back to the last checkpoint;
    every step's loss and its final parameters and optimizer state must
    equal ``straight``'s (an uninterrupted run) bit for bit."""
    from repro_torch.optim.adamw import tree_leaves
    back = fail_at // ckpt_every * ckpt_every
    want = list(range(fail_at)) + list(range(back, straight.step))
    got = [m["step"] for m in resumed.metrics_log]
    if resumed.rebuild_count != 1 or got != want:
        raise AssertionError(f"{label}: {resumed.rebuild_count} rebuilds, "
                             f"steps {got}, expected 1 and {want}")
    losses = {m["step"]: m["loss"] for m in resumed.metrics_log}
    ref = [m["loss"] for m in straight.metrics_log]
    if [losses[s] for s in range(len(ref))] != ref:
        raise AssertionError(f"{label}: the resumed run's losses "
                             f"{[losses[s] for s in range(len(ref))]} are "
                             f"not the uninterrupted run's {ref}")
    for name in ("params", "opt_state"):
        a = dict(tree_leaves(getattr(straight, name)))
        b = dict(tree_leaves(getattr(resumed, name)))
        for path, t in a.items():
            pairs = t.items() if isinstance(t, dict) else [("", t)]
            for k, x in pairs:
                y = b[path][k] if k else b[path]
                if not torch.equal(x, y):
                    raise AssertionError(f"{label}: {name} {path}{k} "
                                         "differs after the resume")


def train_cli(dev) -> dict:
    """``python -m repro_torch.launch.train --smoke`` once, as a user
    would run it (default device: the card)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minitron-8b", "--smoke", "--steps", "20", "--batch", "8", "--seq",
         "512"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"launch.train exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    if out["steps"] != 20 or not math.isfinite(out["loss_last10"]) or \
            out["device"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"launch.train printed {out}")
    out["process_s"] = time.perf_counter() - t0
    return out


def phase_train(dev, seed, card) -> dict:
    """Phase 8 (see the module docstring).  Returns the ``flash_prefill``
    row's ``train`` entry: each case's launches, gate readings, step
    times, the breakdown and the model FLOPs/s."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.specs import SHAPES, dryrun_model_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    entry = {}
    # 8a: the kernel route's gradients against the plain route's
    cfg = get_config("llama31-8b").replace(num_groups=TRAIN_DEPTH)
    with phase_clock("train 8a (kernel-route gradients, f32)", dev):
        params = tfm.init_model(cfg, seed, dev)
        batch = train_batch(cfg, 1, TRAIN_SEQ, seed, 0, dev)
        reset_launches()
        lk, gk, sk = train_route(cfg, params, batch)
        launches = read_launches()
        launch_gate("train 8a", launches, "flash_prefill", cfg.num_layers, 1)
        reset_launches()
        lp, gp, sp = train_route(cfg, params, batch, plain_prefill)
        if any(read_launches().values()):
            raise AssertionError("train 8a: the plain route launched a "
                                 f"kernel: {read_launches()}")
        gate = grad_gate("train 8a", (lk, gk), (lp, gp))
        del gk, gp
        log(json.dumps({"train_8a": dict(
            gate, loss_kernel=lk, loss_plain=lp, kernel_route_s=sk,
            plain_route_s=sp, params_b=cfg.param_count() / 1e9,
            layers=cfg.num_layers)}))
    entry["8a"] = dict(gate, launches=launches["flash_prefill"],
                       kernel_route_s=sk, plain_route_s=sp)
    # 8b: the train step at f32, two microbatches, 32-bit moments
    ocfg = AdamWConfig(state_bits=32)
    with phase_clock("train 8b (train step, f32, accum 2)", dev):
        opt = init_adamw(ocfg, params)
        before, hashes = _train_snapshot(params)
        reset_launches()
        params, opt, ms = run_train_steps(
            "train 8b", cfg, params, opt, make_train_step(cfg, ocfg, 2), 2,
            seed, dev)
        launches = read_launches()
        launch_gate("train 8b", launches, "flash_prefill", cfg.num_layers,
                    2 * TRAIN_STEPS)
        train_step_gate("train 8b", params, opt, ms, before, hashes,
                        TRAIN_STEPS)
    entry["8b"] = dict(launches=launches["flash_prefill"],
                       loss=[m["loss"] for m in ms],
                       step_s=[m["step_s"] for m in ms])
    del params, opt, before, hashes
    gc.collect()
    torch.cuda.empty_cache()
    # 8c: the deployment's training numerics at full depth
    cfg = dryrun_model_config(get_config("llama31-8b"), SHAPES["train_4k"])
    ocfg = AdamWConfig(state_bits=8)
    with phase_clock("train 8c (bf16, remat full, 8-bit moments)", dev):
        t0 = time.perf_counter()
        params = tfm.init_model(cfg, seed, dev)
        opt = init_adamw(ocfg, params)
        torch.cuda.synchronize(dev)
        log(f"train 8c: {cfg.param_count() / 1e9:.3f} B params "
            f"({cfg.param_dtype}, {cfg.num_layers} layers, remat "
            f"{cfg.remat_policy}) and 8-bit moments drawn in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        step_fn = make_train_step(cfg, ocfg, 1)
        before, hashes = _train_snapshot(params)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        params, opt, ms = run_train_steps("train 8c", cfg, params, opt,
                                          step_fn, 1, seed, dev)
        launches = read_launches()
        # every attention layer's forward, and again in the backward
        launch_gate("train 8c", launches, "flash_prefill", cfg.num_layers,
                    2 * TRAIN_STEPS)
        train_step_gate("train 8c", params, opt, ms, before, hashes,
                        TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        step_s = min(m["step_s"] for m in ms[1:])
        flops = train_flops_per_token(cfg, TRAIN_SEQ) * TRAIN_SEQ
        params, opt, parts = train_breakdown(cfg, params, opt, step_fn, 1,
                                             seed, dev)
        c8 = dict(launches=launches["flash_prefill"],
                  loss=[m["loss"] for m in ms],
                  step_s=[m["step_s"] for m in ms], peak_gb=peak,
                  tokens_per_s=TRAIN_SEQ / step_s,
                  model_tflop_per_s=flops / step_s / 1e12,
                  mfu_bf16=flops / step_s / BF16_FLOP_PER_S,
                  breakdown=parts, card=card)
        log(json.dumps({"train_8c": c8}))
    entry["8c"] = c8
    del params, opt, before, hashes, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    # 8d: the Trainer resumes on the card; the CLI runs
    cfg = get_config("minitron-8b").smoke().replace(
        num_groups=1, attention_backend="dense")
    ocfg = AdamWConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2,
                                               decay_steps=10))
    loop = TrainLoopConfig(total_steps=10, checkpoint_every=5)
    data = DataConfig(seq_len=64, global_batch=2, vocab_size=cfg.vocab_size,
                      seed=1)
    with phase_clock("train 8d (Trainer resume, launch.train)", dev), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        straight = Trainer(cfg, ocfg, loop, data, d + "/a", device=dev)
        straight.run()
        resumed = Trainer(cfg, ocfg, loop, data, d + "/b", device=dev,
                          injector=FailureInjector(
                              {7: RuntimeError("injected failure")}))
        resumed.run()
        trainer_resume_check("train 8d", straight, resumed, 7, 5)
        cli = train_cli(dev)
        log(json.dumps({"train_8d": {
            "losses": [m["loss"] for m in straight.metrics_log],
            "resumed_steps": [m["step"] for m in resumed.metrics_log],
            "cli": cli}}))
    entry["8d"] = dict(cli_mean_step_s=cli["mean_step_s"],
                       cli_process_s=cli["process_s"])
    return entry


# ------------------------------------------------------------ phase 9

CP_WORLD = 4
CP_N = 524288                  # long_500k's cache (launch/specs.py SHAPES)
CP_GEOMETRY = dict(b=1, kvh=8, g=4, hd=128)   # llama31-8b's decode attention
# 9a's runs: (mesh (data, model), CP axes, selection, "empty" for a length
# that leaves the last shard without a valid row, else the whole cache)
CP_RUNS = (((4, 1), ("data",), "kvhead", None),
           ((4, 1), ("data",), "pooled", None),
           ((2, 2), ("data", "model"), "kvhead", "empty"))
# the CP route's relative distance to the global route at most this
# (tests/test_distributed.py's bound for the JAX package's), and dense
# attention's at least this (else the inputs do not test the bound)
CP_GLOBAL_REL = 0.08
# 9a's warm keys (``cp_inputs``): the share of each shard's rows, and
# the most a warm key's logit is lifted.  At smaller sizes (CPU, 16384
# and 65536 rows) these read 0.014-0.034 from the CP route to the global
# route, 0.11-0.14 from dense attention and 0.37-0.45 from a route whose
# budget is that of a shard's rows
CP_WARM_SHARE = (0.14, 0.10, 0.10, 0.06)
CP_WARM_MAX = 6.0
CP_WARM, CP_TIMED = 2, 10
# 9b: llama31-8b at full width, 4 of its 32 layers (4 ranks' replicated
# f32 weights, 4 x 7.7 GB, and their prefill activations share one card
# with the reference process), one 32768-token prompt, 16 greedy steps,
# 32800 cache rows over 4 ranks of 8200 (the new tokens land on the last)
CP_DEPTH = 4
CP_PROMPT, CP_STEPS, CP_CAPACITY = 32768, 16, 32800
CP_DEADLINE_S = 600
# 9c: the dense, hard-LSH and Quest backends on 9b's ranks and weights,
# the same prompt, 8 greedy steps each, 32832 cache rows over 4 ranks of
# 8208 (whole Quest pages of 16 rows a rank; the new tokens land on the
# last rank)
CPB_BACKENDS = ("dense", "hard_lsh", "quest")
CPB_STEPS, CPB_CAPACITY = 8, 32832


def cp_socket_config(selection, **over):
    """9a's SOCKET settings: the cells' (llama31-8b's ``SocketSettings``),
    the plain version's scores in chunks of 16384 keys (its unpacked
    signs stay bounded at 524288 keys)."""
    from repro_torch.core import socket as sk
    kw = dict(num_planes=10, num_tables=60, tau=0.4, sparsity=10.0,
              sink_tokens=128, window_tokens=128, min_k=16,
              score_chunk=16384)
    kw.update(over)
    return sk.SocketConfig(selection=selection, **kw)


def cp_length(cut, n, shards) -> int:
    """The global length of a run: the whole cache, or (``"empty"``)
    1000 rows short of three shards, so the last shard has no valid row
    and the third a partial one."""
    return n if cut is None else (n // shards) * (shards - 1) - 1000


def cp_inputs(dev, seed, n, shards, geo, cfg, shard=None) -> dict:
    """9a's inputs, drawn on ``dev`` from ``seed``: hash planes, a query
    per KV head along a random direction ``u`` (G heads around it), and
    the K/V rows, hash bits and value norms of shard ``shard`` (each shard
    from its own generator), or of the whole cache (``shard`` None: the
    shards concatenated).  Keys are N(0, 1), so a logit is about N(0, 1);
    a share ``CP_WARM_SHARE[s]`` of shard ``s``'s rows are warm keys,
    ``a u`` added with ``a`` uniform in [0, CP_WARM_MAX] a head, which
    lifts their logits by about ``a``.  The attention mass spreads over
    thousands of keys of graded weight, and shard 0 holds 1.4 x
    ``k_local`` warm keys at sparsity 10, so the global top-k takes more
    of its rows than its local top-k can."""
    from repro_torch.core import socket as sk
    b, kvh, g, hd = geo["b"], geo["kvh"], geo["g"], geo["hd"]
    gen = torch.Generator(device=dev).manual_seed(seed * 7919)
    w = torch.randn(cfg.num_tables, cfg.num_planes, hd, generator=gen,
                    device=dev)
    hot = torch.randn(b, kvh, hd, generator=gen, device=dev)
    unit = hot / hot.norm(dim=-1, keepdim=True)
    q = hot[:, :, None, None, :] + 0.3 * torch.randn(
        b, kvh, g, 1, hd, generator=gen, device=dev)
    n_l = n // shards
    parts = []
    for s in (range(shards) if shard is None else (shard,)):
        gs = torch.Generator(device=dev).manual_seed(seed * 7919 + 1 + s)
        k = torch.randn(b, kvh, n_l, hd, generator=gs, device=dev)
        v = torch.randn(b, kvh, n_l, hd, generator=gs, device=dev)
        rows = torch.randperm(n_l, generator=gs, device=dev)[
            :int(n_l * CP_WARM_SHARE[s])]
        a = CP_WARM_MAX * torch.rand(b, kvh, rows.numel(), generator=gs,
                                     device=dev)
        k[:, :, rows] += a[..., None] * unit[:, :, None, :]
        side = sk.precompute_key_hashes(cfg, w, k, v)
        parts.append((k, v, side.bits, side.vnorm.float()))
    k, v, bits, vnorm = (torch.cat(x, dim=2) if len(x) > 1 else x[0]
                         for x in zip(*parts))
    return dict(w=w, q=q, k=k, v=v, bits=bits, vnorm=vnorm)


def cp_rank_selection(cfg, mesh, axes, data, n, length,
                      use_score_kernel=True):
    """A rank's SOCKET selection as its attend makes it: its shard's
    scores (``socket_score`` on the card), its ``lo`` and the budget of
    the global ``n`` from the functions the route calls."""
    from repro_torch.distributed import context_parallel as cp
    shards = mesh.extent(axes)
    n_l = data["k"].shape[2]
    scores = cp.local_scores(cfg, data["w"], data["q"], data["bits"],
                             use_score_kernel=use_score_kernel)
    return cp.local_select(cfg, scores, data["vnorm"],
                           cp.shard_lo(mesh, axes, n_l), length,
                           cp.local_budget(cfg, n, shards))


def cp_selection_gate(label, cfg, sels, data, length, shards) -> int:
    """Each rank's selection ``sels[s] = (idx, mask)`` (shard ``s``)
    against the plain version's for that shard, computed here from the
    whole cache with shard ``s``'s rows, ``lo = s * n / shards`` and the
    budget of the global length: the same rows, but for rows whose plain
    effective score lies within SCORE_TOL of the shard's top-k threshold
    (both sum the same fp32 terms in other orders; the rule of
    ``static_ties_shared``).  Returns the rows swapped inside the band."""
    from repro_torch.core import socket as sk
    from repro_torch.distributed import context_parallel as cp
    n = data["k"].shape[2]
    n_l = n // shards
    k_local = max(cfg.min_k, -(-sk.topk_budget(cfg, n) // shards))
    swapped = 0
    for s in range(shards):
        rows = slice(s * n_l, (s + 1) * n_l)
        idx, mask = sels[s]
        if idx.shape[-1] != k_local:
            raise AssertionError(f"{label}: shard {s} selected "
                                 f"{idx.shape[-1]} rows, the budget of the "
                                 f"global length is {k_local}")
        scores = cp.local_scores(cfg, data["w"], data["q"],
                                 data["bits"][:, :, rows])
        vnorm = data["vnorm"][:, :, rows]
        pidx, pmask = cp.local_select(cfg, scores, vnorm, s * n_l, length,
                                      k_local)
        ksel = torch.zeros(scores.shape, dtype=torch.bool,
                           device=scores.device).scatter_(-1, idx, mask)
        psel = torch.zeros_like(ksel).scatter_(-1, pidx, pmask)
        diff = psel != ksel
        if not bool(diff.any()):
            continue
        gpos = s * n_l + torch.arange(n_l, device=scores.device)
        eff = scores.float() * vnorm.float()
        eff = torch.where((gpos < cfg.sink_tokens) |
                          (gpos >= length - cfg.window_tokens),
                          sk.FLT_MAX, eff)
        eff = torch.where(gpos < length, eff, sk.NEG_INF)
        thr = torch.sort(eff, dim=-1, descending=True).values[
            ..., k_local - 1:k_local]
        close = (eff - thr).abs() <= SCORE_TOL["atol"] + \
            SCORE_TOL["rtol"] * thr.abs()
        if bool((diff & ~close).any()) or \
                not torch.equal(ksel.sum(-1), psel.sum(-1)):
            raise AssertionError(
                f"{label}: shard {s}'s selection differs from the plain "
                f"version's outside the threshold band "
                f"({int((diff & ~close).sum())} rows)")
        swapped += int(diff.sum()) // 2
    return swapped


def cp_partials_check(label, parts, length, n) -> None:
    """Each shard's online-softmax partials ``parts[s] = (m, l, o)`` are
    finite, and a shard with no valid row has ``l = 0`` and ``o = 0``, so
    its merge weight ``w = l e^{m - m*}`` is 0, never NaN."""
    shards = len(parts)
    m_star = torch.stack([parts[s][0] for s in range(shards)]).amax(0)
    for s in range(shards):
        m, l, o = parts[s]
        w = l * torch.exp(m - m_star)
        if not all(bool(torch.isfinite(t).all()) for t in (m, l, o, w)):
            raise AssertionError(f"{label}: shard {s}'s partials are not "
                                 "finite")
        if s * (n // shards) >= length and (
                bool(l.any()) or bool(o.any()) or bool(w.any())):
            raise AssertionError(f"{label}: shard {s} holds no valid row "
                                 "but its partials are not 0")


def cp_merge_gate(label, outs, ref, glob, dense) -> dict:
    """Every rank's merged output within ATTN_TOL of the plain
    single-process version's, finite, and at most CP_GLOBAL_REL (relative
    L2) from the global route's, while dense attention lies at least
    CP_GLOBAL_REL from it (the inputs separate a sparse route from dense
    attention, so the bound can fail)."""
    err = max(check_close(f"{label}: rank {r}", out, ref, ATTN_TOL)
              for r, out in enumerate(outs))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    to_global, to_dense = rel(outs[0], glob), rel(outs[0], dense)
    if not to_global < CP_GLOBAL_REL:
        raise AssertionError(f"{label}: relative distance to the global "
                             f"route {to_global:.4f} >= {CP_GLOBAL_REL}")
    dense_to_global = rel(dense, glob)
    if not dense_to_global >= CP_GLOBAL_REL:
        raise AssertionError(f"{label}: dense attention reads "
                             f"{dense_to_global:.4f} from the global route, "
                             f"inside the {CP_GLOBAL_REL} bound: the inputs "
                             "do not test it")
    log(f"  {label}: max |err| to the plain version {err:.3e}; relative "
        f"distance to the global route {to_global:.4f} (limit "
        f"{CP_GLOBAL_REL}), to dense attention {to_dense:.4f}; dense "
        f"attention to the global route {dense_to_global:.4f}")
    return dict(max_abs_err=err, rel_to_global=to_global,
                rel_to_dense=to_dense, dense_to_global=dense_to_global)


def cp_dense(data, length, scale) -> torch.Tensor:
    """Dense attention over the whole cache's first ``length`` rows."""
    from repro_torch.core import socket as sk
    logits = torch.einsum("bhgtd,bhnd->bhgtn", data["q"],
                          data["k"]) * scale
    valid = torch.arange(logits.shape[-1], device=logits.device) < length
    return torch.einsum(
        "bhgtn,bhnd->bhgtd",
        torch.softmax(torch.where(valid, logits, sk.NEG_INF), -1),
        data["v"])


def cp_timed_ms(fn, warm=CP_WARM, iters=CP_TIMED) -> float:
    """Median host milliseconds of ``fn()`` on a rank, every call started
    together on all ranks (a barrier) and ended with the device's work."""
    import statistics
    import torch.distributed as dist
    times = []
    for i in range(warm + iters):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cp_attend_rank(rank, world, tmp, seed) -> None:
    """9a on one rank: each run's attend (launches counted), its
    selection and partials, a step and the merge timed."""
    import torch.distributed as dist
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, dev = init_rank(rank, world, f"file://{tmp}/init9a", "cuda")
    meshes = {shape: make_test_mesh(*shape)
              for shape in sorted({r[0] for r in CP_RUNS})}
    res = {"backend": backend, "device": str(dev)}
    scale = 1.0 / math.sqrt(CP_GEOMETRY["hd"])
    for i, (shape, axes, sel, cut) in enumerate(CP_RUNS):
        mesh, cfg = meshes[shape], cp_socket_config(sel)
        shard = mesh.index(axes)
        length = cp_length(cut, CP_N, world)
        data = cp_inputs(dev, seed, CP_N, world, CP_GEOMETRY, cfg, shard)
        args = (cfg, mesh, axes, data["w"], data["q"], data["k"],
                data["v"], data["bits"], data["vnorm"])
        kw = dict(length=length, scale=scale, use_score_kernel=True)
        dist.barrier()
        ss.LAUNCHES = 0
        out = cp.context_parallel_socket_attend(*args, **kw)
        launches = ss.LAUNCHES
        idx, mask = cp_rank_selection(cfg, mesh, axes, data, CP_N, length)
        parts = cp.local_partials(data["q"], data["k"], data["v"], idx,
                                  mask, scale)
        step_ms = cp_timed_ms(
            lambda: cp.context_parallel_socket_attend(*args, **kw))
        merge_ms = cp_timed_ms(
            lambda: cp.merge_partials(*parts, mesh.group(axes)))
        res[i] = dict(shard=shard, out=out.cpu(), idx=idx.cpu(),
                      mask=mask.cpu(), parts=[t.cpu() for t in parts],
                      launches=launches, step_ms=step_ms, merge_ms=merge_ms,
                      route=cp.comm_route(out, mesh.group(axes)))
        del data, args, parts
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.save(res, os.path.join(tmp, f"cp_attend_{rank}.pt"))
    end_rank()


def phase_cp_attend(dev, seed, card) -> dict:
    """Phase 9a (see the module docstring)."""
    import tempfile
    from repro_torch.core import socket as sk
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    log(f"cp 9a: {CP_WORLD} ranks, backend "
        f"{collective_backend(CP_WORLD, 'cuda')}, "
        f"{torch.cuda.device_count()} card(s); {card}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(cp_attend_rank, CP_WORLD, (CP_WORLD, tmp, seed),
                    deadline_s=CP_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"cp_attend_{r}.pt"))
                 for r in range(CP_WORLD)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, devices "
        f"{[r['device'] for r in ranks]}, peak GB "
        f"{[round(r['peak_gb'], 2) for r in ranks]}")
    if torch.cuda.device_count() < CP_WORLD:
        log(f"  the {CP_WORLD} ranks share one card: their times are that "
            "card's under four processes, not a measure of scaling")
    scale = 1.0 / math.sqrt(CP_GEOMETRY["hd"])
    entry = {}
    for i, (shape, axes, sel, cut) in enumerate(CP_RUNS):
        cfg = cp_socket_config(sel)
        length = cp_length(cut, CP_N, CP_WORLD)
        label = f"cp 9a mesh {shape} axes {axes} {sel} length {length}"
        got = sorted((r[i] for r in ranks), key=lambda x: x["shard"])
        shards = [g["shard"] for g in got]
        if shards != list(range(CP_WORLD)):
            raise AssertionError(f"{label}: the ranks' shards {shards}")
        if any(g["launches"] != 1 for g in got):
            raise AssertionError(f"{label}: socket_score launches "
                                 f"{[g['launches'] for g in got]}, one a "
                                 "rank expected")
        data = cp_inputs(dev, seed, CP_N, CP_WORLD, CP_GEOMETRY, cfg)
        swapped = cp_selection_gate(
            label, cfg, [(g["idx"].to(dev), g["mask"].to(dev)) for g in got],
            data, length, CP_WORLD)
        cp_partials_check(label, [[t.to(dev) for t in g["parts"]]
                                  for g in got], length, CP_N)
        args = (data["w"], data["q"], data["k"], data["v"], data["bits"],
                data["vnorm"])
        ref = cp.context_parallel_socket_attend_ref(
            cfg, CP_WORLD, *args, length=length, scale=scale,
            use_score_kernel=True)
        side = sk.SocketCache(data["bits"], data["vnorm"])
        glob = sk.socket_attend(cfg, data["w"], data["q"], data["k"],
                                data["v"], side, length=length, scale=scale)
        dense = cp_dense(data, length, scale)
        gates = cp_merge_gate(label, [g["out"].to(dev) for g in got], ref,
                              glob, dense)

        def global_route():
            return sk.socket_attend(cfg, data["w"], data["q"], data["k"],
                                    data["v"], side, length=length,
                                    scale=scale, use_kernel=True)

        global_ms = back_to_back_ms(lambda: global_route(), [()], iters=5)
        step = [g["step_ms"] for g in got]
        merge = [g["merge_ms"] for g in got]
        log(f"  {label}: band swaps {swapped}; a rank's step "
            f"{max(step):.3f} ms (ranks {[round(x, 3) for x in step]}), "
            f"its merge {max(merge):.3f} ms ({max(merge) / max(step):.1%} "
            f"of the step; collectives through the "
            f"{got[0]['route']}); the global route in one process "
            f"{global_ms:.3f} ms")
        entry[f"{shape[0]}x{shape[1]}-{'+'.join(axes)}-{sel}"] = dict(
            gates, length=length, band_swaps=swapped, rank_step_ms=step,
            merge_ms=merge, global_ms=global_ms, route=got[0]["route"],
            launches=sum(g["launches"] for g in got))
        del data, args, side, ref, glob, dense
        gc.collect()
        torch.cuda.empty_cache()
    entry["backend"] = ranks[0]["backend"]
    entry["peak_gb"] = [r["peak_gb"] for r in ranks]
    return entry


def cp_model_config(cp_axes=("data",), backend="socket"):
    """9b's model (9c's with ``backend``): llama31-8b at full width,
    CP_DEPTH layers, f32, its SOCKET scores through ``socket_score`` and
    its selections attended through ``flash_decode``; ``cp_axes`` () for
    the single-process (global) route."""
    from repro_torch.launch.serve import card_config
    cfg = card_config("llama31-8b").replace(
        num_groups=CP_DEPTH, decode_cp_axes=cp_axes, decode_cp_batch_axes=(),
        attention_backend=backend)
    return cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=True, use_flash_decode=True))


def cp_run_shape(cfg):
    """(decode steps, cache rows) of 9b's run (SOCKET) or a 9c run."""
    if cfg.attention_backend == "socket":
        return CP_STEPS, CP_CAPACITY
    return CPB_STEPS, CPB_CAPACITY


@torch.no_grad()
def cp_prefill(cfg, params, prompt):
    """``prefill`` at the run's capacity; returns (logits, caches,
    seconds)."""
    from repro_torch.models import transformer as tfm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = tfm.prefill(cfg, params, {"tokens": prompt},
                                 cp_run_shape(cfg)[1])
    torch.cuda.synchronize()
    return logits, caches, time.perf_counter() - t0


@torch.no_grad()
def cp_drive(cfg, params, prompt, teacher=None, prefilled=None):
    """``prefill`` (or ``prefilled``, :func:`cp_prefill`'s result) and the
    run's greedy ``decode_step``s (``teacher``: step t feeds
    ``teacher[:, t]`` instead of the last argmax); returns (tokens (1, 1 +
    steps), each step's last-position logits, prefill s, each step's
    s, the caches after the steps)."""
    from repro_torch.models import transformer as tfm
    logits, caches, prefill_s = prefilled or cp_prefill(cfg, params, prompt)
    toks, steps = [torch.argmax(logits[:, -1], dim=-1)[:, None]], \
        [logits[:, -1].float().cpu()]
    step_s = []
    for t in range(cp_run_shape(cfg)[0]):
        t0 = time.perf_counter()
        inp = toks[-1] if teacher is None else teacher[:, t:t + 1]
        logits, caches = tfm.decode_step(cfg, params, caches, inp,
                                         CP_PROMPT + t)
        toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
        steps.append(logits[:, -1].float().cpu())     # waits for the step
        step_s.append(time.perf_counter() - t0)
    return torch.cat(toks, dim=1).cpu(), steps, prefill_s, step_s, caches


def step_ms(step_s) -> str:
    """A run's first decode step (collective groups set up on first use)
    and the median of the rest, in ms."""
    import statistics
    return (f"{step_s[0] * 1e3:.2f} first, "
            f"{statistics.median(step_s[1:]) * 1e3:.2f} median")


def cp_prompt(cfg, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (1, CP_PROMPT), generator=gen,
                         device=dev)


@contextlib.contextmanager
def layer0_selections(layers):
    """Records layer 0's selection ``(idx, mask)`` at every decode step
    (the first of every ``layers`` calls) of the global top-k
    (``core/socket.py::top_of_scores``: hard LSH) and of Quest's page
    top-k (``baselines/quest.py::select_pages``), which the CP routes and
    the global routes both call."""
    from repro_torch.baselines import quest as qm
    from repro_torch.core import socket as sk
    got, calls = [], [0]

    def spy(fn):
        def wrapped(*args, **kw):
            idx, mask = fn(*args, **kw)
            if calls[0] % layers == 0:
                got.append((idx.clone(), mask.clone()))
            calls[0] += 1
            return idx, mask
        return wrapped
    with mock.patch.object(sk, "top_of_scores", spy(sk.top_of_scores)), \
            mock.patch.object(qm, "select_pages", spy(qm.select_pages)):
        yield got


def cp_rank_run(cfg, params, prompt, rank, world) -> dict:
    """One run on a rank, 9b's (SOCKET) or a 9c backend's: the ranks
    prefill in turn (four 32768-token prefills' activations at once do
    not fit beside four ranks' weights on one card), then decode under
    the mesh, the launches counted from 0.  A 9c run also keeps layer
    0's selection at every step, Quest's bounds after the steps, and the
    seconds and bytes of the steps' collectives (each collective
    synchronised and timed: ``collectives.TIMING``)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    dist.barrier()
    reset_launches()
    for r in range(world):
        if r == rank:
            prefilled = cp_prefill(cfg, params, prompt)
            torch.cuda.empty_cache()
        dist.barrier()
    out = {}
    if cfg.attention_backend == "socket":
        toks, steps, prefill_s, step_s = cp_drive(
            cfg, params, prompt, prefilled=prefilled)[:4]
    else:
        collectives.SECONDS.update(dict.fromkeys(collectives.SECONDS, 0.0))
        posted = collectives.PEER_COPIED["bytes"]
        collectives.TIMING["on"] = True
        try:
            with layer0_selections(cfg.num_layers) as sels:
                toks, steps, prefill_s, step_s, caches = cp_drive(
                    cfg, params, prompt, prefilled=prefilled)
        finally:
            collectives.TIMING["on"] = False
        out.update(
            selections=[(i.cpu(), m.cpu()) for i, m in sels],
            bounds=[{k: c[k].cpu() for k in ("kmin", "kmax")}
                    for c in caches] if "kmin" in caches[0] else None,
            collective_s=dict(collectives.SECONDS),
            posted_bytes=collectives.PEER_COPIED["bytes"] - posted)
        del caches
    launches = read_launches()
    del prefilled
    torch.cuda.empty_cache()
    out.update(tokens=toks, logits=steps if rank == 0 else None,
               launches=launches, prefill_s=prefill_s, step_s=step_s)
    return out


def cp_model_rank(rank, world, tmp, seed, runs) -> None:
    """9b and 9c on one rank, one weight draw: a :func:`cp_rank_run` for
    each of ``runs`` ("socket" is 9b's, a backend's name a 9c run)."""
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, dev = init_rank(rank, world, f"file://{tmp}/init9b", "cuda")
    cfg = cp_model_config()
    params = tfm.init_model(cfg, seed, dev)
    prompt = cp_prompt(cfg, seed, dev)
    out = dict(backend=backend, device=str(dev))
    with activate_mesh(make_test_mesh(world, 1)):
        for run in runs:
            out[run] = cp_rank_run(cp_model_config(backend=run), params,
                                   prompt, rank, world)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.save(out, os.path.join(tmp, f"cp_model_{rank}.pt"))
    end_rank()


def cp_plain_attend(shards):
    """A stand-in for ``context_parallel_socket_attend`` in one process
    that holds the whole cache: ``context_parallel_socket_attend_ref``
    over ``shards`` blocks (the same shard scoring, ``socket_score`` where
    the config asks for it)."""
    from repro_torch.distributed import context_parallel as cp

    def attend(cfg, mesh, seq_axes, *args, batch_axes=(), **kw):
        return cp.context_parallel_socket_attend_ref(cfg, shards, *args,
                                                     **kw)
    return attend


def cp_launch_gate(label, ranks, layers, want=None) -> dict:
    """9b's launches on the ranks: ``socket_score`` layers x steps a rank
    (ranks x layers x steps in all), ``flash_prefill`` layers a rank, no
    other kernel; or ``want``'s counts a rank and no other kernel."""
    want = want or {"socket_score": layers * CP_STEPS,
                    "flash_prefill": layers}
    for r, got in enumerate(ranks):
        counts = got["launches"]
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        if bad:
            raise AssertionError(f"{label}: rank {r} launched {bad}, "
                                 f"expected {want} and no other kernel")
    return {k: sum(g["launches"][k] for g in ranks) for k in want}


def cp_logits_gate(label, toks, steps, ref_toks, ref_steps) -> float:
    """The ranks' greedy tokens equal the reference's, and every step's
    logits lie within LOGITS_ATOL of it."""
    if not torch.equal(toks, ref_toks):
        raise AssertionError(f"{label}: tokens {toks.tolist()} vs the "
                             f"plain single-process route's "
                             f"{ref_toks.tolist()}")
    errs = [float((a.double() - b.double()).abs().max())
            for a, b in zip(steps, ref_steps)]
    if not max(errs) <= LOGITS_ATOL:
        raise AssertionError(f"{label}: logits {max(errs):.3e} from the "
                             f"plain route's (limit {LOGITS_ATOL})")
    return max(errs)


def cpb_selection_gate(label, runs, ref_sels, steps) -> None:
    """9c: every rank's layer-0 selection at each of ``steps`` steps
    (indices and mask) equal to the global route's in one process, bit
    for bit."""
    if len(ref_sels) != steps:
        raise AssertionError(f"{label}: the global route recorded "
                             f"{len(ref_sels)} layer-0 selections, not "
                             f"{steps}")
    for r, got in enumerate(runs):
        sels = got["selections"]
        if len(sels) != steps:
            raise AssertionError(f"{label}: rank {r} recorded {len(sels)} "
                                 f"layer-0 selections, not {steps}")
        for t, ((i, m), (ri, rm)) in enumerate(zip(sels, ref_sels)):
            ri, rm = ri.cpu(), rm.cpu()
            if not (torch.equal(i, ri) and torch.equal(m, rm)):
                raise AssertionError(
                    f"{label}: rank {r}'s layer-0 selection at step {t} "
                    f"differs from one process's in "
                    f"{int((i != ri).sum())} indices and "
                    f"{int((m != rm).sum())} mask entries")


# 9c: Quest's bounds after decode against one process's, on the pages the
# steps wrote in layers past the first (their keys come from attention
# outputs merged in another order than one process's softmax: f32
# rounding); every other page, and every page of layer 0, bit for bit
CPB_BOUNDS_TOL = dict(rtol=1e-5, atol=1e-5)


def cpb_bounds_gate(label, runs, ref_caches, written) -> float:
    """9c: each rank's Quest bounds after decode (``bounds``, a
    ``{kmin, kmax}`` a layer) are its block of one process's
    (``ref_caches``): bitwise but on the ``written`` global pages of
    layers past the first, within CPB_BOUNDS_TOL there.  Returns the
    largest difference on those pages."""
    worst = 0.0
    for r, got in enumerate(runs):
        for layer, bounds in enumerate(got["bounds"]):
            for name, leaf in bounds.items():
                pages = leaf.shape[2]
                ref = ref_caches[layer][name][:, :, r * pages:
                                              (r + 1) * pages].cpu()
                near = torch.zeros(pages, dtype=torch.bool)
                if layer:
                    for p in written:
                        if r * pages <= p < (r + 1) * pages:
                            near[p - r * pages] = True
                if not torch.equal(leaf[:, :, ~near], ref[:, :, ~near]):
                    raise AssertionError(
                        f"{label}: rank {r}'s layer {layer} {name} differs "
                        "from its block of one process's")
                if near.any():
                    a, b = leaf[:, :, near], ref[:, :, near]
                    if not torch.allclose(a, b, **CPB_BOUNDS_TOL):
                        raise AssertionError(
                            f"{label}: rank {r}'s layer {layer} {name} on "
                            "the pages the steps wrote: "
                            f"{float((a - b).abs().max()):.3e} from one "
                            f"process's (tolerance {CPB_BOUNDS_TOL})")
                    worst = max(worst, float((a - b).abs().max()))
    return worst


def cpb_collective_note(runs) -> str:
    """A rank's decode step ms and the share of its gathers and merges
    in it (the steps' all_gather and all_reduce seconds, timed), and the
    bytes each rank posted a step."""
    parts = []
    for r, got in enumerate(runs):
        total = sum(got["step_s"])
        cs = got["collective_s"]
        parts.append(
            f"rank {r}: step ms {step_ms(got['step_s'])}, gathers "
            f"{cs['all_gather'] / total:.3f} and merges "
            f"{cs['all_reduce'] / total:.3f} of the steps' "
            f"{total * 1e3:.1f} ms, "
            f"{got['posted_bytes'] / len(got['step_s']):.0f} B posted a "
            "step")
    return "; ".join(parts)


def cp_backend_check(label, ranks, backend, params, prompt) -> dict:
    """9c's gates for one backend (module docstring) against one process
    holding the whole cache on the global route; the run's numbers."""
    cfg = cp_model_config(backend=backend)
    runs = [r[backend] for r in ranks]
    want = {"flash_prefill": cfg.num_layers}
    if backend != "dense":
        want["flash_decode"] = cfg.num_layers * CPB_STEPS
    launches = cp_launch_gate(label, runs, cfg.num_layers, want)
    toks = runs[0]["tokens"]
    for r, got in enumerate(runs):
        if not torch.equal(got["tokens"], toks):
            raise AssertionError(f"{label}: rank {r}'s tokens differ")
    reset_launches()
    with layer0_selections(cfg.num_layers) as ref_sels:
        ref_toks, ref_steps, prefill_s, step_s, caches = cp_drive(
            cp_model_config((), backend), params, prompt)
    err = cp_logits_gate(label, toks, runs[0]["logits"], ref_toks,
                         ref_steps)
    entry = dict(launches=launches, logits_err=err,
                 prefill_s=[g["prefill_s"] for g in runs],
                 step_ms=[[x * 1e3 for x in g["step_s"]] for g in runs],
                 collective_s=[g["collective_s"] for g in runs],
                 posted_bytes=[g["posted_bytes"] for g in runs],
                 global_step_ms=[x * 1e3 for x in step_s],
                 global_launches=read_launches())
    if backend != "dense":
        cpb_selection_gate(label, runs, ref_sels, CPB_STEPS)
    if backend == "quest":
        ps = cfg.quest.page_size
        written = {p // ps for p in range(CP_PROMPT, CP_PROMPT + CPB_STEPS)}
        entry["bounds_err"] = cpb_bounds_gate(label, runs, caches, written)
    del caches, ref_sels
    log(f"  {label}: tokens {toks[0].tolist()}; launches {launches}; "
        f"logits max |err| {err:.3e} to the global route (limit "
        f"{LOGITS_ATOL}); layer-0 selections "
        f"{'equal at every step' if backend != 'dense' else 'none (dense)'}"
        + (f"; Quest bounds on the written pages {entry['bounds_err']:.3e}"
           if backend == "quest" else "")
        + f"; {cpb_collective_note(runs)}; one process on the global "
        f"route: prefill {prefill_s:.2f} s, step ms {step_ms(step_s)}")
    return entry


def phase_cp_model(dev, seed, card, runs=("socket",) + CPB_BACKENDS
                   ) -> dict:
    """Phases 9b and 9c (see the module docstring): one spawn of the
    ranks, a run each of ``runs``; returns 9b's entry (``socket``) and
    9c's (``backends``, by name) where they ran."""
    import tempfile
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh, spawn_ranks
    from repro_torch.models import transformer as tfm
    cfg = cp_model_config()
    label = (f"cp 9b llama31-8b {cfg.num_layers} of 32 layers, prompt "
             f"{CP_PROMPT}, {CP_STEPS} steps, {CP_WORLD} ranks of "
             f"{CP_CAPACITY // CP_WORLD} rows")
    log(f"{label}: {cfg.param_count() / 1e9:.3f} B params (f32) a rank, "
        f"depth cut to {CP_DEPTH} of 32 layers (4 ranks' replicated "
        "weights and prefills and the reference share one card), widths "
        f"as published; runs {runs}; {card}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
        "reserved")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        card_memory("cp 9b before the ranks", dev)
        spawn_ranks(cp_model_rank, CP_WORLD, (CP_WORLD, tmp, seed, runs),
                    deadline_s=CP_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"cp_model_{r}.pt"))
                 for r in range(CP_WORLD)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, world {CP_WORLD}, "
        f"{torch.cuda.device_count()} card(s), devices "
        f"{[r['device'] for r in ranks]}; peak GB "
        f"{[round(r['peak_gb'], 2) for r in ranks]}; prefill s "
        + "; ".join(f"{run} {[round(r[run]['prefill_s'], 2) for r in ranks]}"
                    for run in runs))
    params = tfm.init_model(cfg, seed, dev)
    prompt = cp_prompt(cfg, seed, dev)
    out = {}
    if "socket" in runs:
        socket_runs = [r["socket"] for r in ranks]
        log(f"  9b decode step ms "
            f"{[step_ms(r['step_s']) for r in socket_runs]}")
        launches = cp_launch_gate(label, socket_runs, cfg.num_layers)
        toks = socket_runs[0]["tokens"]
        for r, got in enumerate(socket_runs):
            if not torch.equal(got["tokens"], toks):
                raise AssertionError(f"{label}: rank {r}'s tokens differ")
        # one process on a 1x1 mesh holds the whole cache; its CP attend
        # is the plain version over CP_WORLD shards
        attend = cp.context_parallel_socket_attend
        cp.context_parallel_socket_attend = cp_plain_attend(CP_WORLD)
        try:
            with activate_mesh(Mesh(("data", "model"), (1, 1))):
                ref_toks, ref_steps = cp_drive(cfg, params, prompt)[:2]
        finally:
            cp.context_parallel_socket_attend = attend
        err = cp_logits_gate(label, toks, socket_runs[0]["logits"],
                             ref_toks, ref_steps)
        # the single-process (non-CP) route fed the same tokens: a union
        # of local top-ks differs from the global top-k by design, so
        # logged
        plain_toks, plain_steps, prefill_s, step_s = cp_drive(
            cp_model_config(()), params, prompt, teacher=toks)[:4]
        dist_plain = max(float((a - b).abs().max()) for a, b in
                         zip(socket_runs[0]["logits"], plain_steps))
        agree = float((plain_toks == toks).float().mean())
        log(f"  {label}: tokens {toks[0].tolist()}; launches {launches}; "
            f"logits max |err| {err:.3e} to the plain single-process route "
            f"(limit {LOGITS_ATOL}); to the non-CP route (teacher-forced) "
            f"{dist_plain:.3e}, greedy agreement {agree:.3f}; one process "
            f"without CP: prefill {prefill_s:.2f} s, step ms "
            f"{step_ms(step_s)}")
        out["socket"] = dict(
            launches=launches, logits_err=err, dist_to_non_cp=dist_plain,
            non_cp_agreement=agree,
            prefill_s=[r["prefill_s"] for r in socket_runs],
            step_ms=[[x * 1e3 for x in r["step_s"]] for r in socket_runs],
            non_cp_step_ms=[x * 1e3 for x in step_s],
            peak_gb=[r["peak_gb"] for r in ranks],
            backend=ranks[0]["backend"])
    backends = [run for run in runs if run != "socket"]
    if backends:
        out["backends"] = {}
    for backend in backends:
        gc.collect()
        torch.cuda.empty_cache()
        out["backends"][backend] = cp_backend_check(
            f"cp 9c {backend} llama31-8b {cfg.num_layers} of 32 layers, "
            f"prompt {CP_PROMPT}, {CPB_STEPS} steps, {CP_WORLD} ranks of "
            f"{CPB_CAPACITY // CP_WORLD} rows", ranks, backend, params,
            prompt)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_cp(dev, seed, card) -> dict:
    """Phase 9: 9a, then 9b and 9c in one spawn; returns the entries of
    the ``socket_score``, ``flash_prefill`` and ``flash_decode`` rows."""
    t0 = time.perf_counter()
    attend = phase_cp_attend(dev, seed, card)
    log(f"cp 9a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model = phase_cp_model(dev, seed, card)
    log(f"cp 9b and 9c: {time.perf_counter() - t0:.1f} s")
    return cp_entries(model, attend)


def cp_entries(model, attend=None) -> dict:
    """The kernel rows' entries of phase 9b's and 9c's runs (``model``,
    :func:`phase_cp_model`'s) and 9a's (``attend``)."""
    out = {}
    if "socket" in model:
        sock = model["socket"]
        out["socket_score"] = dict(attend or {}, launches=sock["launches"][
            "socket_score"], model=sock)
        out["flash_prefill"] = dict(launches=sock["launches"][
            "flash_prefill"])
    backends = model.get("backends", {})
    if backends:
        out.setdefault("flash_prefill", {})["cp_backends"] = sum(
            b["launches"]["flash_prefill"] for b in backends.values())
        out["flash_decode"] = dict(
            launches=sum(b["launches"].get("flash_decode", 0)
                         for b in backends.values()),
            backends=backends)
    return out


# ------------------------------------------------------------ phase 10

MESH_WORLD = 4
MESH_DEADLINE_S = 600
# 10a: llama31-8b at full width, 2 of its 32 layers (as 8a: all 32 in f32
# need 128 GB for weights, gradients and moments), f32, remat full, a
# global batch of 4 x 1024 tokens, 2 steps; each case (mesh (data,
# model), moment bits, accum)
MESH_DEPTH = 2
MESH_ROWS, MESH_SEQ, MESH_STEPS = 4, 1024, 2
MESH_CASES = (((4, 1), 8, 1), ((2, 2), 32, 2))
# each row's share of labels padded (-1): the ranks' valid-token counts
# differ, so a loss over a rank's own count would show
MESH_PAD = (0.0, 0.375, 0.0625, 0.1875)
# 10a's schedule: the CPU tests' (lr 5e-4 at step 1, 1e-3 at step 2), at
# which each step moves every leaf well past the parameter gate's limit
# (an unchanged leaf fails it).  10b, timed, takes the repo's default
# (``ScheduleConfig()``, a deployment's warmup; its gate reads step 0)
MESH_SCHEDULE = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=3)
# 10a's parameter gate, both cases: a rank's block of each leaf no farther
# (L2) from the single-process step's than this share of that step's own
# update of the block (|p_ref - p_0|, L2); an unchanged leaf reads 1.  No
# single element is gated: where a gradient element lies below Adam's eps
# (1e-8) its update is lr x g / eps, so an absolute difference of 1e-10
# in g (float32 sums of a rank's rows run in another order, partial sums
# near 1e-3) moves it by 1 % of lr.  An 8-bit moment's code parts by one
# where its quotient sits on a rounding edge, which moves that element's
# update by up to several lr where the code is small (the cube root's
# slope), so its bound is wider.  Readings at smoke width
# (tests/test_torch_smoke_checks.py's faults, CPU): sound f32 2.3e-5 at
# (2, 2), sound 8-bit 3.9e-4 at (4, 1); the 8-bit moments' block scales
# gathered in another rank order 6.6e-2 at (4, 1), 0.147 at (2, 2); a
# leaf never updated 1.  On the card (PERF.md): sound 8-bit 2.5e-4.
MESH_UPDATE_RTOL = {32: 1e-3, 8: 1e-2}
# 10a's 8-bit moments against one process's, the codes expanded: each
# value within this many codes at the top of its block (one is
# 1 - (126/127)^3 of the block's largest m, 1 - (126/127)^6 of v).  A
# code that parts by one at step 1 moves m by at most one such code, and
# step 2 rounds both routes' values again (about two in all); a code near
# 0 parts by many for the same change (a root's slope near 0: -19 against
# 16 at smoke width, 46 and 65 on the card), and step 2's gradients part
# a little where step 1's updates parted.  Readings: sound m 0.23 and v
# 0.38 codes at smoke width, 2.09 and 1.29 on the card; the block scales
# in another rank order 38 and 19 at smoke width.
MESH_MOMENT_CODES = 5
MESH_TOP_CODE = {"m": 1 - (126 / 127) ** 3, "v": 1 - (126 / 127) ** 6}
# 10b: the deployment numerics, 8 of 32 layers on one card (four ranks'
# bf16 shards and 8-bit moments, each rank's gathered embedding, head
# and their gradients, its 4096-token logits: ~14 GB a rank); all 32
# where four cards hold the ranks
MESH_TIMED_DEPTH = 8
MESH_TIMED_SEQ, MESH_TIMED_STEPS = 4096, 3
# 10c: the JAX package's elastic test (tests/test_distributed.py)
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_FAIL, ELASTIC_LOST = 12, 4, 6, 2
# 10d: rounds of error feedback over one llama31-8b layer's gradients
COMPRESSION_ROUNDS = 3
COMPRESSION_TOL = dict(rtol=1e-6, atol=1e-6)


def _dev_sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def tree_to(tree, device):
    """A copy of a tree of dicts and lists of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def end_rank() -> None:
    """A rank's last call: its mailboxes closed, every rank past that (no
    rank frees a mailbox another still maps), the group destroyed."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    collectives.close_mailboxes()
    dist.barrier()
    dist.destroy_process_group()


def mesh_ocfg(bits, schedule=None):
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    return AdamWConfig(state_bits=bits, schedule=ScheduleConfig(
        **(MESH_SCHEDULE if schedule is None else schedule)))


def mesh_batch(cfg, rows, seq, seed, step, dev):
    """``train_batch`` with row ``r``'s first ``MESH_PAD[r]`` of labels
    padded (-1)."""
    batch = train_batch(cfg, rows, seq, seed, step, dev)
    labels = batch["labels"].clone()
    for r in range(rows):
        labels[r, :int(seq * MESH_PAD[r % len(MESH_PAD)])] = -1
    return {"tokens": batch["tokens"], "labels": labels}


def mesh_train_run(cfg, ocfg, mesh, accum, params, batches, dev) -> dict:
    """One rank's sharded run: its blocks of ``params`` and zero moments
    (``launch/specs.py``'s shardings), one sharded step a batch, launches
    counted from 0.  Returns the metrics (with ``step_s``), the parameter
    blocks on the CPU (``{path: tensor}``), whether every parameter and
    moment block has its spec's shard shape, and the launches."""
    import torch.distributed as dist
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.runtime.steps import make_train_step
    psds, psh = sp.param_specs(cfg, mesh, {})
    osds, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
    flat_p, flat_o = fsdp.flat_tree(psh), fsdp.flat_tree(osh)
    local = fsdp.shard_tree(params, flat_p, dev)
    opt = fsdp.zeros_tree(osds, flat_o, dev)
    step = make_train_step(cfg, ocfg, accum, grad_shardings=psh)
    dist.barrier()
    reset_launches()
    metrics = []
    for batch in batches:
        _dev_sync(dev)
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        _dev_sync(dev)
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        metrics.append(m)
    launches = read_launches()
    shapes = all(
        tuple(t.shape) == flat[p].shard_shape(whole[p].shape)
        for tree, flat, whole in ((local, flat_p, fsdp.flat_tree(psds)),
                                  (opt, flat_o, fsdp.flat_tree(osds)))
        for p, t in fsdp.flat_tree(tree).items())
    codes = {p: t.cpu() for p, t in fsdp.flat_tree(opt).items()
             if p.endswith(("['q']", "['scale']"))}
    return dict(metrics=metrics, shapes=shapes, launches=launches,
                params={p: t.cpu() for p, t in
                        fsdp.flat_tree(local).items()}, codes=codes)


def mesh_metrics_gate(label, ranks_metrics, ref_metrics) -> dict:
    """Every rank's loss and gradient norm at every step within
    TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL of the single-process step's on
    the same weights and batches.  Returns the largest of each."""
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r, ms in enumerate(ranks_metrics):
        if len(ms) != len(ref_metrics):
            raise AssertionError(f"{label}: rank {r} ran {len(ms)} steps, "
                                 f"the reference {len(ref_metrics)}")
        for i, (m, ref) in enumerate(zip(ms, ref_metrics)):
            for k, tol in (("loss", TRAIN_LOSS_RTOL),
                           ("grad_norm", TRAIN_GRAD_RTOL)):
                rel = abs(m[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                if not (math.isfinite(m[k]) and rel <= tol):
                    raise AssertionError(
                        f"{label}: rank {r} step {i} {k} {m[k]!r}, one "
                        f"process {ref[k]!r} (relative {rel:.3e}, limit "
                        f"{tol})")
                worst[k] = max(worst[k], rel)
    return worst


def mesh_params_gate(label, blocks, ref, init, shardings, bits) -> dict:
    """Each rank's parameter blocks (``blocks[r]``: ``{path: tensor}``)
    against their blocks of the single-process step's parameters
    (``ref``) and of the initial ones (``init``; both ``{path: tensor}``;
    ``shardings[r]``: rank ``r``'s ``{path: NamedSharding}``): each
    block's L2 distance from the reference within MESH_UPDATE_RTOL[bits]
    x the L2 size of the reference's own update of it, a frozen leaf's
    block equal to it.  Returns the largest reading and its leaf, and
    (logged, not gated) the largest element's distance over the largest
    element of the leaf's update, with that element's own update over
    the same (an element whose gradient lies below Adam's eps moves less
    than the others)."""
    worst = {"update_rel": 0.0, "update_leaf": None, "element_rel": 0.0,
             "element_update": None, "element_leaf": None}
    for r, got in enumerate(blocks):
        if set(got) != set(ref):
            raise AssertionError(f"{label}: rank {r}'s leaves differ: "
                                 f"{sorted(set(got) ^ set(ref))[:4]}")
        for path, t in got.items():
            want = shardings[r][path].shard(ref[path]).to(t.device).float()
            start = shardings[r][path].shard(init[path]).to(t.device).float()
            diff = (t.float() - want).abs()
            moved = (want - start).abs()
            update = float(torch.linalg.vector_norm(moved))
            dist_ = float(torch.linalg.vector_norm(diff))
            if update == 0.0:
                if dist_ != 0.0:
                    raise AssertionError(
                        f"{label}: rank {r}'s {path}, which one process "
                        f"leaves unchanged, moved {dist_:.3e}")
                continue
            rel = dist_ / update
            if not rel <= MESH_UPDATE_RTOL[bits]:
                raise AssertionError(
                    f"{label}: rank {r}'s {path} {dist_:.3e} from the "
                    f"single-process step's (L2), {rel:.3e} of that step's "
                    f"update {update:.3e} (limit {MESH_UPDATE_RTOL[bits]})")
            if rel > worst["update_rel"]:
                worst.update(update_rel=rel, update_leaf=path)
            top = float(moved.max())
            at = int(diff.argmax())
            el = float(diff.reshape(-1)[at]) / top
            if el > worst["element_rel"]:
                worst.update(element_rel=el, element_leaf=path,
                             element_update=float(moved.reshape(-1)[at]) /
                             top)
    return worst


def mesh_code_report(label, blocks, ref, shardings) -> dict:
    """How many 8-bit moment codes of the ranks' blocks (``blocks[r]``:
    ``{path: tensor}``, each moment's ``q`` and ``scale``) differ from
    their blocks of the single-process state's (``ref``, alike), the
    largest difference, and for ``m`` and ``v`` the largest difference of
    the moments themselves (the codes expanded, powers 3 and 6) over
    their block's largest value: a code near 0 moves far for a small
    change of the value (the root's slope), a fault moves the values.
    Gated: those values within MESH_MOMENT_CODES codes at the top of a
    block."""
    from repro_torch.distributed.sharding import entry_axes
    n = differ = worst = 0
    value = {"m": 0.0, "v": 0.0}
    for r, got in enumerate(blocks):
        for path, t in got.items():
            if not path.endswith("['q']"):
                continue
            want = shardings[r][path].shard(ref[path])
            d = (t.int() - want.int()).abs()
            n += d.numel()
            differ += int((d > 0).sum())
            worst = max(worst, int(d.max()))
            spath = path[:-len("['q']")] + "['scale']"
            sg, sw = got[spath], shardings[r][spath].shard(ref[spath])
            # the scales of this rank's blocks of the row (its q may hold
            # a share of the row's blocks; the scales hold the whole row)
            qsh = shardings[r][path]
            axes = entry_axes(qsh.spec[-1])
            parts = qsh.mesh.extent(axes)
            nbl = sg.shape[-1] // parts
            lo = qsh.mesh.index(axes) * nbl if parts > 1 else 0
            sg, sw = sg[..., lo:lo + nbl], sw[..., lo:lo + nbl]
            kind = path[2]
            power = 3 if kind == "m" else 6

            def expand(q, scale):
                a = q.float().unflatten(-1, (nbl, -1)) * scale[..., None]
                return torch.sign(a) * a.abs().pow(power)

            top = (torch.maximum(sg, sw) * 127.0).pow(power)[..., None]
            rel = (expand(t, sg) - expand(want, sw)).abs() / \
                top.clamp(min=1e-30)
            value[kind] = max(value[kind], float(rel.max()))
    for kind, v in value.items():
        if not v <= MESH_MOMENT_CODES * MESH_TOP_CODE[kind]:
            raise AssertionError(
                f"{label}: an 8-bit {kind} moment {v:.3e} of its block's "
                f"largest value from the single-process state's, "
                f"{v / MESH_TOP_CODE[kind]:.1f} codes at the top of a block "
                f"(limit {MESH_MOMENT_CODES})")
    return dict(codes=n, differing=differ, max_code_diff=worst,
                max_value_diff_of_block_max=value,
                max_value_diff_codes={k: v / MESH_TOP_CODE[k]
                                      for k, v in value.items()})


def mesh_launch_gate(label, ranks, layers, calls) -> int:
    """``flash_prefill`` launched ``layers`` x ``calls`` times on every
    rank, and no other kernel."""
    for r, got in enumerate(ranks):
        launch_gate(f"{label} rank {r}", got["launches"], "flash_prefill",
                    layers, calls)
    return sum(got["launches"]["flash_prefill"] for got in ranks)


def mesh_shardings(cfg, shape, rank) -> dict:
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    return fsdp.flat_tree(sp.param_specs(
        cfg, Mesh(("data", "model"), shape, rank=rank), {})[1])


def mesh_opt_shardings(cfg, shape, rank, bits) -> dict:
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data", "model"), shape, rank=rank)
    psds, psh = sp.param_specs(cfg, mesh, {})
    return fsdp.flat_tree(sp.opt_specs(mesh_ocfg(bits), psds, psh, mesh,
                                       {})[1])


def mesh_config(arch="llama31-8b", depth=MESH_DEPTH):
    from repro_torch.configs import get_config
    return get_config(arch).replace(num_groups=depth, remat_policy="full")


def compression_grads(seed, rank, rnd, dev) -> dict:
    """Rank ``rank``'s gradients of one llama31-8b layer's shapes in
    round ``rnd``, drawn from ``seed``."""
    from repro_torch.configs import get_config
    cfg = get_config("llama31-8b")
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d), "w_gate": (d, ff), "w_up": (d, ff),
              "w_down": (ff, d), "norm": (d,)}
    gen = torch.Generator(device=dev).manual_seed(
        seed * 7919 + 17 + 131 * rnd + rank)
    return {k: torch.randn(s, generator=gen, device=dev) * 1e-3 * (rank + 1)
            for k, s in shapes.items()}


def compression_round_check(label, rank, rnd, synced, errors, grads,
                            ref_errors) -> Tuple[dict, list]:
    """Round ``rnd`` of rank ``rank``'s ``compressed_psum`` (its
    ``synced`` mean and new ``errors``) against ``compressed_psum_ref``
    over every rank's gradients of the round (``grads[r]``) and error
    buffers (``ref_errors[r]``), a leaf at a time: the payloads and
    scales of its corrected gradients equal the plain version's, the mean
    and its error buffers within COMPRESSION_TOL.  Returns the largest
    differences and the plain version's new error buffers."""
    from repro_torch.distributed import compression as cm
    worst = {"synced": 0.0, "errors": 0.0}
    new_errors = [dict() for _ in grads]
    for k in grads[rank]:
        mean, errs, payloads = cm.compressed_psum_ref(
            [{k: g[k]} for g in grads], [{k: e[k]} for e in ref_errors])
        c = cm.compress_leaf(grads[rank][k].float() + ref_errors[rank][k])
        if not (torch.equal(c["q"], payloads[rank][k]["q"]) and
                torch.equal(c["scale"], payloads[rank][k]["scale"])):
            raise AssertionError(f"{label}: rank {rank} round {rnd} {k}'s "
                                 "payload is not the plain version's")
        for name, got, ref in (("synced", synced[k], mean[k]),
                               ("errors", errors[k], errs[rank][k])):
            if not torch.allclose(got, ref, **COMPRESSION_TOL):
                raise AssertionError(f"{label}: rank {rank} round {rnd} "
                                     f"{name} {k} off the plain version")
            worst[name] = max(worst[name], float((got - ref).abs().max()))
        for r, e in enumerate(errs):
            new_errors[r][k] = e[k]
        del mean, errs, payloads
    return worst, new_errors


def compression_run(label, rank, world, dev, seed, group) -> dict:
    """10d on one rank: COMPRESSION_ROUNDS rounds of ``compressed_psum``
    over ``group``, each checked against the plain version
    (:func:`compression_round_check`; every rank draws every rank's
    gradients of the round) and timed; the error feedback must carry
    (round 2's buffers are not round 1's)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as cm
    errors = ref_errors = None
    worst = {"synced": 0.0, "errors": 0.0}
    seconds, first = [], None
    for rnd in range(COMPRESSION_ROUNDS):
        grads = [compression_grads(seed, r, rnd, dev) for r in range(world)]
        if errors is None:
            errors = cm.init_error_buffers(grads[rank])
            ref_errors = [cm.init_error_buffers(g) for g in grads]
        if group is not None:
            dist.barrier(group=group)
        _dev_sync(dev)
        t0 = time.perf_counter()
        synced, errors = cm.compressed_psum(grads[rank], errors, group)
        _dev_sync(dev)
        seconds.append(time.perf_counter() - t0)
        w, ref_errors = compression_round_check(
            label, rank, rnd, synced, errors, grads, ref_errors)
        worst = {k: max(worst[k], w[k]) for k in worst}
        if rnd == 0:
            first = errors["wq"].clone()
        elif rnd == 1 and torch.equal(first, errors["wq"]):
            raise AssertionError(f"{label}: the error buffers did not "
                                 "carry")
        del grads, synced
    return dict(worst, round_s=seconds)


def mesh_parity_rank(rank, world, tmp, seed) -> None:
    """10a and 10d on one rank (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, dev = init_rank(rank, world, f"file://{tmp}/init10a", "cuda")
    meshes = {shape: make_test_mesh(*shape)
              for shape in sorted({c[0] for c in MESH_CASES})}
    cfg = mesh_config()
    # the whole model on the host, each case's blocks cut from it
    params = tree_to(tfm.init_model(cfg, seed, dev), "cpu")
    torch.cuda.empty_cache()
    batches = [mesh_batch(cfg, MESH_ROWS, MESH_SEQ, seed, i, dev)
               for i in range(MESH_STEPS)]
    res = {"backend": backend, "device": str(dev)}
    for shape, bits, accum in MESH_CASES:
        torch.cuda.reset_peak_memory_stats(dev)
        run = mesh_train_run(cfg, mesh_ocfg(bits), meshes[shape], accum,
                             params, batches, dev)
        run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        res[(shape, bits, accum)] = run
        if rank == 0:
            log(f"  mesh 10a rank 0, mesh {shape}, {bits}-bit moments, "
                f"accum {accum}: step s "
                f"{[round(m['step_s'], 3) for m in run['metrics']]}, peak "
                f"{run['peak_gb']:.2f} GB; card to card "
                f"{collectives.PEER_COPIED}")
        gc.collect()
        torch.cuda.empty_cache()
    res["peer_copied"] = dict(collectives.PEER_COPIED)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["compression"] = compression_run(
        "mesh 10d", rank, world, dev, seed, meshes[(4, 1)].group(("data",)))
    torch.save(res, os.path.join(tmp, f"mesh10a_{rank}.pt"))
    end_rank()


def phase_mesh_parity(dev, seed, card) -> dict:
    """Phases 10a and 10d (see the module docstring)."""
    import tempfile
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_adamw
    from repro_torch.runtime.steps import make_train_step
    cfg = mesh_config()
    label = (f"mesh 10a llama31-8b {cfg.num_layers} of 32 layers, f32, "
             f"{MESH_ROWS} x {MESH_SEQ} tokens, {MESH_STEPS} steps")
    log(f"{label}: {cfg.param_count() / 1e9:.3f} B params; depth cut to "
        f"{MESH_DEPTH} of 32 layers (all 32 in f32 need 128 GB for weights, "
        f"gradients and moments); {MESH_WORLD} ranks, backend "
        f"{collective_backend(MESH_WORLD, 'cuda')}; {card}")
    refs = {}
    with phase_clock("mesh 10a single-process references", dev):
        params = tfm.init_model(cfg, seed, dev)
        init = {path: t.cpu() for path, t in fsdp.flat_tree(params).items()}
        batches = [mesh_batch(cfg, MESH_ROWS, MESH_SEQ, seed, i, dev)
                   for i in range(MESH_STEPS)]
        for shape, bits, accum in MESH_CASES:
            p = tree_to(params, dev)
            ocfg = mesh_ocfg(bits)
            opt = init_adamw(ocfg, p)
            step = make_train_step(cfg, ocfg, accum)
            ms = []
            for b in batches:
                p, opt, m = step(p, opt, b)
                ms.append({k: float(v) for k, v in m.items()})
            refs[shape, bits, accum] = (ms, {
                path: t.cpu() for path, t in fsdp.flat_tree(p).items()}, {
                path: t.cpu() for path, t in fsdp.flat_tree(opt).items()
                if path.endswith(("['q']", "['scale']"))})
            del p, opt, step
            gc.collect()
            torch.cuda.empty_cache()
        del params, batches
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        card_memory("mesh 10a before the ranks", dev)
        spawn_ranks(mesh_parity_rank, MESH_WORLD, (MESH_WORLD, tmp, seed),
                    deadline_s=MESH_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"mesh10a_{r}.pt"),
                            weights_only=False) for r in range(MESH_WORLD)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}; "
        f"collectives card to card (a rank's mailbox): "
        f"{ranks[0]['peer_copied']}")
    entry = {}
    for shape, bits, accum in MESH_CASES:
        case = f"{shape[0]}x{shape[1]}-b{bits}-a{accum}"
        name = f"mesh 10a {case}"
        got = [r[shape, bits, accum] for r in ranks]
        if not all(g["shapes"] for g in got):
            raise AssertionError(f"{name}: a rank holds a block off its "
                                 "spec's shard shape")
        ref_ms, ref_params, ref_codes = refs.pop((shape, bits, accum))
        worst = mesh_metrics_gate(name, [g["metrics"] for g in got], ref_ms)

        def on_card(tree):        # the comparisons run on the card
            return {p: t.to(dev) for p, t in tree.items()}

        if ref_codes:
            osh = [mesh_opt_shardings(cfg, shape, r, bits)
                   for r in range(MESH_WORLD)]
            report = mesh_code_report(name,
                                      [on_card(g.pop("codes")) for g in got],
                                      on_card(ref_codes), osh)
            log(f"  {name}: 8-bit moments against one process's (values "
                f"within {MESH_MOMENT_CODES} codes at a block's top): "
                f"{report}")
        perr = mesh_params_gate(
            name, [on_card(g.pop("params")) for g in got],
            on_card(ref_params), on_card(init),
            [mesh_shardings(cfg, shape, r) for r in range(MESH_WORLD)], bits)
        del ref_params, ref_codes
        torch.cuda.empty_cache()
        launches = mesh_launch_gate(name, got, cfg.num_layers,
                                    accum * 2 * MESH_STEPS)
        step_s = [[m["step_s"] for m in g["metrics"]] for g in got]
        log(f"  {name}: losses {[m['loss'] for m in got[0]['metrics']]} "
            f"(one process {[m['loss'] for m in ref_ms]}); largest "
            f"relative loss {worst['loss']:.3e} (limit {TRAIN_LOSS_RTOL}), "
            f"grad norm {worst['grad_norm']:.3e} (limit {TRAIN_GRAD_RTOL}); "
            f"parameters: the largest block L2 distance "
            f"{perr['update_rel']:.3e} of the one-process step's update "
            f"({perr['update_leaf']}; limit {MESH_UPDATE_RTOL[bits]}); the "
            f"largest element {perr['element_rel']:.3e} of its leaf's "
            f"largest update ({perr['element_leaf']}; not gated), that "
            f"element's own update {perr['element_update']:.3e} of it; "
            f"flash_prefill {launches} launches "
            f"({cfg.num_layers} layers x {accum} microbatches x 2 x "
            f"{MESH_STEPS} steps a rank); a rank's step s {step_s[0]}; "
            f"peak GB {[round(g['peak_gb'], 2) for g in got]}")
        entry[case] = dict(worst, params=perr, launches=launches,
                           step_s=step_s,
                           peak_gb=[g["peak_gb"] for g in got])
        del got
    comp = [r["compression"] for r in ranks]
    log(f"mesh 10d compressed_psum, {MESH_WORLD} ranks, one llama31-8b "
        f"layer's gradient shapes, {COMPRESSION_ROUNDS} rounds: payloads "
        "equal the plain version's; largest |synced - plain| "
        f"{max(c['synced'] for c in comp):.3e}, |errors - plain| "
        f"{max(c['errors'] for c in comp):.3e} (COMPRESSION_TOL "
        f"{COMPRESSION_TOL}); a round on rank 0 "
        f"{[round(x, 3) for x in comp[0]['round_s']]} s (an all-reduce "
        "of float32, " + ("through the ranks' mailboxes under gloo)"
                          if ranks[0]["backend"] == "gloo" else
                          "on the cards under NCCL)"))
    entry["compression"] = dict(
        synced_err=max(c["synced"] for c in comp),
        errors_err=max(c["errors"] for c in comp),
        round_s=[c["round_s"] for c in comp])
    entry["backend"] = ranks[0]["backend"]
    return entry


def timed_mesh_config(depth):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES, dryrun_model_config
    return dryrun_model_config(get_config("llama31-8b"),
                               SHAPES["train_4k"]).replace(num_groups=depth)


def mesh_timed_rank(rank, world, tmp, seed, depth) -> None:
    """10b on one rank: its blocks drawn as the Trainer draws them
    (``fsdp.init_shards``), MESH_TIMED_STEPS steps of one 4096-token
    sequence a rank, the last with the collectives timed."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.runtime.steps import make_train_step
    backend, dev = init_rank(rank, world, f"file://{tmp}/init10b", "cuda")
    mesh = make_test_mesh(world, 1)
    cfg = timed_mesh_config(depth)
    ocfg = mesh_ocfg(8, schedule={})
    psds, psh = sp.param_specs(cfg, mesh, {})
    osds, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
    # the Trainer's init: a unit of the model at a time, cut to this
    # rank's blocks
    local = fsdp.init_shards(cfg, seed, fsdp.flat_tree(psh), dev)
    gc.collect()
    torch.cuda.empty_cache()
    opt = fsdp.zeros_tree(osds, fsdp.flat_tree(osh), dev)
    step = make_train_step(cfg, ocfg, 1, grad_shardings=psh)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    reset_launches()
    metrics = []
    for i in range(MESH_TIMED_STEPS):
        batch = train_batch(cfg, world, MESH_TIMED_SEQ, seed, i, dev)
        timed = i == MESH_TIMED_STEPS - 1
        collectives.TIMING["on"] = timed
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize(dev)
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        metrics.append(m)
        if rank == 0:
            log(f"  mesh 10b rank 0 step {i}: loss {m['loss']:.6f}, "
                f"{m['step_s']:.3f} s" + (" (collectives timed)" if timed
                                          else ""))
    collectives.TIMING["on"] = False
    torch.save(dict(metrics=metrics, launches=read_launches(),
                    collective_s=dict(collectives.SECONDS),
                    peer_copied=dict(collectives.PEER_COPIED),
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    backend=backend, device=str(dev)),
               os.path.join(tmp, f"mesh10b_{rank}.pt"))
    end_rank()


def phase_mesh_timed(dev, seed, card) -> dict:
    """Phase 10b (see the module docstring)."""
    import tempfile
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    from repro_torch.models import transformer as tfm
    backend = collective_backend(MESH_WORLD, "cuda")
    depth = 32 if backend == "nccl" else MESH_TIMED_DEPTH
    cfg = timed_mesh_config(depth)
    label = (f"mesh 10b llama31-8b {cfg.num_layers} of 32 layers, bf16, "
             f"remat full, 8-bit moments, (4, 1), {MESH_TIMED_SEQ} tokens a "
             "rank")
    log(f"{label}: {cfg.param_count() / 1e9:.3f} B params; "
        + ("full depth, a card a rank" if depth == 32 else
           f"depth cut to {depth} of 32 layers (four ranks' shards, "
           "moments, gathered embedding and head and logits on one card)")
        + f"; backend {backend}; {card}")
    with phase_clock("mesh 10b single-process forwards (bf16, float32)",
                     dev), torch.no_grad():
        params = tfm.init_model(cfg, seed, dev)
        batch = train_batch(cfg, MESH_WORLD, MESH_TIMED_SEQ, seed, 0, dev)
        loss_bf16 = float(tfm.loss_and_metrics(cfg, params, batch)[0])
        loss_f32 = float(tfm.loss_and_metrics(f32_reference(cfg), params,
                                              batch)[0])
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(mesh_timed_rank, MESH_WORLD,
                    (MESH_WORLD, tmp, seed, depth),
                    deadline_s=MESH_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"mesh10b_{r}.pt"),
                            weights_only=False) for r in range(MESH_WORLD)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}")
    if torch.cuda.device_count() < MESH_WORLD:
        log(f"  the {MESH_WORLD} ranks share one card: their times are that "
            "card's under four processes, not a measure of scaling")
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    mesh_d = abs(losses[0] - loss_f32)
    single_d = abs(loss_bf16 - loss_f32)
    if not (all(math.isfinite(x) for x in losses) and
            mesh_d <= F64_RATIO * single_d):
        raise AssertionError(
            f"{label}: step 0's loss {losses[0]!r} lies {mesh_d:.3e} from "
            f"a float32 run of the same weights ({loss_f32!r}), more than "
            f"{F64_RATIO} x the single-process bf16 step's {single_d:.3e}")
    for r, got in enumerate(ranks):
        if [m["loss"] for m in got["metrics"]] != losses:
            raise AssertionError(f"{label}: rank {r}'s losses differ")
    launches = mesh_launch_gate(label, ranks, cfg.num_layers,
                                2 * MESH_TIMED_STEPS)
    step_s = min(max(r["metrics"][i]["step_s"] for r in ranks)
                 for i in range(1, MESH_TIMED_STEPS - 1)) \
        if MESH_TIMED_STEPS > 2 else ranks[0]["metrics"][-1]["step_s"]
    timed_s = max(r["metrics"][-1]["step_s"] for r in ranks)
    coll = {k: max(r["collective_s"][k] for r in ranks)
            for k in ranks[0]["collective_s"]}
    tokens = MESH_WORLD * MESH_TIMED_SEQ
    out = dict(loss=losses, loss_f32=loss_f32, loss_bf16_single=loss_bf16,
               f32_distance=mesh_d, single_f32_distance=single_d,
               step_s=step_s, tokens_per_s=tokens / step_s,
               peak_gb=[r["peak_gb"] for r in ranks],
               timed_step_s=timed_s, collective_s=coll,
               collective_share={k: v / timed_s for k, v in coll.items()},
               peer_copied=ranks[0]["peer_copied"], launches=launches,
               backend=ranks[0]["backend"], layers=cfg.num_layers,
               card=card)
    log(f"  {label}: losses {losses}; step 0 {mesh_d:.3e} from float32, "
        f"the single-process bf16 step {single_d:.3e} (the mesh's at most "
        f"{F64_RATIO}x); step {step_s:.3f} s, {tokens / step_s:.1f} "
        f"tokens/s over {MESH_WORLD} ranks; each rank's peak GB "
        f"{[round(r['peak_gb'], 2) for r in ranks]} (one process at full "
        "depth, phase 8c: 57.20 GB); the instrumented step "
        f"{timed_s:.3f} s, of it gathers {coll['all_gather']:.3f} s, "
        f"reduce-scatters {coll['reduce_scatter']:.3f} s, all-reduces "
        f"{coll['all_reduce']:.3f} s; flash_prefill {launches} launches; "
        f"card to card {ranks[0]['peer_copied']}")
    log(json.dumps({"mesh_10b": out}))
    return out


def elastic_rank(rank, world, tmp, seed) -> None:
    """10c on one rank: the Trainer over the 4 ranks, ELASTIC_LOST of
    them lost at step ELASTIC_FAIL."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import init_rank
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig
    backend, dev = init_rank(rank, world, f"file://{tmp}/init10c", "cuda")

    class Spy(Trainer):
        """Keeps a host copy of what each restore placed on this rank."""

        def _setup(self, restore):
            super()._setup(restore)
            if restore and self.active:
                from repro_torch.distributed import fsdp
                self.restored = (self.step, {
                    p: t.to("cpu", copy=True) for p, t in fsdp.flat_tree(
                        {"params": self.params, "opt": self.opt_state}
                    ).items()})

    cfg = get_config("minitron-8b").smoke().replace(
        num_groups=1, attention_backend="dense")
    ocfg = AdamWConfig(schedule=ScheduleConfig(
        peak_lr=1e-3, warmup_steps=2, decay_steps=ELASTIC_STEPS))
    tr = Spy(cfg, ocfg, TrainLoopConfig(total_steps=ELASTIC_STEPS,
                                        checkpoint_every=ELASTIC_EVERY,
                                        seed=seed),
             DataConfig(seq_len=32, global_batch=8,
                        vocab_size=cfg.vocab_size),
             os.path.join(tmp, "ckpt"), device=dev,
             injector=FailureInjector(
                 {ELASTIC_FAIL: f"lose_device:{ELASTIC_LOST}"}))
    first = tr.mesh.size
    log_ = tr.run()
    torch.save(dict(first_mesh=first, active=tr.active, step=tr.step,
                    rebuilds=tr.rebuild_count, steps=[m["step"] for m in
                                                      log_],
                    mesh=None if tr.mesh is None else list(tr.mesh.ranks),
                    restored=getattr(tr, "restored", None),
                    backend=backend),
               os.path.join(tmp, f"mesh10c_{rank}.pt"))
    end_rank()


def elastic_gate(label, ranks, saved, shardings) -> None:
    """10c's gates: every rank rebuilt once from a mesh of MESH_WORLD
    ranks; the first MESH_WORLD - ELASTIC_LOST ranks on a mesh of them
    reached ELASTIC_STEPS, their restored blocks (``ranks[r]["restored"]``)
    equal to their blocks of the checkpoint ``saved`` (a whole tree;
    ``shardings[r]``, rank r's ``{path: NamedSharding}`` on the new mesh)
    bit for bit; the others left the loop at the rebuild."""
    from repro_torch.distributed import fsdp
    keep = MESH_WORLD - ELASTIC_LOST
    whole = fsdp.flat_tree(saved["tree"])
    for r, got in enumerate(ranks):
        if got["first_mesh"] != MESH_WORLD or got["rebuilds"] != 1:
            raise AssertionError(f"{label}: rank {r} started on "
                                 f"{got['first_mesh']} ranks and rebuilt "
                                 f"{got['rebuilds']} times")
        if r >= keep:
            if got["active"] or got["restored"] is not None:
                raise AssertionError(f"{label}: rank {r} did not leave")
            continue
        if not got["active"] or got["step"] != ELASTIC_STEPS or \
                got["mesh"] != list(range(keep)):
            raise AssertionError(f"{label}: rank {r} ended at step "
                                 f"{got['step']} on ranks {got['mesh']}")
        step, tree = got["restored"]
        if step != saved["step"] or set(tree) != set(whole):
            raise AssertionError(f"{label}: rank {r} restored step {step}")
        for path, t in tree.items():
            want = shardings[r][path].shard(whole[path])
            if t.dtype != want.dtype or not torch.equal(t, want):
                raise AssertionError(f"{label}: rank {r}'s restored {path} "
                                     "is not its block of the checkpoint")


def phase_mesh_elastic(dev, seed, card) -> dict:
    """Phase 10c (see the module docstring)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh, spawn_ranks
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    label = (f"mesh 10c elastic Trainer, minitron-8b smoke, {MESH_WORLD} -> "
             f"{MESH_WORLD - ELASTIC_LOST} ranks at step {ELASTIC_FAIL}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(elastic_rank, MESH_WORLD, (MESH_WORLD, tmp, seed),
                    deadline_s=MESH_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"mesh10c_{r}.pt"),
                            weights_only=False) for r in range(MESH_WORLD)]
        restored_step = ranks[0]["restored"][0]
        saved = Checkpointer(os.path.join(tmp, "ckpt")).restore(
            step=restored_step)
    cfg = get_config("minitron-8b").smoke().replace(
        num_groups=1, attention_backend="dense")
    ocfg = AdamWConfig(schedule=ScheduleConfig(
        peak_lr=1e-3, warmup_steps=2, decay_steps=ELASTIC_STEPS))
    keep = MESH_WORLD - ELASTIC_LOST
    shardings = []
    for r in range(keep):
        mesh = Mesh(("data", "model"), (keep, 1), rank=r, ranks=range(keep))
        psds, psh = sp.param_specs(cfg, mesh, {})
        shardings.append(fsdp.flat_tree({"params": psh, "opt": sp.opt_specs(
            ocfg, psds, psh, mesh, {})[1]}))
    elastic_gate(label, ranks, saved, shardings)
    secs = time.perf_counter() - t0
    log(f"  {label}: 1 rebuild, ranks {ranks[0]['mesh']} reached step "
        f"{ELASTIC_STEPS} (steps {ranks[0]['steps']}), restored step "
        f"{restored_step} bit for bit; ranks {list(range(keep, MESH_WORLD))} "
        f"left and exited 0; backend {ranks[0]['backend']}; {secs:.1f} s")
    return dict(steps=ranks[0]["steps"], restored_step=restored_step,
                seconds=secs, backend=ranks[0]["backend"])


def phase_mesh(dev, seed, card) -> dict:
    """Phase 10: 10a and 10d, 10b, 10c; returns the ``flash_prefill``
    row's ``mesh`` entry."""
    out = {}
    for name, fn in (("10a", phase_mesh_parity), ("10b", phase_mesh_timed),
                     ("10c", phase_mesh_elastic)):
        t0 = time.perf_counter()
        out[name] = fn(dev, seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh {name}: {time.perf_counter() - t0:.1f} s")
    out["launches"] = out["10b"]["launches"] + sum(
        out["10a"][f"{shape[0]}x{shape[1]}-b{bits}-a{accum}"]["launches"]
        for shape, bits, accum in MESH_CASES)
    return out


# ------------------------------------------------------------ phase 11

# 11a: mixtral-8x22b at full width (d 6144, 8 experts of d_ff 16384, its
# published "tp" storage) with moe_dispatch="alltoall", as the JAX
# package's dry run sets it for training cells, on a (2, 2) mesh
EP_WORLD, EP_MESH = 4, (2, 2)
EP_DEADLINE_S = 420
# the f32 parity run: 1 of 56 layers (one layer is 2.5 B parameters),
# 4 rows x 128 tokens, 2 steps, remat full, 8-bit moments, dropless: at
# a capacity factor of ``model`` (2) a page holds every assignment a rank
# makes (the JAX package's test takes 8 at model 4).  Four ranks' f32
# shards, gathered experts and their gradients with 32-bit moments, or
# 8 with its four times wider expert buffers, do not fit on one card
EP_DEPTH = 1
EP_ROWS, EP_SEQ, EP_STEPS = 4, 128, 2
EP_CF = 2.0
EP_BITS = 8
# the drops case: one MoE layer's exchange at capacity factor 1.0 against
# the plain single-process exchange (``apply_moe_alltoall_ref``), the same
# products on the same card (a slot moved by an unstable sort moves a
# token's output by its whole size)
EP_DROP_ROWS, EP_DROP_SEQ = 2, 512
EP_DROP_REL = 1e-6
# the bf16 timed run: remat full, 8-bit moments, 2 of 56 layers, one
# 2048-token row a data rank (four ranks' shards, gathered experts, their
# gradients and a 4096-token row's expert buffers and logits do not fit
# on one card), mixtral's capacity factor
EP_TIMED_DEPTH = 2
EP_TIMED_SEQ, EP_TIMED_STEPS = 2048, 3
# 11b: llama31-8b's blocks as 4 stages, 8 microbatches of one row
PIPE_STAGES, PIPE_MICRO = 4, 8
PIPE_DEADLINE_S = 300
# the f32 parity run: 2 layers a stage, 512 tokens a row
PIPE_PER_STAGE, PIPE_SEQ = 2, 512
# the output's and each gradient leaf's relative L2 distance from the
# sequential stack's: a microbatch of one row runs other product shapes
# than the whole batch (cuBLAS picks its kernels by shape), float32
PIPE_OUT_REL, PIPE_GRAD_REL = 1e-5, 1e-4
# the bf16 timed run: full depth (8 layers a stage), 4096 tokens a row,
# forward, the first run a warm-up
PIPE_TIMED_SEQ, PIPE_TIMED_RUNS = 4096, 3
# 11c: hybrid SOCKET models under a CP mesh, weights replicated per rank
# at bf16 (dryrun_model_config's decode numerics): (arch, groups, ranks);
# gemma3-27b 1 of 10 groups (5 local, 1 global) on 4 ranks, ~8 GB a
# rank; jamba-v0.1-52b 1 of 4 groups on 2 ranks, ~27 GB a rank (four
# copies do not fit on one card).  CP_PROMPT tokens, CP_STEPS greedy
# steps
CPH_CASES = (("gemma3-27b", 1, 4), ("jamba-v0.1-52b", 1, 2))
CPH_DEADLINE_S = 420


def ep_config(depth=EP_DEPTH, dispatch="alltoall"):
    from repro_torch.launch.serve import card_config
    return card_config("mixtral-8x22b").replace(
        num_groups=depth, moe_dispatch=dispatch, capacity_factor=EP_CF,
        remat_policy="full")


def ep_timed_config(depth=EP_TIMED_DEPTH):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES, dryrun_model_config
    return dryrun_model_config(get_config("mixtral-8x22b"),
                               SHAPES["train_4k"]).replace(
        num_groups=depth, moe_dispatch="alltoall")


@contextlib.contextmanager
def expert_spy():
    """Records the shape and bytes of every expert leaf the sharded step
    gathers (``fsdp.gather_experts``): a rank's own experts only."""
    from repro_torch.distributed import fsdp
    seen = []
    orig = fsdp.gather_experts

    def spy(local, sharding):
        out = orig(local, sharding)
        seen.append((tuple(out.shape), out.numel() * out.element_size()))
        return out
    fsdp.gather_experts = spy
    try:
        yield seen
    finally:
        fsdp.gather_experts = orig


def expert_bytes_gate(label, cfg, blocks, gathered) -> dict:
    """Each rank's stored block of every expert leaf is a quarter of the
    leaf (``d_ff`` over ``model``, ``d`` over ``data``) and every expert
    leaf it gathered for the exchange holds its E / model experts whole:
    E / model x d x d_ff elements."""
    e, model = cfg.num_experts, EP_MESH[1]
    whole = e * cfg.d_model * cfg.d_ff
    for r, (blk, seen) in enumerate(zip(blocks, gathered)):
        leaves = {p: t for p, t in blk.items() if "['moe']['w_" in p}
        if len(leaves) != 3 * cfg.num_layers:
            raise AssertionError(f"{label}: rank {r} holds {len(leaves)} "
                                 "expert leaves")
        for p, n in leaves.items():
            if n != whole // EP_WORLD:
                raise AssertionError(f"{label}: rank {r}'s {p} holds {n} "
                                     f"elements, not {whole // EP_WORLD}")
        own = whole // model
        bad = [s for s in seen if s[0][0] != e // model or
               math.prod(s[0]) != own]
        if not seen or bad:
            raise AssertionError(f"{label}: rank {r} gathered expert "
                                 f"leaves {bad or 'none'}, each must be its "
                                 f"{e // model} experts ({own} elements)")
    return {"stored_elements": whole // EP_WORLD,
            "gathered_shape": gathered[0][0][0],
            "gathered_bytes": gathered[0][0][1]}


@contextlib.contextmanager
def plain_exchange(mesh_shape=EP_MESH):
    """One process's MoE layers (``T > 1``) through the plain exchange
    (``apply_moe_alltoall_ref`` on a ``mesh_shape`` mesh): at a dropless
    capacity factor global dispatch's outputs, and the aux losses the
    mean of the ranks' token blocks' (JAX's ``pmean``), which the
    global batch's load-balance loss is not."""
    from repro_torch.models import moe
    orig = moe.apply_moe

    def plain(cfg, params, x, split=None):
        if x.shape[1] > 1:
            return moe.apply_moe_alltoall_ref(cfg, params, x, *mesh_shape)
        return orig(cfg, params, x, split)
    moe.apply_moe = plain
    try:
        yield
    finally:
        moe.apply_moe = orig


def ep_parity_run(cfg, mesh, params, batches, dev) -> dict:
    """One rank's sharded steps (``mesh_train_run``, EP_BITS moments,
    accum 1) with the expert leaves it gathers recorded (their first
    forward's) and each stored block's element count."""
    with expert_spy() as seen:
        run = mesh_train_run(cfg, mesh_ocfg(EP_BITS), mesh, 1, params,
                             batches, dev)
    run["gathered"] = seen[:3 * cfg.num_layers]
    run["stored"] = {p: t.numel() for p, t in run["params"].items()}
    return run


def ep_drop_case(cfg, seed, dev, rows=EP_DROP_ROWS, seq=EP_DROP_SEQ):
    """11a's drops case: ``cfg``'s MoE layer at capacity factor 1.0 (its
    weights drawn from the seed) and a whole batch of tokens."""
    from repro_torch.models import moe
    from repro_torch.models import param as pm
    cfg = cfg.replace(capacity_factor=1.0)
    params = pm.unbox(moe.init_moe(cfg, pm.generator(seed + 5, dev)))
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    x = torch.randn(rows, seq, cfg.d_model, generator=gen, device=dev)
    return cfg, params, x


@contextlib.contextmanager
def slot_spy():
    """Counts the assignments ``models/moe.py``'s exchange drops (its
    ``_sort_slots``'s keep masks)."""
    from repro_torch.models import moe
    dropped = [0]
    orig = moe._sort_slots

    def spy(ids, count, capacity):
        keep, slot = orig(ids, count, capacity)
        dropped[0] += int((~keep).sum())
        return keep, slot
    moe._sort_slots = spy
    try:
        yield dropped
    finally:
        moe._sort_slots = orig


@torch.no_grad()
def ep_drop_run(cfg, params, x, mesh) -> dict:
    """The drops case through the exchange under ``mesh`` (every rank the
    whole batch, serving's layout): the output and this rank's drops."""
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.models import moe
    with activate_mesh(mesh), slot_spy() as dropped:
        y, _ = moe.apply_moe(cfg, params, x)
    return dict(y=y.cpu(), dropped=dropped[0])


def ep_drop_gate(label, ranks, cfg, params, x) -> dict:
    """Every rank's output within EP_DROP_REL (relative L2) of the plain
    single-process exchange (``apply_moe_alltoall_ref``) and the ranks'
    drops, summed, the reference's, which drops some: the same drops in
    the same slots."""
    from repro_torch.models import moe
    with torch.no_grad(), slot_spy() as dropped:
        ref, _ = moe.apply_moe_alltoall_ref(cfg, params, x, *EP_MESH)
    ref = ref.cpu()
    drops = sum(r["dropped"] for r in ranks)
    if not dropped[0] or drops != dropped[0]:
        raise AssertionError(f"{label}: the ranks dropped {drops} "
                             f"assignments, the plain exchange "
                             f"{dropped[0]} (it must drop some)")
    worst = 0.0
    for r, got in enumerate(ranks):
        d = float((got["y"].double() - ref.double()).norm() /
                  ref.double().norm())
        if not d <= EP_DROP_REL:
            raise AssertionError(f"{label}: rank {r}'s output {d:.3e} "
                                 "(relative L2) from the plain exchange's "
                                 f"(limit {EP_DROP_REL})")
        worst = max(worst, d)
    return dict(rel=worst, dropped=drops,
                assignments=x.shape[0] * x.shape[1] *
                cfg.num_experts_per_tok)


def ep_rank(rank, world, tmp, seed) -> None:
    """11a on one rank: the f32 parity run, the drops case, then the bf16
    timed run."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, dev = init_rank(rank, world, f"file://{tmp}/init11a", "cuda")
    mesh = make_test_mesh(*EP_MESH)
    cfg = ep_config()
    params = tree_to(tfm.init_model(cfg, seed, dev), "cpu")
    torch.cuda.empty_cache()
    batches = [train_batch(cfg, EP_ROWS, EP_SEQ, seed, i, dev)
               for i in range(EP_STEPS)]
    torch.cuda.reset_peak_memory_stats(dev)
    run = ep_parity_run(cfg, mesh, params, batches, dev)
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    drop = ep_drop_run(*ep_drop_case(cfg, seed, dev), mesh)
    gc.collect()
    # the f32 runs' mailboxes (each its group's largest tensor) go before
    # the bf16 run makes its own
    collectives.close_mailboxes()
    dist.barrier()
    torch.cuda.empty_cache()
    # the bf16 timed run: blocks drawn as the Trainer draws them
    tcfg = ep_timed_config()
    ocfg = mesh_ocfg(8, schedule={})
    psds, psh = sp.param_specs(tcfg, mesh, {})
    osds, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
    local = fsdp.init_shards(tcfg, seed, fsdp.flat_tree(psh), dev)
    opt = fsdp.zeros_tree(osds, fsdp.flat_tree(osh), dev)
    step = make_train_step(tcfg, ocfg, 1, grad_shardings=psh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in collectives.SECONDS:
        collectives.SECONDS[k] = 0.0
    dist.barrier()
    reset_launches()
    metrics = []
    for i in range(EP_TIMED_STEPS):
        batch = train_batch(tcfg, EP_MESH[0], EP_TIMED_SEQ, seed, i, dev)
        timed = i == EP_TIMED_STEPS - 1
        collectives.TIMING["on"] = timed
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, batch)
        torch.cuda.synchronize(dev)
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        metrics.append(m)
        if rank == 0:
            log(f"  ep 11a timed rank 0 step {i}: loss {m['loss']:.6f}, "
                f"{m['step_s']:.3f} s" + (" (collectives timed)" if timed
                                          else ""))
    collectives.TIMING["on"] = False
    timed_run = dict(metrics=metrics, launches=read_launches(),
                     collective_s=dict(collectives.SECONDS),
                     peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    torch.save(dict(parity=run, drop=drop, timed=timed_run, backend=backend,
                    device=str(dev),
                    peer_copied=dict(collectives.PEER_COPIED)),
               os.path.join(tmp, f"ep11a_{rank}.pt"))
    end_rank()


def phase_ep(dev, seed, card) -> dict:
    """Phase 11a (see the module docstring); returns the ``flash_prefill``
    row's ``ep`` entry."""
    import tempfile
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_adamw
    from repro_torch.runtime.steps import make_train_step
    cfg = ep_config()
    label = (f"ep 11a mixtral-8x22b {cfg.num_layers} of 56 layers, f32, "
             f"{EP_BITS}-bit moments, alltoall on {EP_MESH}, {EP_ROWS} x "
             f"{EP_SEQ} tokens, {EP_STEPS} steps")
    log(f"{label}: {cfg.param_count() / 1e9:.3f} B params, widths as "
        f"published (d {cfg.d_model}, {cfg.num_experts} experts of d_ff "
        f"{cfg.d_ff}, {cfg.moe_parallelism} storage); depth cut to "
        f"{EP_DEPTH} (four ranks' f32 shards, gathered experts and their "
        f"gradients on one card); capacity factor {EP_CF} "
        f"(dropless at model {EP_MESH[1]}); backend "
        f"{collective_backend(EP_WORLD, 'cuda')}; "
        f"{card}")
    with phase_clock("ep 11a one-process reference (the plain exchange)",
                     dev), plain_exchange():
        params = tfm.init_model(cfg, seed, dev)
        init = {path: t.to("cpu", copy=True)
                for path, t in fsdp_flat(params).items()}
        ocfg = mesh_ocfg(EP_BITS)
        opt = init_adamw(ocfg, params)
        step = make_train_step(cfg, ocfg, 1)
        ref_ms = []
        for i in range(EP_STEPS):
            params, opt, m = step(params, opt, train_batch(
                cfg, EP_ROWS, EP_SEQ, seed, i, dev))
            ref_ms.append({k: float(v) for k, v in m.items()})
        ref = {path: t.cpu() for path, t in fsdp_flat(params).items()}
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(ep_rank, EP_WORLD, (EP_WORLD, tmp, seed),
                    deadline_s=EP_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"ep11a_{r}.pt"),
                            weights_only=False) for r in range(EP_WORLD)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}; "
        f"collectives card to card: {ranks[0]['peer_copied']}")
    got = [r["parity"] for r in ranks]
    if not all(g["shapes"] for g in got):
        raise AssertionError(f"{label}: a rank holds a block off its "
                             "spec's shard shape")
    worst = mesh_metrics_gate(label, [g["metrics"] for g in got], ref_ms)

    def on_card(tree):
        return {p: t.to(dev) for p, t in tree.items()}

    perr = mesh_params_gate(
        label, [on_card(g.pop("params")) for g in got], on_card(ref),
        on_card(init), [ep_shardings(cfg, r) for r in range(EP_WORLD)],
        EP_BITS)
    del ref, init
    torch.cuda.empty_cache()
    experts = expert_bytes_gate(label, cfg, [g["stored"] for g in got],
                                [g["gathered"] for g in got])
    launches = mesh_launch_gate(label, got, cfg.num_layers, 2 * EP_STEPS)
    dcfg, dparams, dx = ep_drop_case(cfg, seed, dev)
    drops = ep_drop_gate(f"{label} drops case", [r["drop"] for r in ranks],
                         dcfg, dparams, dx)
    del dparams, dx
    torch.cuda.empty_cache()
    log(f"  {label} drops case (one MoE layer, capacity factor 1.0, "
        f"{EP_DROP_ROWS} x {EP_DROP_SEQ} tokens): {drops['dropped']} of "
        f"{drops['assignments']} assignments dropped, as the plain "
        f"exchange drops them; outputs {drops['rel']:.3e} (relative L2, "
        f"limit {EP_DROP_REL}) from its")
    log(f"  {label}: losses {[m['loss'] for m in got[0]['metrics']]} (one "
        f"process, the plain exchange: {[m['loss'] for m in ref_ms]}); "
        f"largest relative loss {worst['loss']:.3e} (limit "
        f"{TRAIN_LOSS_RTOL}), grad norm {worst['grad_norm']:.3e} (limit "
        f"{TRAIN_GRAD_RTOL}); parameters: the largest block L2 distance "
        f"{perr['update_rel']:.3e} of the one-process step's update "
        f"({perr['update_leaf']}; limit {MESH_UPDATE_RTOL[EP_BITS]}); expert "
        f"leaves: {experts}; flash_prefill {launches} launches; peak GB "
        f"{[round(g['peak_gb'], 2) for g in got]}")
    # the bf16 timed run
    tcfg = ep_timed_config()
    tlabel = (f"ep 11a mixtral-8x22b {tcfg.num_layers} of 56 layers, bf16, "
              f"remat full, 8-bit moments, alltoall on {EP_MESH}, "
              f"{EP_TIMED_SEQ} tokens a data rank")
    timed = [r["timed"] for r in ranks]
    losses = [m["loss"] for m in timed[0]["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tlabel}: losses {losses}")
    for r, t in enumerate(timed):
        if [m["loss"] for m in t["metrics"]] != losses:
            raise AssertionError(f"{tlabel}: rank {r}'s losses differ")
    tlaunch = mesh_launch_gate(tlabel, timed, tcfg.num_layers,
                               2 * EP_TIMED_STEPS)
    step_s = min(max(t["metrics"][i]["step_s"] for t in timed)
                 for i in range(1, EP_TIMED_STEPS - 1))
    timed_s = max(t["metrics"][-1]["step_s"] for t in timed)
    coll = {k: max(t["collective_s"][k] for t in timed)
            for k in timed[0]["collective_s"]}
    tokens = EP_MESH[0] * EP_TIMED_SEQ
    out = dict(loss=losses, step_s=step_s, tokens_per_s=tokens / step_s,
               peak_gb=[t["peak_gb"] for t in timed], timed_step_s=timed_s,
               collective_s=coll,
               all_to_all_share=coll["all_to_all"] / timed_s,
               launches=tlaunch, layers=tcfg.num_layers)
    log(f"  {tlabel}: {tcfg.param_count() / 1e9:.3f} B params; losses "
        f"{losses}; step {step_s:.3f} s, {tokens / step_s:.1f} tokens/s "
        f"over {EP_WORLD} ranks; peak GB "
        f"{[round(t['peak_gb'], 2) for t in timed]}; the instrumented step "
        f"{timed_s:.3f} s, of it all-to-alls {coll['all_to_all']:.3f} s "
        f"({coll['all_to_all'] / timed_s:.3f}), gathers "
        f"{coll['all_gather']:.3f} s, reduce-scatters "
        f"{coll['reduce_scatter']:.3f} s, all-reduces "
        f"{coll['all_reduce']:.3f} s; flash_prefill {tlaunch} launches; "
        f"{card}")
    if torch.cuda.device_count() < EP_WORLD:
        log(f"  the {EP_WORLD} ranks share one card: their times are that "
            "card's under four processes, and the all-to-all's share is "
            "the mailbox rig's, not a deployment's")
    return dict(parity=dict(worst, params=perr, experts=experts,
                            launches=launches, drops=drops,
                            peak_gb=[g["peak_gb"] for g in got]),
                timed=out, launches=launches + tlaunch,
                backend=ranks[0]["backend"], card=card)


def fsdp_flat(tree) -> dict:
    from repro_torch.distributed import fsdp
    return fsdp.flat_tree(tree)


def ep_shardings(cfg, rank) -> dict:
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    return fsdp.flat_tree(sp.param_specs(
        cfg, Mesh(("data", "model"), EP_MESH, rank=rank), {})[1])


def pipe_config(depth, numerics="f32"):
    from repro_torch.launch.serve import card_config
    cfg = card_config("llama31-8b", numerics)
    return cfg.replace(num_groups=depth)


def pipe_stage_fn(cfg, seq, clock=None):
    """One stage's layers (llama31-8b's blocks, ``stage_fn(params, x)``
    with ``params`` the stage's list of layer dicts); ``clock`` collects
    each call's seconds (the device synchronised around it)."""
    from repro_torch.models import transformer as tfm
    spec = cfg.pattern[0]

    def stage_fn(params, x):
        if clock is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        pos = torch.arange(seq, device=x.device).expand(x.shape[0], seq)
        for lp in params:
            x, _, _ = tfm._block_train(cfg, lp, spec, x, pos)
        if clock is not None:
            torch.cuda.synchronize()
            clock.append(time.perf_counter() - t0)
        return x
    return stage_fn


def pipe_stage_params(cfg, seed, dev, stage, per_stage):
    """(the embedding, this stage's layers as ``(1, ...)`` blocks): drawn a
    unit at a time as ``init_model`` draws them, the other stages'
    layers dropped."""
    from repro_torch.models import transformer as tfm
    lo, hi = stage * per_stage, (stage + 1) * per_stage

    def place(path, t):
        if path.startswith("['layers']"):
            i = int(path.split("]")[1].lstrip("["))
            return t[None] if lo <= i < hi else None
        return t if path.startswith("['embed']") else None
    tree = tfm.init_model_placed(cfg, seed, dev, place)
    return tree["embed"], tree["layers"][lo:hi]


def pipe_input(cfg, embed, seq, seed, dev):
    from repro_torch.models.layers import embed_tokens
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, seq),
                           generator=gen, device=dev)
    return embed_tokens(cfg, embed, tokens)


def pipe_parity_run(cfg, seed, dev, mesh, seq=PIPE_SEQ) -> dict:
    """One stage's share of the f32 parity run: its layers' ``(1, ...)``
    blocks drawn from the seed, the pipeline's output (stage 0's copy)
    and the gradients of :func:`pipe_loss` (the input's on stage 0, this
    stage's leaves'), launches counted from 0."""
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import gpipe_forward
    stage, per = mesh.index(("stage",)), cfg.num_layers // PIPE_STAGES
    embed, layers = pipe_stage_params(cfg, seed, dev, stage, per)
    x = pipe_input(cfg, embed, seq, seed, dev).detach().requires_grad_()
    del embed
    leaves = [t.requires_grad_() for lp in layers for t in lp_leaves(lp)]
    dist.barrier()
    reset_launches()
    out = gpipe_forward(mesh, "stage", pipe_stage_fn(cfg, seq), layers, x,
                        PIPE_MICRO)
    grads = torch.autograd.grad(pipe_loss(out), [x] + leaves,
                                allow_unused=True)
    first = stage == 0
    return dict(out=out.detach().cpu() if first else None,
                gx=grads[0].cpu() if first else None,
                g={p: g[0].cpu() for p, g in zip(lp_paths(layers, stage),
                                                  grads[1:])
                   if g is not None},
                launches=read_launches(),
                stage_bytes=sum(t.numel() * t.element_size()
                                for t in leaves))


def pipe_rank(rank, world, tmp, seed) -> None:
    """11b on one rank (one stage): the f32 parity run with its
    gradients, then the bf16 timed forwards at full depth."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.launch.mesh import Mesh, init_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, dev = init_rank(rank, world, f"file://{tmp}/init11b", "cuda")
    mesh = Mesh(("stage",), (world,), rank=rank)
    mesh.build_groups()
    parity = pipe_parity_run(pipe_config(PIPE_STAGES * PIPE_PER_STAGE),
                             seed, dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 at full depth, forward: each stage's busy seconds
    tcfg = pipe_config(32, "bf16")
    per = tcfg.num_layers // PIPE_STAGES
    embed, layers = pipe_stage_params(tcfg, seed, dev, rank, per)
    x = pipe_input(tcfg, embed, PIPE_TIMED_SEQ, seed, dev)
    del embed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    reset_launches()
    with torch.no_grad():
        for i in range(PIPE_TIMED_RUNS):
            clock = []
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y = gpipe_forward(mesh, "stage",
                              pipe_stage_fn(tcfg, PIPE_TIMED_SEQ, clock),
                              layers, x, PIPE_MICRO)
            torch.cuda.synchronize(dev)
            runs.append(dict(wall_s=time.perf_counter() - t0,
                             busy_s=sum(clock), calls=len(clock),
                             finite=bool(torch.isfinite(y).all()),
                             digest=float(y.float().abs().sum())))
    timed = dict(runs=runs, launches=read_launches(),
                 peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                 layers=per)
    torch.save(dict(parity=parity, timed=timed, backend=backend,
                    device=str(dev),
                    peer_copied=dict(collectives.PEER_COPIED)),
               os.path.join(tmp, f"pipe11b_{rank}.pt"))
    end_rank()


def lp_leaves(lp) -> list:
    return list(fsdp_flat(lp).values())


def lp_paths(layers, stage) -> list:
    """The global paths (``['layers'][i]...``) of a stage's leaves, in
    :func:`lp_leaves` order."""
    per = len(layers)
    return [f"['layers'][{stage * per + i}]{p}"
            for i, lp in enumerate(layers) for p in fsdp_flat(lp)]


def pipe_loss(out):
    return (out.float() ** 2).mean()


def pipe_gate(label, got, want, rel) -> float:
    """``got``'s relative L2 distance from ``want`` within ``rel``."""
    d = float((got.double() - want.double()).norm() /
              want.double().norm().clamp(min=1e-30))
    if not (math.isfinite(d) and d <= rel):
        raise AssertionError(f"{label}: relative L2 {d:.3e} from the "
                             f"sequential stack's (limit {rel})")
    return d


def pipe_parity_gates(label, ranks, ref) -> dict:
    """The ranks' output (every stage's: the broadcast), the input's
    gradient and each stage's parameter gradients against the sequential
    stack's."""
    out = pipe_gate(f"{label} output", ranks[0]["out"], ref["out"],
                    PIPE_OUT_REL)
    gx = pipe_gate(f"{label} input gradient", ranks[0]["gx"], ref["gx"],
                   PIPE_GRAD_REL)
    worst, leaf = 0.0, None
    seen = set()
    for got in ranks:
        for path, g in got["g"].items():
            d = pipe_gate(f"{label} {path}", g, ref["g"][path],
                          PIPE_GRAD_REL)
            seen.add(path)
            if d > worst:
                worst, leaf = d, path
    if seen != set(ref["g"]):
        raise AssertionError(f"{label}: stages' leaves "
                             f"{sorted(set(ref['g']) ^ seen)[:4]} missing")
    return dict(out_rel=out, input_grad_rel=gx, grad_rel=worst,
                grad_leaf=leaf)


def pipe_reference(cfg, seed, dev, seq=PIPE_SEQ) -> dict:
    """The sequential stack (every layer in one process) on the same
    input: its output and the gradients of :func:`pipe_loss`."""
    from repro_torch.models import transformer as tfm
    params = tfm.init_model(cfg, seed, dev)
    x = pipe_input(cfg, params["embed"], seq, seed, dev).detach()
    x.requires_grad_()
    leaves = [t.requires_grad_() for lp in params["layers"]
              for t in lp_leaves(lp)]
    out = pipe_stage_fn(cfg, seq)(params["layers"], x)
    grads = torch.autograd.grad(pipe_loss(out), [x] + leaves,
                                allow_unused=True)
    paths = [f"['layers'][{i}]{p}" for i, lp in enumerate(params["layers"])
             for p in fsdp_flat(lp)]
    # the hash planes take no part in the training forward
    return dict(out=out.detach().cpu(), gx=grads[0].cpu(),
                g={p: g.cpu() for p, g in zip(paths, grads[1:])
                   if g is not None})


def phase_pipe(dev, seed, card) -> dict:
    """Phase 11b (see the module docstring); returns the
    ``flash_prefill`` row's ``pipe`` entry."""
    import tempfile
    from repro_torch.launch.mesh import collective_backend, spawn_ranks
    cfg = pipe_config(PIPE_STAGES * PIPE_PER_STAGE)
    label = (f"pipe 11b llama31-8b {cfg.num_layers} layers as "
             f"{PIPE_STAGES} stages, {PIPE_MICRO} microbatches of 1 x "
             f"{PIPE_SEQ} tokens, f32")
    log(f"{label}: {PIPE_PER_STAGE} layers a stage (widths as published); "
        f"backend {collective_backend(PIPE_STAGES, 'cuda')}; {card}")
    with phase_clock("pipe 11b sequential reference", dev):
        ref = pipe_reference(cfg, seed, dev)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(pipe_rank, PIPE_STAGES, (PIPE_STAGES, tmp, seed),
                    deadline_s=PIPE_DEADLINE_S)
        ranks = [torch.load(os.path.join(tmp, f"pipe11b_{r}.pt"),
                            weights_only=False) for r in range(PIPE_STAGES)]
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
        f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}; "
        f"collectives card to card: {ranks[0]['peer_copied']}")
    parity = [r["parity"] for r in ranks]
    gates = pipe_parity_gates(label, parity, ref)
    # every stage's prefill-op launches: its layers x microbatches
    # forward (the backward takes the plain version's gradient)
    launches = mesh_launch_gate(label, parity, PIPE_PER_STAGE, PIPE_MICRO)
    stage_gb = [p["stage_bytes"] / 1e9 for p in parity]
    log(f"  {label}: output {gates['out_rel']:.3e} (relative L2, limit "
        f"{PIPE_OUT_REL}), input gradient {gates['input_grad_rel']:.3e}, "
        f"worst parameter gradient {gates['grad_rel']:.3e} "
        f"({gates['grad_leaf']}; limit {PIPE_GRAD_REL}) from the "
        f"sequential stack; each stage holds {stage_gb} GB of weights "
        f"(its {PIPE_PER_STAGE} layers); flash_prefill {launches} "
        "launches")
    timed = [r["timed"] for r in ranks]
    tlabel = (f"pipe 11b llama31-8b 32 layers as {PIPE_STAGES} stages of "
              f"{timed[0]['layers']}, bf16, {PIPE_MICRO} microbatches of 1 "
              f"x {PIPE_TIMED_SEQ} tokens, forward")
    for r, t in enumerate(timed):
        if not all(run["finite"] for run in t["runs"]):
            raise AssertionError(f"{tlabel}: rank {r}'s output not finite")
        if [run["digest"] for run in t["runs"]] != \
                [run["digest"] for run in timed[0]["runs"]]:
            raise AssertionError(f"{tlabel}: rank {r}'s output differs "
                                 "from rank 0's (the broadcast)")
        if any(run["calls"] != PIPE_MICRO for run in t["runs"]):
            raise AssertionError(f"{tlabel}: rank {r} ran its stage "
                                 f"{[run['calls'] for run in t['runs']]} "
                                 f"times a run, not {PIPE_MICRO}")
    tlaunch = mesh_launch_gate(tlabel, timed, timed[0]["layers"],
                               PIPE_MICRO * PIPE_TIMED_RUNS)
    theory = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    walls = [min(run["wall_s"] for run in t["runs"][1:]) for t in timed]
    busy = [min(run["busy_s"] for run in t["runs"][1:]) for t in timed]
    wall = max(walls)
    bubble = [1 - b / wall for b in busy]
    tokens = PIPE_MICRO * PIPE_TIMED_SEQ
    log(f"  {tlabel}: a forward {wall:.3f} s, {tokens / wall:.1f} tokens/s; "
        f"each stage busy {[round(b, 3) for b in busy]} s; measured bubble "
        f"(1 - busy / wall) {[round(b, 3) for b in bubble]}, GPipe's "
        f"(stages - 1) / (micro + stages - 1) = {theory:.3f}; peak GB "
        f"{[round(t['peak_gb'], 2) for t in timed]}; flash_prefill "
        f"{tlaunch} launches; {card}")
    if torch.cuda.device_count() < PIPE_STAGES:
        log(f"  the {PIPE_STAGES} stages share one card: a busy stage's "
            "kernels share it with the others', so the measured bubble is "
            "the rig's, not a pipeline's across cards")
    return dict(parity=dict(gates, launches=launches, stage_gb=stage_gb),
                timed=dict(wall_s=wall, tokens_per_s=tokens / wall,
                           busy_s=busy, bubble=bubble, bubble_theory=theory,
                           peak_gb=[t["peak_gb"] for t in timed],
                           launches=tlaunch),
                launches=launches + tlaunch, backend=ranks[0]["backend"],
                card=card)


def cph_config(arch, groups, cp_axes=("data",)):
    """11c's model: ``arch`` at full width, ``groups`` of its groups, bf16
    (``dryrun_model_config``'s decode numerics), SOCKET scores through
    ``socket_score``."""
    from repro_torch.launch.serve import card_config
    cfg = card_config(arch, "bf16").replace(
        num_groups=groups, decode_cp_axes=cp_axes, decode_cp_batch_axes=())
    return cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=True, use_flash_decode=True))


def cache_digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def cache_layout(cfg, caches) -> list:
    """Each layer's kind and, for each leaf, its shape, bytes and (but for
    a global layer's block) digest."""
    out = []
    for spec, c in zip(cfg.layer_specs, caches):
        kind = spec.kind if spec.kind != "attn" else spec.attn_type
        out.append((kind, {k: (tuple(v.shape), v.numel() * v.element_size(),
                               None if kind == "global" else cache_digest(v))
                           for k, v in c.items()}))
    return out


def cph_rank(rank, world, tmp, seed, arch, groups) -> None:
    """11c on one rank: prefill (the ranks in turn) and greedy decode
    under the CP mesh, launches counted from 0, the prefill caches'
    layout."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import transformer as tfm
    backend, dev = init_rank(rank, world, f"file://{tmp}/init11c", "cuda")
    cfg = cph_config(arch, groups)
    params = tfm.init_model(cfg, seed, dev)
    prompt = cp_prompt(cfg, seed, dev)
    with activate_mesh(make_test_mesh(world, 1)):
        dist.barrier()
        reset_launches()
        for r in range(world):
            if r == rank:
                prefilled = cp_prefill(cfg, params, prompt)
                layout = cache_layout(cfg, prefilled[1])
                torch.cuda.empty_cache()
            dist.barrier()
        toks, steps, prefill_s, step_s = cp_drive(
            cfg, params, prompt, prefilled=prefilled)[:4]
        launches = read_launches()
    torch.save(dict(tokens=toks, logits=steps if rank == 0 else None,
                    launches=launches, prefill_s=prefill_s, step_s=step_s,
                    layout=layout, backend=backend, device=str(dev),
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9),
               os.path.join(tmp, f"cph_{rank}.pt"))
    end_rank()


def cph_layout_gate(label, cfg, ranks, ref_layout) -> dict:
    """Each rank's prefill caches: a global layer's leaves its block
    (CP_CAPACITY / ranks rows, that share of the one process's bytes);
    a local layer's ring and a Mamba layer's state whole, bitwise equal
    on every rank and to the one process's."""
    world = len(ranks)
    out = {"global": 0, "whole": 0}
    for r, got in enumerate(ranks):
        for i, ((kind, leaves), (rkind, ref)) in enumerate(
                zip(got["layout"], ref_layout)):
            if kind != rkind or set(leaves) != set(ref):
                raise AssertionError(f"{label}: rank {r} layer {i}'s cache "
                                     f"{kind} {sorted(leaves)}, one process "
                                     f"{rkind} {sorted(ref)}")
            for name, (shape, nbytes, digest) in leaves.items():
                rshape, rbytes, rdigest = ref[name]
                if kind == "global":
                    want = list(rshape)
                    want[2] //= world
                    if list(shape) != want or nbytes * world != rbytes:
                        raise AssertionError(
                            f"{label}: rank {r} layer {i} {name}: {shape}, "
                            f"{nbytes} B; its block is {tuple(want)}, "
                            f"{rbytes // world} B")
                    out["global"] += nbytes
                elif shape != rshape or digest != rdigest:
                    raise AssertionError(
                        f"{label}: rank {r} layer {i} ({kind}) {name}: "
                        f"{shape} {digest}, one process {rshape} {rdigest}")
                else:
                    out["whole"] += nbytes
    return {k: v // world for k, v in out.items()}


def cph_launch_gate(label, cfg, ranks) -> dict:
    """11c's launches on every rank: ``socket_score`` global layers x
    steps, ``flash_prefill`` attention layers (each rank's whole
    prefill), no other kernel.  Returns a rank's."""
    n_attn = sum(1 for s in cfg.layer_specs if s.kind == "attn")
    n_glob = sum(1 for s in cfg.layer_specs if s.kind == "attn" and
                 s.attn_type == "global")
    want = {"socket_score": n_glob * CP_STEPS, "flash_prefill": n_attn}
    for r, got in enumerate(ranks):
        bad = {k: v for k, v in got["launches"].items()
               if v != want.get(k, 0)}
        if bad:
            raise AssertionError(f"{label}: rank {r} launched {bad}, "
                                 f"expected {want} and no other kernel")
    return want


def phase_cp_hybrid(dev, seed, card) -> dict:
    """Phase 11c (see the module docstring); returns the ``socket_score``
    and ``flash_prefill`` rows' ``cp_hybrid`` entries."""
    import tempfile
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh, spawn_ranks
    from repro_torch.models import transformer as tfm
    entry = {}
    for arch, groups, world in CPH_CASES:
        cfg = cph_config(arch, groups)
        kinds = collections.Counter(layer_kinds(cfg))
        label = (f"cp-hybrid 11c {arch} {groups} group(s) ({dict(kinds)}), "
                 f"bf16, prompt {CP_PROMPT}, {CP_STEPS} steps, {world} ranks")
        log(f"{label}: {cfg.param_count() / 1e9:.3f} B params a rank "
            f"(replicated), widths as published; {card}")
        gc.collect()
        torch.cuda.empty_cache()
        card_memory(f"cp-hybrid 11c {arch} before the ranks", dev)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            spawn_ranks(cph_rank, world, (world, tmp, seed, arch, groups),
                        deadline_s=CPH_DEADLINE_S)
            ranks = [torch.load(os.path.join(tmp, f"cph_{r}.pt"),
                                weights_only=False) for r in range(world)]
        log(f"  ranks ran in {time.perf_counter() - t0:.1f} s, backend "
            f"{ranks[0]['backend']}; peak GB "
            f"{[round(r['peak_gb'], 2) for r in ranks]}; prefill s "
            f"{[round(r['prefill_s'], 2) for r in ranks]}; decode step ms "
            f"{[step_ms(r['step_s']) for r in ranks]}")
        want = cph_launch_gate(label, cfg, ranks)
        toks = ranks[0]["tokens"]
        for r, got in enumerate(ranks):
            if not torch.equal(got["tokens"], toks):
                raise AssertionError(f"{label}: rank {r}'s tokens differ")
        params = tfm.init_model(cfg, seed, dev)
        prompt = cp_prompt(cfg, seed, dev)
        attend = cp.context_parallel_socket_attend
        cp.context_parallel_socket_attend = cp_plain_attend(world)
        try:
            with activate_mesh(Mesh(("data", "model"), (1, 1))):
                prefilled = cp_prefill(cfg, params, prompt)
                ref_layout = cache_layout(cfg, prefilled[1])
                # the caches after the steps are not kept: the next
                # case's ranks need the card
                ref_toks, ref_steps = cp_drive(cfg, params, prompt,
                                               prefilled=prefilled)[:2]
                del prefilled
        finally:
            cp.context_parallel_socket_attend = attend
        err = cp_logits_gate(label, toks, ranks[0]["logits"], ref_toks,
                             ref_steps)
        held = cph_layout_gate(label, cfg, ranks, ref_layout)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {label}: tokens {toks[0].tolist()}; logits max |err| "
            f"{err:.3e} to one process (its CP attend the plain version "
            f"over {world} shards; limit {LOGITS_ATOL}); each rank holds "
            f"{held['global'] / 1e6:.1f} MB of global caches (its block) "
            f"and {held['whole'] / 1e6:.1f} MB of rings and Mamba state "
            f"(whole, bitwise the one process's); launches a rank {want}; "
            f"{card}")
        entry[arch] = dict(
            logits_err=err, held=held, world=world,
            launches={k: sum(g["launches"][k] for g in ranks) for k in want},
            prefill_s=[r["prefill_s"] for r in ranks],
            step_ms=[[x * 1e3 for x in r["step_s"]] for r in ranks],
            peak_gb=[r["peak_gb"] for r in ranks])
    return dict(
        socket_score=dict(launches=sum(e["launches"]["socket_score"]
                                       for e in entry.values()),
                          cases=entry),
        flash_prefill=dict(launches=sum(e["launches"]["flash_prefill"]
                                        for e in entry.values())))


def phase_parallel(dev, seed, card, only=None) -> dict:
    """Phase 11: 11a, 11b, 11c (``only``: one of them); returns the rows'
    entries: ``flash_prefill``'s ``ep``, ``pipe`` and ``cp_hybrid``,
    ``socket_score``'s ``cp_hybrid``."""
    rows = {"flash_prefill": {}, "socket_score": {}}
    for name, fn in (("ep", phase_ep), ("pipe", phase_pipe),
                     ("cp-hybrid", phase_cp_hybrid)):
        if only not in (None, name):
            continue
        t0 = time.perf_counter()
        got = fn(dev, seed, card)
        if name == "cp-hybrid":
            rows["flash_prefill"]["cp_hybrid"] = got["flash_prefill"]
            rows["socket_score"]["cp_hybrid"] = got["socket_score"]
        else:
            rows["flash_prefill"][name] = got
        gc.collect()
        torch.cuda.empty_cache()
        log(f"parallel {name}: {time.perf_counter() - t0:.1f} s")
    return rows


# -------------------------------------------------------------- phase 12

# The depth at which phase 12 gates the two routes' logits, by arch.
# musicgen-medium at f32: through all 48 layers of random weights the
# free-running routes' logits part by 7.0e-4 (their K/V by 2.8e-5 after
# one layer, 1.3e-4 after seven, 8.3e-4 after 47; an H100, seed 0) while
# every layer's attention is within its gate (layer by layer): the
# 48-layer run logs the distance, and LOGITS_ATOL is held at the first 4
# layers (9.2e-5 at 8).  internvl2-26b at bf16: 48 layers (38.6 GB of
# weights) run the kernel and plain routes for times, launches and their
# distance; phase 5f's float32 yardstick at full depth would add its
# prefill and decode loop (a 632-TFLOP prefill at float32) to the
# script's time, so it runs at the first QUANT_DEPTH layers
FRONTEND_GATE_DEPTH = {"musicgen-medium": 4, "internvl2-26b": QUANT_DEPTH}
# 12c: one llama31-8b attention layer at decode_32k's length (8 KV heads
# x 32768 keys, hd 128, G 4, f32); the CPU side of each gate reads the
# first KV head's slice
BASELINE_SHAPE = dict(kvh=8, n=32768, g=4, hd=128)
BASELINE_TOP = 0.1            # the oracle's top share each recall reads
# a sign whose projection lies within this share of the sum of its terms'
# magnitudes (float64) may round either way on either device; as far
# apart are a key's two nearest PQ centroids within float32 rounding
SIGN_BAND = 1e-5
PQ_BAND = 1e-5


def frontend_full_depth(dev, seed, card, arch="internvl2-26b") -> dict:
    """12b at full depth (bf16, the deployment numerics): the static path
    through the kernels (``run_serve``: prefill s, decode step ms, peak
    memory; launches gated at attention layers x calls) and through the
    plain versions (kernel flags off, the plain prefill op; none of the
    three kernels may launch), then decode step 0 through both routes
    from one prefill's caches, whose logits distance is logged: at bf16
    the routes part from layer 0 on (:func:`f32_distance_check`), so the
    gate runs at FRONTEND_GATE_DEPTH's layers in :func:`phase_main`.
    Returns the kernel route's launches."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import (apply_backend_arg, card_config,
                                          run_serve, serve_inputs,
                                          step_input)
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    batch, prompt_len, steps = STATIC_CASES[arch]
    cfg = apply_backend_arg(card_config(arch, "bf16"), "socket")
    cfg_plain = kernel_scoring(cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=False, use_flash_decode=False)))
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed, dev)
    (prompt,) = serve_inputs(cfg, batch, prompt_len, seed, dev).values()
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.param_count() / 1e9:.3f} B params ({cfg.param_dtype}"
        f", {cfg.num_layers} layers) drawn in {time.perf_counter() - t0:.1f}"
        f" s; batch {batch}, prompt {prompt_len}, {steps} decode steps")
    out, expected = {}, {"socket_score": cfg.num_layers * (steps + 1),
                         "flash_decode": cfg.num_layers * (steps + 1),
                         "flash_prefill": cfg.num_layers}
    for route, c, op in (("kernel", cfg, fp.flash_prefill),
                         ("plain", cfg_plain, plain_prefill)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ss.LAUNCHES = fd.LAUNCHES = fp.LAUNCHES = 0
        with mock.patch.object(attention.fp_ops, "flash_prefill", op):
            toks, prefill_s, decode_s = run_serve(
                c, batch, prompt_len, steps, seed=seed, prompt=prompt,
                params=params, device=dev)
        launches = {"socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES,
                    "flash_prefill": fp.LAUNCHES}
        want = expected if route == "kernel" else dict.fromkeys(expected, 0)
        if launches != want:
            raise AssertionError(f"{arch} {route} route: launches "
                                 f"{launches}, expected {want}")
        out[route] = dict(prefill_s=prefill_s,
                          decode_step_ms=decode_s / steps * 1e3,
                          decode_tokens_per_s=batch * steps / decode_s,
                          max_memory_allocated_bytes=
                          torch.cuda.max_memory_allocated(dev),
                          launches=launches, tokens=toks)
    # decode step 0 through both routes from one prefill's caches
    _, caches = make_prefill_step(cfg, prompt_len + steps)(
        params, {"embeds": prompt})
    inp = step_input(cfg, out["kernel"]["tokens"][:, :1], seed, 0)
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    lk, _ = make_serve_step(cfg)(params, caches, inp, prompt_len)
    del caches
    lp, _ = make_serve_step(cfg_plain)(params, plain_caches, inp, prompt_len)
    del plain_caches
    torch.cuda.empty_cache()
    lk, lp = lk.float(), lp.float()
    if not (bool(torch.isfinite(lk).all()) and
            bool(torch.isfinite(lp).all())):
        raise AssertionError(f"{arch}: non-finite step-0 logits")
    same = out["kernel"].pop("tokens") == out["plain"].pop("tokens")
    stats = dict(
        step0_logits_kernel_vs_plain=(lk - lp).abs().max().item(),
        max_abs_logits=lp.abs().max().item(),
        greedy_tokens_shared=f"{int(same.sum().item())}/{same.numel()}")
    log(f"{arch} full depth, bf16: kernel route prefill "
        f"{out['kernel']['prefill_s']:.3f} s, a decode step "
        f"{out['kernel']['decode_step_ms']:.2f} ms, peak "
        f"{out['kernel']['max_memory_allocated_bytes'] / 1e9:.2f} GB; plain "
        f"route {out['plain']['prefill_s']:.3f} s, "
        f"{out['plain']['decode_step_ms']:.2f} ms; kernel vs plain (not a "
        f"gate at bf16): step 0 from one prefill's caches "
        f"{stats['step0_logits_kernel_vs_plain']:.3e} (max|logits| "
        f"{stats['max_abs_logits']:.3f}), greedy tokens shared "
        f"{stats['greedy_tokens_shared']}")
    log(json.dumps({"frontend_full_depth": arch, "numerics": "bf16",
                    "layers": cfg.num_layers, "batch": batch,
                    "prompt_len": prompt_len, "decode_steps": steps,
                    **out, **stats, "card": card}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out["kernel"]["launches"]


def on_card(label, t, dev) -> torch.Tensor:
    """``t``, which must lie on ``dev`` (a baseline left on the CPU
    fails), copied to the CPU."""
    if t.device != torch.device(dev):
        raise AssertionError(f"{label}: computed on {t.device}, not on "
                             f"{dev}")
    return t.detach().cpu()


def equal_gate(label, card, cpu, dev) -> None:
    """The card's integers (bits, bucket ids, counts, selections, codes)
    equal to the CPU's from the same inputs."""
    got = on_card(label, card, dev)
    if got.shape != cpu.shape or not torch.equal(got, cpu):
        bad = int((got != cpu).sum().item()) if got.shape == cpu.shape \
            else "shape"
        raise AssertionError(f"{label}: the card's values differ from the "
                             f"CPU's ({bad} entries)")


def close_gate(label, card, cpu, tol, dev, mag=None) -> float:
    """The card's floats within ``tol`` of the CPU's from the same
    inputs; returns max |err|.  ``mag``: for sums whose terms cancel (a
    dot product), the sum of the terms' magnitudes (float64), the scale
    their rounding takes in another summation order: the relative part
    of ``tol`` reads it where it exceeds |the CPU's value|."""
    got = on_card(label, card, dev)
    if mag is None:
        return check_close(label, got, cpu, tol)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite output")
    err = (got.double() - cpu.double()).abs()
    scale = torch.maximum(cpu.double().abs(), mag.double())
    if not bool((err <= tol["atol"] + tol["rtol"] * scale).all()):
        raise AssertionError(
            f"{label}: max |err| {err.max().item():.3e} exceeds atol "
            f"{tol['atol']} + rtol {tol['rtol']} * the terms' magnitude")
    return float(err.max().item())


def sign_gate(label, w, x, card_signs, cpu_signs, dev) -> int:
    """Signs of ``W x`` (``w`` (L, P, d), ``x`` (..., d) on the CPU;
    signs (..., L, P) bool, True where >= 0) on the card and on the CPU:
    equal wherever the projection is clear of rounding (|proj| >
    SIGN_BAND x the sum of |terms|, float64).  Returns the signs that
    differ inside the band."""
    got = on_card(label, card_signs, dev)
    l, p, d = w.shape
    wf, xf = w.double().reshape(l * p, d), x.double()
    proj = (xf @ wf.T).reshape(*x.shape[:-1], l, p)
    mag = (xf.abs() @ wf.abs().T).reshape(*x.shape[:-1], l, p)
    differ = got != cpu_signs
    if bool(differ[proj.abs() > SIGN_BAND * mag].any()):
        raise AssertionError(f"{label}: signs differ where the projection "
                             "is clear of rounding")
    return int(differ.sum().item())


def pq_code_gate(label, x, codebooks, card_codes, cpu_codes, dev) -> dict:
    """PQ codes of points ``x`` (m, N, dsub) under ``codebooks`` (m, C,
    dsub), all on the CPU: the card's equal to the CPU's but for points
    whose two nearest centroids lie within float32 rounding of each other
    (their squared distances, float64, within PQ_BAND of their sum).
    Returns the points in the band and the codes that differ there."""
    got = on_card(label, card_codes, dev)
    d2 = ((x.double()[:, :, None] - codebooks.double()[:, None]) ** 2).sum(-1)
    two = torch.topk(d2, 2, dim=-1, largest=False).values     # (m, N, 2)
    band = (two[..., 1] - two[..., 0] <= PQ_BAND * two.sum(-1)).T  # (N, m)
    differ = got != cpu_codes
    if bool(differ[~band].any()):
        raise AssertionError(f"{label}: {int(differ[~band].sum())} PQ codes "
                             "differ outside the rounding band")
    return dict(in_band=int(band.sum().item()),
                differ_in_band=int(differ.sum().item()))


@contextlib.contextmanager
def selections(module, out):
    """``module.value_aware_topk``'s selections appended to ``out``."""
    real = module.value_aware_topk

    def spy(*a, **kw):
        idx, mask = real(*a, **kw)
        out.append((idx, mask))
        return idx, mask

    with mock.patch.object(module, "value_aware_topk", spy):
        yield


def top_recall(scores, truth, k) -> float:
    """Mean over rows of the share of the ``truth`` top-``k`` (a bool
    mask) among ``scores``' top ``k`` (stable: ties by lowest index)."""
    top = torch.sort(scores.float(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(truth, -1, top).float().mean().item()


def baseline_inputs(dev, seed, kvh, n, g, hd):
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    keys = torch.randn((1, kvh, n, hd), generator=gen, device=dev)
    values = torch.randn((1, kvh, n, hd), generator=gen, device=dev)
    q = torch.randn((1, kvh, g, 1, hd), generator=gen, device=dev)
    return gen, keys, values, q


def phase_baselines(dev, seed, card) -> dict:
    """12c: the paper's baselines and SOCKET's paper-literal scoring on
    the card, at one llama31-8b attention layer at decode_32k's length
    (BASELINE_SHAPE), each at the JAX package's default config, against
    the same functions on the CPU fed the same inputs (the first KV
    head's slice; where a function draws or hashes, the CPU side takes
    the card's draw and bits): key and query signs equal outside the
    rounding band (SIGN_BAND), bucket ids, counts and selections equal,
    float scores within SCORE_TOL, attention outputs within ATTN_TOL, PQ's
    Lloyd iterations step by step (assignments outside PQ_BAND equal,
    centroids within SCORE_TOL where no assignment moved) and its codes
    outside the band; ``socket_score``'s kernel within SCORE_TOL of
    ``soft_scores_gather(bucket_ids, bucket_probs_explicit(u, tau))``
    summed over the group (2^P corners a table).  Logged, not gated:
    each scorer's recall of the oracle's top BASELINE_TOP, its bits a
    token and each index build's seconds (random data: a smoke figure)."""
    from repro_torch.baselines import (hard_lsh, hash_attn, magicpig,
                                       oracle, pqcache)
    from repro_torch.core import hashing, socket as sk
    from repro_torch.kernels.socket_score import ops as ss
    kvh, n, g, hd = (BASELINE_SHAPE[k] for k in ("kvh", "n", "g", "hd"))
    gen, keys, values, q = baseline_inputs(dev, seed, kvh, n, g, hd)
    scale = 1.0 / math.sqrt(hd)
    k0, v0, q0 = (t[:, :1].cpu() for t in (keys, values, q))
    qd, q0d = q[..., 0, :], q0[..., 0, :]                 # (1, H, G, hd)
    gates, recall, bits, build_s, band = {}, {}, {}, {}, {}

    def timed(name, fn):                # warm, then timed
        fn()
        _dev_sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _dev_sync(dev)
        build_s[name] = time.perf_counter() - t0
        return out

    def head0(t):
        return t[:, :1]

    # the oracle: exact scores and dense attention
    truth_scores = oracle.score(oracle.build(None, None, keys[:, :, None],
                                             values), qd)  # (1, H, G, N)
    gates["oracle.score"] = close_gate(
        "oracle.score", head0(truth_scores),
        oracle.score(oracle.OracleState(k0[:, :, None]), q0d), SCORE_TOL,
        dev, mag=oracle.score(oracle.OracleState(
            k0[:, :, None].double().abs()), q0d.double().abs()))
    gates["oracle.dense_attention"] = close_gate(
        "oracle.dense_attention",
        head0(oracle.dense_attention(q, keys, values, scale=scale)),
        oracle.dense_attention(q0, k0, v0, scale=scale), ATTN_TOL, dev)
    top = math.ceil(n * BASELINE_TOP)
    truth = torch.zeros_like(truth_scores, dtype=torch.bool).scatter_(
        -1, torch.sort(truth_scores, dim=-1, descending=True,
                       stable=True).indices[..., :top], True)
    bits["oracle"] = 16 * hd                             # a bf16 key

    # SOCKET at P 10 / L 60 / tau 0.4: the paper-literal form
    scfg = sk.SocketConfig(num_planes=10, num_tables=60, tau=0.4)
    def socket_index():                 # Algorithm 1: draw, hash, pack
        w = hashing.make_hash_params(gen, hd, 10, 60)
        signs = hashing.hash_keys_signs(w, keys)
        return w, signs, hashing.pack_signs(signs)

    w, signs, packed = timed("socket", socket_index)
    w0 = w.cpu()
    band["socket keys"] = sign_gate("socket key signs", w0, k0,
                                    head0(signs),
                                    hashing.hash_keys_signs(w0, k0), dev)
    ids = hashing.signs_to_bucket_ids(signs)              # (1, H, N, L)
    equal_gate("signs_to_bucket_ids", head0(ids),
               hashing.signs_to_bucket_ids(head0(signs).cpu()), dev)
    u = sk.soft_hash_query(w, qd)                         # (1, H, G, L, P)
    gates["soft_hash_query"] = close_gate(
        "soft_hash_query", head0(u), sk.soft_hash_query(w0, q0d), SCORE_TOL,
        dev, mag=torch.einsum("...d,lpd->...lp", q0d.double().abs(),
                              w0.double().abs()) / math.sqrt(hd))
    probs = sk.bucket_probs_explicit(u, scfg.tau)         # (1, H, G, L, R)
    gates["bucket_probs_explicit"] = close_gate(
        "bucket_probs_explicit", head0(probs),
        sk.bucket_probs_explicit(head0(u).cpu(), scfg.tau), SCORE_TOL, dev)
    gather = sk.soft_scores_gather(ids[:, :, None], probs)  # (1, H, G, N)
    gates["soft_scores_gather"] = close_gate(
        "soft_scores_gather", head0(gather),
        sk.soft_scores_gather(head0(ids).cpu()[:, :, None],
                              head0(probs).cpu()), SCORE_TOL, dev)
    kernel = ss.socket_score(packed, u, None, num_tables=60, num_planes=10,
                             tau=scfg.tau)                # (1, H, N)
    gates["socket_score vs soft_scores_gather"] = check_close(
        "socket_score against the paper-literal form", kernel,
        gather.sum(2), SCORE_TOL)
    recall["socket"] = top_recall(gather, truth, top)
    bits["socket"] = 600

    # hard LSH (P 2, L 300), HashAttention (128 bits), MagicPig (P 8, L 128)
    def lsh_state(module, cfg, name):
        st = timed(name, lambda: module.build(cfg, gen, keys, values))
        l, p = st.w.shape[:2]
        band[f"{name} keys"] = sign_gate(
            f"{name} key signs", st.w.cpu(), k0,
            hashing.unpack_signs(head0(st.packed), l, p) > 0,
            hashing.hash_keys_signs(st.w.cpu(), k0), dev)
        qs = hard_lsh.query_signs(st.w, qd)
        band[f"{name} query"] = sign_gate(
            f"{name} query signs", st.w.cpu(), q0d, head0(qs) > 0,
            hard_lsh.query_signs(st.w.cpu(), q0d) > 0, dev)
        grouped = dataclasses.replace(st, packed=st.packed[:, :, None])
        cpu = dataclasses.replace(grouped, w=st.w.cpu(),
                                  packed=head0(grouped.packed).cpu(),
                                  **({"vnorm": head0(st.vnorm).cpu()}
                                     if hasattr(st, "vnorm") else {}))
        # the CPU side from the card's query signs
        patch = mock.patch.object(hard_lsh, "query_signs",
                                  lambda *a: head0(qs).cpu())
        return st, grouped, cpu, patch

    hcfg = hard_lsh.HardLSHConfig()
    hst, hg, hcpu, patch = lsh_state(hard_lsh, hcfg, "hard_lsh")
    gates["hard_lsh vnorm"] = close_gate(
        "hard_lsh vnorm", head0(hst.vnorm),
        torch.linalg.vector_norm(v0, dim=-1), SCORE_TOL, dev)
    counts = hard_lsh.score(hg, hcfg, qd)
    card_sel, cpu_sel = [], []
    with selections(sk, card_sel):
        out = hard_lsh.attend(hcfg, hst, q, keys, values, length=n,
                              scale=scale)
    with patch, selections(sk, cpu_sel):
        equal_gate("hard_lsh.score", head0(counts),
                   hard_lsh.score(hcpu, hcfg, q0d), dev)
        cpu_out = hard_lsh.attend(
            hcfg, dataclasses.replace(hcpu, packed=hcpu.packed[:, :, 0]), q0,
            k0, v0, length=n, scale=scale)
    for (ci, cm), (pi, pm) in zip(card_sel, cpu_sel):
        equal_gate("hard_lsh.attend selection", head0(ci), pi, dev)
        equal_gate("hard_lsh.attend selection mask", head0(cm), pm, dev)
    gates["hard_lsh.attend"] = close_gate("hard_lsh.attend", head0(out),
                                          cpu_out, ATTN_TOL, dev)
    recall["hard_lsh"] = top_recall(counts, truth, top)
    bits["hard_lsh"] = hcfg.bits_per_token

    acfg = hash_attn.HashAttnConfig()
    _, ag, acpu, patch = lsh_state(hash_attn, acfg, "hash_attn")
    ascores = hash_attn.score(ag, acfg, qd)
    with patch:
        equal_gate("hash_attn.score", head0(ascores),
                   hash_attn.score(acpu, acfg, q0d), dev)
    recall["hash_attn"] = top_recall(ascores, truth, top)
    bits["hash_attn"] = acfg.bits_per_token

    mcfg = magicpig.MagicPigConfig()
    _, mg, mcpu, patch = lsh_state(magicpig, mcfg, "magicpig")
    mcounts = magicpig.collision_counts(mg, mcfg, qd)
    est = magicpig.attend_estimate(mcfg, mg, qd, keys[:, :, None],
                                   values[:, :, None], scale=scale)
    with patch:
        equal_gate("magicpig.collision_counts", head0(mcounts),
                   magicpig.collision_counts(mcpu, mcfg, q0d), dev)
        gates["magicpig.attend_estimate"] = close_gate(
            "magicpig.attend_estimate", head0(est),
            magicpig.attend_estimate(mcfg, mcpu, q0d, k0[:, :, None],
                                     v0[:, :, None], scale=scale),
            ATTN_TOL, dev)
    cand = mcounts >= mcfg.min_collisions
    recall["magicpig (candidates)"] = (cand & truth).sum().item() / \
        truth.sum().item()
    recall["magicpig candidate share"] = cand.float().mean().item()
    bits["magicpig"] = mcfg.bits_per_token

    # PQCache (m 16, 4 bits, 8 iterations): the full build timed, the
    # first KV head's k-means step by step against the CPU
    pcfg = pqcache.PQConfig()
    pst = timed("pqcache", lambda: pqcache.build(pcfg, gen, keys, values))
    pscores = pqcache.score(dataclasses.replace(
        pst, codes=pst.codes[:, :, None]), pcfg, qd)
    recall["pqcache"] = top_recall(pscores, truth, top)
    bits["pqcache"] = pcfg.bits_per_token
    m, c = pcfg.num_subspaces, pcfg.num_centroids
    x = pqcache._subspaces(head0(keys).reshape(-1, hd), m)
    x0 = x.cpu()
    idx = pqcache._init_indices(gen, n, c, m)
    cent = torch.gather(x, 1, idx[..., None].expand(m, c, x.shape[-1]))
    moved = []
    for it in range(pcfg.kmeans_iters):
        new = pqcache._lloyd_step(x, cent)
        c0 = cent.cpu()
        # the step's assignments, outside the band equal on both sides
        a_card = torch.argmin(pqcache._sq_dists(x, cent), -1).T
        a_cpu = torch.argmin(pqcache._sq_dists(x0, c0), -1).T
        band_it = pq_code_gate(f"pqcache step {it} assignments", x0, c0,
                               a_card, a_cpu, dev)
        stay = torch.ones((m, c), dtype=torch.bool)
        for s_, j in (a_card.cpu() != a_cpu).nonzero().tolist():
            stay[j, a_cpu[s_, j]] = stay[j, a_card[s_, j].item()] = False
        moved.append(band_it["differ_in_band"])
        check_close(f"pqcache step {it} centroids",
                    on_card("pqcache centroids", new, dev)[stay],
                    pqcache._lloyd_step(x0, c0)[stay], SCORE_TOL)
        cent = new
    codes = pqcache._encode(x, cent)
    band["pqcache codes"] = pq_code_gate("pqcache codes", x0, cent.cpu(),
                                         codes, pqcache._encode(x0,
                                                                cent.cpu()),
                                         dev)
    state0 = pqcache.PQState(codebooks=cent, codes=codes.reshape(1, 1, n, m))
    codes0 = codes.cpu().reshape(1, 1, 1, n, m)
    gates["pqcache.score"] = close_gate(
        "pqcache.score",
        pqcache.score(dataclasses.replace(
            state0, codes=state0.codes[:, :, None]), pcfg, head0(qd)),
        pqcache.score(pqcache.PQState(codebooks=cent.cpu(), codes=codes0),
                      pcfg, q0d), SCORE_TOL, dev,
        mag=pqcache.score(pqcache.PQState(
            codebooks=cent.cpu().double().abs(), codes=codes0), pcfg,
            q0d.double().abs()))
    band["pqcache assignments moved in band"] = moved
    stats = dict(shape=BASELINE_SHAPE, top_share=BASELINE_TOP,
                 max_abs_err=gates, in_band=band, recall=recall,
                 bits_per_token=bits, build_s=build_s,
                 pq_vs_socket_build=build_s["pqcache"] / build_s["socket"],
                 card=card)
    log(f"baselines at {BASELINE_SHAPE}: recall of the oracle's top "
        f"{BASELINE_TOP:.0%} (random data: a smoke figure) "
        + ", ".join(f"{k} {v:.3f}" for k, v in recall.items())
        + "; index build s " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         build_s.items())
        + f" (PQ's k-means {stats['pq_vs_socket_build']:.1f}x SOCKET's "
        f"hashing); signs and codes in the rounding band: {band}")
    log(json.dumps({"baselines": stats}))
    return stats


def phase_frontends(dev, seed, card) -> dict:
    """Phase 12: 12a musicgen-medium at full width (f32, ``phase_main``:
    at 48 layers with the logits distances logged, then at
    FRONTEND_GATE_DEPTH with every gate), 12b internvl2-26b at bf16
    (:func:`frontend_full_depth` at 48 layers, then ``phase_main``'s gates
    at FRONTEND_GATE_DEPTH), 12c the baselines (:func:`phase_baselines`).
    Returns each kernel's ``frontends`` entry: its launches on each run's
    main path."""
    runs = {}
    with phase_clock("frontends: musicgen-medium static (12a)", dev):
        runs["musicgen-medium"], params = phase_main(
            dev, seed, card, "musicgen-medium", "f32", int8_run=False,
            gate_logits=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    depth = FRONTEND_GATE_DEPTH["musicgen-medium"]
    with phase_clock(f"frontends: musicgen-medium gated at {depth} layers "
                     "(12a)", dev):
        runs[f"musicgen-medium at {depth} layers"], params = phase_main(
            dev, seed, card, "musicgen-medium", "f32", num_groups=depth,
            int8_run=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("frontends: internvl2-26b full depth (12b)", dev):
        runs["internvl2-26b"] = frontend_full_depth(dev, seed, card)
    depth = FRONTEND_GATE_DEPTH["internvl2-26b"]
    with phase_clock(f"frontends: internvl2-26b gated at {depth} layers "
                     "(12b)", dev):
        runs[f"internvl2-26b at {depth} layers"], params = phase_main(
            dev, seed, card, "internvl2-26b", "bf16", num_groups=depth)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("frontends: baselines (12c)", dev):
        phase_baselines(dev, seed, card)
    return {name: {"launches": {run: counts[name] for run, counts in
                                runs.items()}}
            for name in ("socket_score", "flash_decode", "flash_prefill")}

# ------------------------------------------------------------ phase 13

# rank 0 of three production cells at decode_32k on the 16 x 16 mesh:
# llama31-8b's 8 KV heads do not divide 16, so its cache is split over
# the sequence ("base" gathers it before attending, "opt" takes the
# context-parallel route); gemma-7b's 16 divide it (heads split)
DRYRUN_SHAPE = "decode_32k"
DRYRUN_CELLS = (("llama31-8b", "base"), ("llama31-8b", "opt"),
                ("gemma-7b", "base"))
DRYRUN_WARM = 2
DRYRUN_TIMED = 6
# the real peak against the dry run's hbm_per_device_gb: a miss is a
# fault of the count
DRYRUN_PEAK_REL = 0.10
# a timed step may not beat its floor (the counted FLOPs at the bf16
# peak, or the arguments read once at the HBM rate) by more than this
DRYRUN_FLOOR_SHARE = 1.05
# the kernels the dry run counts, and the shapes their host cost a call
# is read at (the static path's)
DRYRUN_KERNELS = ("socket_score", "flash_decode", "flash_prefill")


def dryrun_count_gate(label, fake, real) -> None:
    """The fake run and the real run count the same FLOPs, kernel calls
    by operator and collective bytes by kind."""
    for key in ("flops", "kernel_calls", "collective_bytes"):
        if fake[key] != real[key]:
            raise AssertionError(f"{label}: {key} counted {fake[key]} on "
                                 f"fake tensors, {real[key]} on the card")


def dryrun_peak_gate(label, peak_bytes, predicted_gb,
                     rel=DRYRUN_PEAK_REL) -> float:
    """The real peak within ``rel`` of the dry run's prediction; returns
    the relative miss."""
    got = peak_bytes / 2 ** 30
    miss = abs(got - predicted_gb) / predicted_gb
    if miss > rel:
        raise AssertionError(f"{label}: peak {got:.3f} GiB is {miss:.1%} "
                             f"from the dry run's {predicted_gb:.3f} "
                             f"(limit {rel:.0%})")
    return miss


def dryrun_floor_ms(flops, argument_bytes) -> float:
    """The least time of a step: its counted FLOPs at the bf16 peak, or
    its arguments read once at the HBM rate."""
    return max(flops / HW["peak_flops"], argument_bytes / HW["hbm_bw"]) * 1e3


def dryrun_floor_gate(label, step_ms, floor_ms,
                      share=DRYRUN_FLOOR_SHARE) -> float:
    """No timed step beats its floor by more than ``share``; returns the
    largest share of the floor."""
    worst = max(floor_ms / ms for ms in step_ms)
    if worst > share:
        raise AssertionError(f"{label}: a step of {min(step_ms):.3f} ms "
                             f"is {worst:.2f} x its floor {floor_ms:.3f} "
                             f"ms (limit {share})")
    return worst


def logits_finite_gate(label, logits) -> None:
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")


def dryrun_launch_gate(label, launches, layers, steps, flash_decode):
    """``socket_score`` layers x steps times, ``flash_decode`` as often
    where the cell attends off the context-parallel route (else never),
    no other kernel."""
    want = {"socket_score": layers * steps,
            "flash_decode": layers * steps if flash_decode else 0}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if got != want or others:
        raise AssertionError(f"{label}: launches {got} (others {others}), "
                             f"expected {want}")


@torch.no_grad()
def dryrun_fill(caches, gen):
    """The cache blocks drawn from ``gen``: K/V normal in their dtype, the
    hash words over every int32, the value norms positive."""
    for layer in caches:
        for name, t in layer.items():
            if name == "bits":
                t.copy_(torch.randint(-2 ** 31, 2 ** 31, t.shape,
                                      generator=gen, device=t.device,
                                      dtype=torch.int32))
            elif name == "vnorm":
                t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                        + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device=t.device))
            else:
                raise AssertionError(f"cache leaf {name} {t.dtype}")


def dryrun_args(plan, dev, seed):
    """Rank 0's arguments on the card: its parameter blocks drawn from
    the seed (``fsdp.init_shards``), its cache blocks (:func:`dryrun_fill`),
    the global batch's token ids, the last cache row."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch import dryrun
    params = fsdp.init_shards(plan.cfg, seed, fsdp.flat_tree(plan.params_sh),
                              dev)
    _, caches, inp, pos = dryrun.make_args(
        plan, dev, leaf=lambda shape, dtype: torch.empty(
            shape, dtype=dtype, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    dryrun_fill(caches, gen)
    inp = torch.randint(0, plan.cfg.vocab_size, inp.shape, generator=gen,
                        device=dev, dtype=inp.dtype)
    return params, caches, inp, pos


def dryrun_fakes() -> dict:
    """Each of ``DRYRUN_CELLS``' dry run on fake tensors: (counts, record)
    by (arch, variant).  The host's alone, so the full run makes them
    while the kernels build."""
    from repro_torch.launch import dryrun
    return {(arch, variant): dryrun.build_cell(arch, DRYRUN_SHAPE,
                                               variant=variant)
            for arch, variant in DRYRUN_CELLS}


def dryrun_cell(dev, seed, card, arch, variant, fake) -> dict:
    """Phase 13a for one cell: its dry run on fake tensors (``fake``:
    :func:`dryrun_fakes`' counts and record), then rank 0's step for real
    (counted once, warmed, timed, once more with the collectives timed),
    each gate."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    label = f"dryrun {arch} {DRYRUN_SHAPE} {variant}"
    fake, rec = fake
    rl = rec["roofline"]
    log(f"{label}: fake run traced in {rec['trace_s']} s; "
        f"{rec['hbm_per_device_gb']} GiB a device "
        f"({rec['memory_analysis']}); {fake['flops'] / 1e9:.3f} GFLOP, "
        f"{fake['bytes'] / 1e9:.3f} GB, collectives "
        f"{rec['collective_bytes']}; roofline compute {rl['compute_s']:.6f}"
        f" s, memory {rl['memory_s']:.6f} s, collective "
        f"{rl['collective_s']:.6f} s, dominant {rl['dominant']}; kernels "
        f"{rec['kernel_calls']} (computed from {card}'s data sheet, not "
        "measured)")
    plan = dryrun.plan_cell(arch, DRYRUN_SHAPE, variant=variant)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    args = dryrun_args(plan, dev, seed)
    torch.cuda.synchronize()
    log(f"{label}: rank 0's blocks drawn in {time.perf_counter() - t0:.1f}"
        f" s, {(torch.cuda.memory_allocated(dev) - base) / 2 ** 30:.3f} "
        "GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    step = dryrun.make_step(plan)
    reset_launches()
    real = dryrun.count_step(step, args, plan.chips)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    dryrun_count_gate(label, fake, real)
    miss = dryrun_peak_gate(label, peak, rec["hbm_per_device_gb"])
    params, caches, inp, pos = args
    ms = []
    with collectives.dry_run():
        for _ in range(DRYRUN_WARM):
            step(params, caches, inp, pos)
        for _ in range(DRYRUN_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, caches = step(params, caches, inp, pos)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        logits_finite_gate(label, logits)
        collectives.TIMING["on"] = True
        seconds = dict.fromkeys(collectives.SECONDS, 0.0)
        collectives.SECONDS.update(seconds)
        try:
            step(params, caches, inp, pos)
        finally:
            collectives.TIMING["on"] = False
        gathers = collectives.SECONDS["all_gather"]
    torch.cuda.synchronize()
    launches = read_launches()
    layers = plan.cfg.num_layers
    steps = 1 + DRYRUN_WARM + DRYRUN_TIMED + 1
    dryrun_launch_gate(label, launches, layers, steps, variant == "base")
    floor = dryrun_floor_ms(real["flops"],
                            rec["memory_analysis"]["argument_size_in_bytes"])
    share = dryrun_floor_gate(label, ms, floor)
    mem_ms = rl["memory_s"] * 1e3
    log(f"{label}: counts equal on the card ({real['flops']} FLOP, "
        f"kernels {real['kernel_calls']}); peak {peak / 2 ** 30:.3f} GiB "
        f"({miss:.1%} from the dry run's {rec['hbm_per_device_gb']}); "
        f"steps {[round(x, 3) for x in ms]} ms; floor {floor:.4f} ms "
        f"(largest share {share:.4f}); memory term {mem_ms:.3f} ms "
        f"(share {mem_ms / min(ms):.4f}); gathers {gathers:.4f} s of a "
        f"step timed with the collectives synchronised; launches "
        f"{ {k: launches[k] for k in DRYRUN_KERNELS} }; {card}")
    del params, caches, inp, args, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={k: launches[k] for k in DRYRUN_KERNELS},
                step_ms=ms, floor_ms=floor, floor_share=share,
                peak_gib=peak / 2 ** 30,
                predicted_gib=rec["hbm_per_device_gb"],
                gather_s=gathers, trace_s=rec["trace_s"], roofline=rl)


def operator_host_us(dev, seed) -> dict:
    """Phase 13b: the host's microseconds a call of each kernel operator's
    wrapper at the static path's shapes, through the dispatcher (as a
    fake run or a counting mode calls it) and as the port calls it on
    plain CUDA tensors, straight to the C launch
    (``build.dispatch_free``), in one run."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import cases
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(bh=16, n=8224, g=4, l=60, p=10, int8=False, vnorm=False)
    score = [socket_score_case(dev, gen, **kw)[:2] for _ in range(4)]
    decode_kw = dict(cases.CARD_CASES)["main path"]
    decode = [cases.card_case(gen, **decode_kw) for _ in range(4)]
    qp = torch.randn((64, 512, 128), generator=gen, device=dev)
    kp = torch.randn((16, 512, 128), generator=gen, device=dev)
    calls = {
        "socket_score": (functools.partial(
            ss.launch_socket_score, vnorm=None, num_tables=60, num_planes=10,
            tau=0.4), score),
        "flash_decode": (functools.partial(fd.launch_flash_decode,
                                           scale=0.088), decode),
        "flash_prefill": (functools.partial(fp.launch_flash_prefill,
                                            scale=0.088),
                          [(qp, kp, kp)] * 4),
    }
    out = {}
    for name, (fn, sets) in calls.items():
        with mock.patch.object(build, "dispatch_free", lambda t: False):
            op = host_us(fn, sets)
        direct = host_us(fn, sets)
        out[name] = dict(operator=op, direct=direct)
        log(f"{name}: host {op:.1f} us a call through the operator, "
            f"{direct:.1f} us straight to the launch")
    return out


def phase_dryrun(dev, seed, card, fakes=None) -> dict:
    """Phase 13: 13a rank 0 of each of ``DRYRUN_CELLS`` for real
    (:func:`dryrun_cell`; ``fakes`` their dry runs, made here where
    None), 13b the operators' host cost a call.  Returns each counted
    kernel's ``dryrun`` entry: its launches in each cell's run and its
    host microseconds a call."""
    fakes = fakes or dryrun_fakes()
    cells = {}
    for arch, variant in DRYRUN_CELLS:
        with phase_clock(f"dryrun: {arch} {variant} (13a)", dev):
            cells[f"{arch} {variant}"] = dryrun_cell(
                dev, seed, card, arch, variant, fakes[arch, variant])
    log(json.dumps({"dryrun_cells": {
        c: {k: v for k, v in r.items() if k != "launches"}
        for c, r in cells.items()}}))
    host = operator_host_us(dev, seed)
    return {name: dict(launches={c: r["launches"][name]
                                 for c, r in cells.items()},
                       host_us=host[name])
            for name in DRYRUN_KERNELS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only",
                    choices=["state-moe", "bf16", "train", "cp",
                             "cp-backends", "mesh", "ep", "pipe",
                             "cp-hybrid", "frontends", "dryrun"],
                    default=None,
                    help="build the kernels and run this phase alone "
                         "(5e, 5f, 8, 9, 9c, 10, 11a, 11b, 11c, 12 or 13); "
                         "prints neither the kernels line nor the ok line")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    # the port is not installed: outside a checkout this import fails
    from repro_torch.launch.serve import card_line
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    if args.only == "state-moe":
        build_kernels()
        t0 = time.perf_counter()
        phase_state_moe(dev, args.seed, card)
        log(f"state and MoE phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "bf16":
        build_kernels()
        t0 = time.perf_counter()
        rows, _ = phase_bf16(dev, args.seed, card)
        log(json.dumps({"bf16_kernels": rows}))
        log(f"bf16 phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "train":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"train": phase_train(dev, args.seed, card)}))
        log(f"train phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "cp":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"cp": phase_cp(dev, args.seed, card)}))
        log(f"context-parallel phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "cp-backends":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"cp-backends": cp_entries(phase_cp_model(
            dev, args.seed, card, runs=CPB_BACKENDS))}))
        log(f"context-parallel phase 9c: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "mesh":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"mesh": phase_mesh(dev, args.seed, card)}))
        log(f"mesh-train phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "frontends":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"frontends": phase_frontends(dev, args.seed, card)}))
        log(f"frontends phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only == "dryrun":
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({"dryrun": phase_dryrun(dev, args.seed, card)}))
        log(f"dryrun phase: {time.perf_counter() - t0:.1f} s")
        return 0
    if args.only in ("ep", "pipe", "cp-hybrid"):
        build_kernels()
        t0 = time.perf_counter()
        log(json.dumps({args.only: phase_parallel(dev, args.seed, card,
                                                  args.only)}))
        log(f"parallel phase ({args.only}): {time.perf_counter() - t0:.1f} s")
        return 0
    t0 = time.perf_counter()
    builds = start_builds()
    fakes = dryrun_fakes()
    log(f"dryrun: the fake runs, beside the builds: "
        f"{time.perf_counter() - t0:.1f} s")
    rows = phase_kernels(dev, args.seed, builds)
    log(f"kernel phase (contiguous kernels): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, params = phase_main(dev, args.seed, card)
    log(f"main phase: {time.perf_counter() - t0:.1f} s")
    # the paged cases on an empty card (beside llama31-8b's 32 GB they
    # left the parent holding memory phase 10's ranks needed), the same
    # weights drawn again after them
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows.update(phase_paged_kernels(dev, args.seed, builds))
    log(f"kernel phase (paged kernels): {time.perf_counter() - t0:.1f} s")
    params = draw_params(dev, args.seed, "llama31-8b")
    # the continuous runs: each fused backend on f32 pages, then on int8
    # and fp8 pages (entries name[int8], name[fp8]) on the same weights,
    # all at QUANT_DEPTH layers (phase 5f runs socket_fused at full depth,
    # at bf16), as the prefix, sampling, observability and legacy runs
    chunked = {}                # arch -> socket_fused f32 run's tokens
    f32_runs = {}               # backend -> its f32 run's (tokens, wall s)
    for backend in FUSED:
        auto = None
        for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
            t0 = time.perf_counter()
            counts, tokens, wall_s = phase_continuous(
                dev, args.seed, card, params, backend, kv_dtype=kv_dtype,
                num_groups=QUANT_DEPTH)
            if auto is None:
                f32_runs[backend] = (tokens, wall_s)
            auto = auto or tokens
            suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
            launches.update({k + suffix: v for k, v in counts.items()})
            gc.collect()
            torch.cuda.empty_cache()
            log(f"continuous phase ({backend}, {kv_dtype}): "
                f"{time.perf_counter() - t0:.1f} s")
        if backend == "socket_fused":
            chunked["llama31-8b"] = auto
    # the prefix cache and sampling on the same weights
    for backend, kv_dtype in (("socket_fused", "auto"),
                              ("quest_fused", "auto"),
                              ("socket_fused", "int8")):
        t0 = time.perf_counter()
        launches.update(phase_prefix(dev, args.seed, card, params, backend,
                                     kv_dtype, QUANT_DEPTH))
        log(f"prefix phase ({backend}, {kv_dtype}): "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_sampling(dev, args.seed, card, params,
                                   QUANT_DEPTH))
    log(f"sampling phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_observability(dev, args.seed, card, params,
                                        f32_runs, QUANT_DEPTH))
    log(f"observability phase: {time.perf_counter() - t0:.1f} s")
    legacy_phase(dev, args.seed, card, params, "llama31-8b", chunked,
                 launches, QUANT_DEPTH)
    del params                                  # llama31-8b's 32 GB
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches.update(phase_all_global(dev, args.seed, card))
    log(f"all-global phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_state_moe(dev, args.seed, card))
    log(f"state and MoE phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16_rows, bf16_launches = phase_bf16(dev, args.seed, card)
    # socket_score's inputs are the same at bf16 (bits, f32 u, bf16 vnorm):
    # its entry holds the bf16 run's launches alone
    bf16_rows.setdefault("socket_score", {})
    for name, entry in bf16_rows.items():
        rows[name]["bf16"] = dict(
            entry, launches=bf16_launches.get(f"{name}[bf16]", 0))
    launches.update(bf16_launches)
    log(f"bf16 phase: {time.perf_counter() - t0:.1f} s")
    params = draw_params(dev, args.seed, "gemma3-27b")
    auto = None
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
        t0 = time.perf_counter()
        gemma, tokens, _ = phase_continuous(
            dev, args.seed, card, params, "socket_fused", arch="gemma3-27b",
            kv_dtype=kv_dtype, ref_tokens=auto and ("auto", auto))
        auto = auto or tokens
        suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
        launches["paged_ring" + suffix] = gemma["paged_ring"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"gemma3-continuous phase ({kv_dtype}): "
            f"{time.perf_counter() - t0:.1f} s")
    chunked["gemma3-27b"] = auto
    legacy_phase(dev, args.seed, card, params, "gemma3-27b", chunked,
                 launches)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows["flash_prefill"]["train"] = phase_train(dev, args.seed, card)
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, entry in phase_cp(dev, args.seed, card).items():
        rows[name]["cp"] = entry
    log(f"context-parallel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["flash_prefill"]["mesh"] = phase_mesh(dev, args.seed, card)
    log(f"mesh-train phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, entries in phase_parallel(dev, args.seed, card).items():
        rows[name].update(entries)
    log(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, entry in phase_frontends(dev, args.seed, card).items():
        rows[name]["frontends"] = entry
    log(f"frontends phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, entry in phase_dryrun(dev, args.seed, card, fakes).items():
        rows[name]["dryrun"] = entry
    log(f"dryrun phase: {time.perf_counter() - t0:.1f} s")
    kernels = [dict(row, launches=launches[name]) for name, row in
               rows.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
