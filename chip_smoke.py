"""On-card smoke run of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version, serve the full-width flagship model over
HTTP, train it with BCE (f32, int8 and bf16 tables) and with the in-batch
sampled softmax, eagerly and as CUDA graphs of 16 steps, fed packed and
compact batches, with the bf16 aggregation buffer, serve the int8- and the
bf16-trained model, train with bf16 parameters, train the concat-MLP
ranker (f32 and bf16), several seeds and sweeps
over spawned workers, run the gather
probe, train the small learnable models to a target AUROC and a target
recall@10, run the Instacart pipeline (replica -> prepare -> train through
a wire cache -> recall@100) through its entry points, and on its shards the
rest of a user's workflow: train with
checkpoints -> crash -> restart and resume -> register -> promote -> serve
by stage -> batch-score a split (TTRS and parquet) -> the per-user
retrieval table, and a profiler trace of replayed steps; and the
text-side-features example.

    python3 chip_smoke.py [--profile]

Needs one CUDA card, `nvcc` and this repository's sources; exits non-zero
without a card. Phases (any failure raises and exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the kernels of `csrc/` with nvcc, one nvcc per source, all at once,
   timed;
3. `[kernel]` each kernel against its plain version on the card at the main
   paths' shapes, with median CUDA-event times of both:
   pooled gather (#1, flagship user table, 8,192 bags): exact at one slot (f32
   and bf16) and for sentinel ids, relative 1e-5 at three mean-weighted slots;
   also exact at the other serving sizes (1, 16, 100 and 1,000 bags; the
   1-bag time is the kernel's latency floor), at the BCE train step's two
   calls (262,144 bags into bf16, the user table with sorted ids, the item
   table) from the f32 tables and from the bf16 ones, and at the softmax
   step's two (8,192 bags from the f32 tables into bf16), each with its
   bound and its launch plan; the host ms of one serving call;
   row-wise Adagrad (#4, 262,144 ids with duplicates and sentinels, f32 and
   bf16 gradients, on the user table and through the item table's device
   sort): untouched rows bitwise, the rest within rtol 1e-5;
   tower backward (#8, B = 262,144, [128 -> 128 -> 64], bf16 and f32 io): dx,
   dW1 and dW2 within one bf16 ulp of their largest magnitude, db within 1e-5
   x max, two launches bit for bit equal; beside it the time of the same
   function as bf16 GEMMs and masks (`composed_ms`);
   the fused sampled softmax (#9 forward, #10 dq, #11 dc; D = 64, bf16-valued
   inputs, repeating item ids and logQ): 8,192 x 8,192, the same with
   `n_valid` = 8,000, 65,536 x 65,536, and the stripe of 16,384 rows at row
   offset 32,768 against 65,536 columns; 8,192 x 8,192 at D = 128, and
   stripes of 2,048 rows at D = 64 and 128; a stripe's lse must equal those
   rows of the square case and its dq be them bit for bit; lse within rtol
   2e-5 / atol 1e-5, dq and dc within 1e-3 x their largest magnitude with
   cosine > 0.99999, two launches of each of the three bit for bit equal;
   #10's and #11's share of the bound, registers and spills, and launch
   plan (chunks, a merge launch); beside #10 and #11 the time of the same
   function as bf16 GEMMs and elementwise calls (`composed_ms`);
   the fused tower forward (tower_fwd: both layers' GEMMs, biases and
   ReLUs, ties summed again in k order, h1 kept on chip) at the BCE step's
   two tower calls ([262,144, 128 -> 128 -> 64]), at H2 = 128 and on
   inputs whose every layer-1 sum sits at a bf16 rounding tie: within 2^-8
   x max|plain| of its plain version, two launches bit for bit, the share
   bit for bit, the ReLU decisions that differ (none from the k-order
   route's at the ties), the share of each layer recomputed, its ms and
   share of its bound beside the two-GEMM route's (cuBLAS `_mm` and
   relu_ties a layer) split by call, a BCE step's two calls, and a tile's
   time split into the kernel's stages (x loads, products, epilogues, tie
   rounds, output stores: each stage's ms added to the run up to it);
   relu_ties (that route's bias and ReLU, off the main path) at its four
   calls a BCE step (layer 1 [262,144, 128], layer 2 [262,144, 64], K =
   128) and on a layer whose every sum sits at a bf16 rounding tie: bit for
   bit its plain version (values), two launches bit for bit, the share of
   values it sums again in k order, its ms a call and a BCE step;
   beside each kernel's time: its plain version's, the card's bound for the
   same work (bytes, operations, or for the softmax kernels one exp a score), and where one PyTorch call computes the same function
   (`embedding_bag` for the pooled gather) that call's time;
4. `[serve]` the flagship (206,209 users x 49,688 items, dim 128, towers
   (128, 64), f32, random weights from a seeded generator) served through
   `Scorer`, `RetrievalService` and `ModelServer`: /invocations at 1, 100 and
   8,192 rows and one dataframe_split payload, /retrieve for 16 and 1,000
   users at k = 100. Each group of requests must launch the pooled-gather
   kernel exactly as often as the path says (7 for the corpus export, 2 per
   /invocations, 1 per /retrieve: 57 in all). The answers are checked after
   that, outside the count, against direct calls, a plain-PyTorch forward and
   a brute-force top-k;
5. `[train]` the flagship in bf16 compute at batch 262,144, host-sorted by
   user id with the label packed into the ids, through `create_train_state`
   and `make_train_step`: two warm-up steps, then ten counted steps, each of
   which must launch the pooled gather, row-wise Adagrad and the tower
   backward exactly twice and tower_fwd twice. After the count: the
   loss is finite, untouched table rows kept their bits, one step from a
   copied state agrees with the same step on the host CPU (where every
   wrapper takes its plain version; each quantity's margin, its largest
   difference over its bound, printed), and a few validation batches give
   the eval loss and AUROC;
6. `[learn]` the verify drive on the card: a (64, 32) model on 2,000 x 500
   learnable synthetic interactions, 2 epochs x 120 batches x 1,024 through
   `train_val_test`; the validation AUROC must start within 0.45-0.55 and
   end at 0.70 or above;
7. `[train-softmax]` the flagship in f32 compute at batch 8,192 with
   `loss="sampled_softmax"`, logQ correction and `softmax_kernel="on"`: two
   warm-up and ten counted steps, each of which must launch kernels #9, #10
   and #11 once, the pooled gather and row-wise Adagrad twice and the tower
   backward never (f32 compute is off its gate). After the count: the loss
   is finite, `item_counts` sums to 12 x 8,192, one step from a copied state
   agrees with the host CPU. Then three steps at batch 65,536 with the
   kernels and three with `softmax_kernel="off"` (the chunked plain route),
   and two bf16-compute steps at 8,192, where the tower backward launches
   twice a step beside the softmax kernels;
8. `[learn-softmax]` a (32, 16) linear-head model on 120 x 60 learnable
   synthetic interactions, sampled softmax at batch 512 through the kernels,
   5 epochs x 50 batches through `train_val_test` with the per-epoch
   retrieval eval and `select_best="val_recall_at_10"`: recall@10 against the
   ground-truth top-10 must end above 0.35; then, not counted, the same drive
   from one state drawn on the host and copied to the card: one step on each
   (tables within 2^-7 x max of the host's; each tower gradient's distance
   printed, with the loss's backward through the kernels, through the plain
   version on the card and with p kept in f32 on both sides) and recall@10
   per epoch side by side;
9. `[kernel]` (run with the other kernel checks) the int8 slice's kernels at
   the int8 train step's shapes: the int8 pooled gather (#5) on the flagship
   user table quantized from a seeded draw, 8,192 x 1 f32 out, 262,144 x 1
   bf16 out, sentinel ids, and 1 and 100 bags (the 1-bag time its latency
   floor) bit for bit, 8,192 x 3 mean-weighted slots within 1e-5 x max, and
   the host ms of one serving call; the fused int8 row-wise Adagrad (#6)
   with 262,144 sorted ids (f32 and bf16 gradients), through the item
   table's device sort, and through it on item ids drawn as rank^-1 (a hot id of about
   22,000 positions): untouched rows bit for bit, scales and accumulators
   within rtol 1e-5, int8 values within one step, two launches bit for bit
   equal; row-wise Adagrad (#4) on those skewed ids against an f32 item
   table (untouched rows bitwise, the rest within rtol 1e-5, two launches
   bit for bit equal); the dense aggregate (#3) at the user table's sorted
   ids and at the skewed ids (their gradients in sorted order): rows
   without ids exact zero, the rest within rtol 1e-5 (on the skewed ids
   each element within 1e-5 x its sum of magnitudes: a hot id sums 21,842
   terms), two launches on the skewed ids bit for bit equal,
   `zeros.index_add_` timed beside it; the row subtract (#7) on the user
   batch's distinct ids: bit for bit;
10. `[train-int8]` phase 5 with `table_dtype="int8"`: each counted step must
   launch the int8 gather, the int8 Adagrad and the tower backward twice and
   the f32 tables' kernels never; tables still int8, untouched rows' bytes
   and scales kept, the host check (one quantization step on top), and the
   same check with the forward's tie repair taken out (its margins printed
   beside, not held), eval. Then three steps with a 20,000,000-row int8 user table (2.56e9 int8
   elements), created chunk by chunk: a named row past 2^24 changes, its
   unnamed neighbour does not;
11. `[train-override]` the f32 flagship in f32 compute: three steps each with
   the default update, `sparse_update=block_sorted_rowwise_adagrad` (#3,
   twice a step) and `sparse_update=pallas_sparse_rowwise_adagrad` (#7,
   twice a step); the three end states agree within rtol 1e-5 / atol 1e-6;
12. `[serve-int8]` the int8-trained model through `Scorer` (1, 100, 8,192
   rows: 2 int8 gather launches each, and 2 of tower_fwd in the bf16 predict
   of 8,192 rows) and `RetrievalService` (7 for the
   corpus export, 1 per retrieve), against a plain forward over the
   dequantized tables and a brute-force top-k; then `export_model` ->
   `load_scorer` predicts the same within 1e-6;
13. `[learn-int8]` phase 6 with int8 tables, the same AUROC bars;
14. `[kernel]` (with the other kernel checks) the block-sums kernels (#12,
   #13) at [262,144, 128] f32, 2 x [262,144, 64] f32 and [262,144, 128] bf16:
   each block within 1e-5 x its sum of magnitudes of the plain version, two
   launches bit for bit equal; and row-wise Adagrad (#4) on the user table
   stored in bf16 with f32 gradients: untouched rows bit for bit, touched
   rows equal to the plain version's or one bf16 ulp apart;
15. `[probe]` the gather probe (`tools/probe_consumer.py` of the port) at its
   full shapes, seven cases, one line each; #12 and #13 are counted here;
16. `[train-graph]` the flagship BCE step (f32, int8 and bf16 tables, batch
   262,144, bf16 compute) and the sampled-softmax step (batch 8,192, f32 and
   bf16 compute), K = 16 steps as
   one CUDA graph through `make_multi_step`: from two copies of one fresh
   state, 16 eager steps and one multi-step over the same 16 batches, then a
   second macro of another payload against 16 more eager steps; the end
   states compared tensor by tensor (tables, accumulators, towers, Adam's
   moments and counts, item counts), bit for bit; then the median time per
   step eager and replayed over 5 macros of distinct payloads, the launches
   captured per step, the replays, and the peak memory both ways; under
   --profile a replay's trace, and in the softmax steps #10's and #11's
   device ms a replayed step (with their merge launches) beside #9's;
16b. `[train-compact]` phase 16's BCE step with f32 tables fed the compact
   wire (the user slot delta-encoded): the decode on the card bit for bit
   `unpack_batch` (with and without the delta slot, and a batch whose
   sidecar holds exceptions); K = 16 graphs over CompactBatch payloads
   beside the same batches as PackedBatch payloads from two copies of one
   state, 2 macros, the end states bit for bit equal; the compact graph's
   warm-up and capture are counted (the BCE step's launches a step); the
   payload bytes a step of both, their replayed ms a step, a macro's
   host-to-device copy ms and the decode's device ms a step;
17. `[train-skew]` phase 16's BCE step with f32 tables on a heavy-tailed
   catalogue: `SyntheticClickstream(popularity=1.0)` draws items as rank^-1
   (item runs of thousands of positions in each batch, printed), K = 16
   graph against eager steps as in phase 16, then, from a fresh state after
   12 eager steps, one step against the host CPU as in phase 5, and, from
   another, after 560 steps replayed as graphs, the same; both again with
   the forward's tie repair taken out (measured, not held), the margins
   side by side;
   under --profile #4's device ms a replayed step;
18. `[learn-packed]` the verify drive through `train_one_epoch_packed`
   (macro 8, a tail step, mid-epoch validation): 2 epochs x 125 batches,
   steps and examples counted, val AUROC 0.45-0.55 -> 0.70 or above;
19. `[train-bf16tab]` the f32-compute flagship with `table_dtype="bfloat16"`
   and `block_sorted_kernel="off"` at batch 262,144: each counted step
   launches the pooled gather and row-wise Adagrad twice, tables of
   52,789,504 + 12,720,128 bytes, a step against the host CPU, eval; the
   same step with f32 tables beside it; `[learn-bf16tab]` (phase 6 with bf16
   tables) and `[serve-bf16tab]` (phase 12 on the bf16-trained state);
20. `[pipeline]` the Instacart pipeline through its entry points, in a
   temporary directory: `cli.instacart_pipeline.main` with --smoke (8,000
   users, 4,000 products, seed 0) --packed --fast (the compact wire through
   a wire cache the run builds), flagship widths, BCE, 3 epochs of batch
   8,192, on the card; then one sampled-softmax epoch on the same shards
   (`cli.train` reusing the cache, `cli.evaluate_retrieval`). Each run's
   launches must equal its steps x a step's launches (warm-up, capture and
   tail steps; replays run without Python) plus two gathers an eval batch
   (and two tower_fwd an eval batch of a multiple of 512 rows) and the
   retrieval exports'; BCE recall@100 over every test user >= 0.35; the
   replica, prepare, the cache's build seconds and bytes, train epochs (and
   examples/s) and eval seconds beside the card's name and power limit;
21. `[resume]` on phase 20's shards, BCE, 3 epochs of 8,192, --fast's
   flags (each run its own wire cache, which the restart reuses):
   `cli.train --checkpoint-dir` uninterrupted, then under
   `resilient_fit` a run whose first attempt raises an OSError right after
   epoch 1's checkpoint and whose restart runs `cli.train --resume`. The
   two last checkpoints (tables, accumulators, towers, Adam's moments and
   counts, step) must be equal bit for bit; restarts 1, resumed at epoch 1's
   step; each run's launches equal its steps' and evals' (the restart adds
   one capture and one baseline eval); the checkpoint's bytes, save and
   restore seconds and the resumed epoch's seconds beside the card line. The
   same with `--table-dtype int8` (#5, #6);
22. `[registry]` each resumed run's state registered with
   `register_from_run` (its `ExperimentLogger` run) and promoted to
   Production, f32 then int8: the first becomes Archived; each version's
   files equal the run's own export; `load_scorer_from_registry` on the card
   predicts bit for bit what `load_scorer` of the run's export predicts; a
   `ModelServer` on that scorer answers three `/invocations` (2 launches of
   #1 each, and tower_fwd 2 in the bf16 one of 8,192 rows);
23. `[batch-predict]` `batch_predict` with the registry's scorer over the
   smoke test split (raw columns, prepared from the same CSVs): as many rows
   as the input's index, each batch's `prediction` bit for bit
   `Scorer.predict` of its rows, 2 launches of #1 a batch (and 4 of
   tower_fwd a full batch: bf16 compute), rows/s;
24. `[per-user-table]` `cli.evaluate_retrieval --per-user-table` in a child
   process on the Production model: one CSV row per evaluated user, the
   mean of its recall_at_100 column within 1e-6 of the run's recall@100;
25. `[profile-trace]` `profile_trace` around one replay of 3 captured steps
   on the smoke shards: the trace names the gather (#1) and Adagrad (#4)
   kernels; `device_memory_stats()` and a `StepTimer` summary of 5 replays;
26. the bf16 buffer, the ranker, tuning, parquet input and text features:
   `[kernel]` #4 and #6 with `buffer_dtype=bf16` at 262,144 sorted user ids
   and on rank^-1 item ids (a hot run of about 21,800 positions): on probe
   inputs (rows 0, accumulators 2^60, lr 1) bit for bit their plain
   versions, two launches too, and not the f32 sums; on ordinary inputs
   within rtol 1e-5; their times beside the f32 buffer's on the same
   inputs; #3 with the device sort's permutation at the ranker's 8,192
   slots into the user and the item table: bit for bit the CPU's ordered
   sum, `zeros.index_add_` beside it;
   `[train-bf16buf]` phase 16's BCE graph with `block_sorted_kernel="off"`
   and `scatter_buffer_dtype="bfloat16"`, f32 and int8 tables (the user
   table's update seen taking the bf16 buffer), each with the host check
   after eager steps, and the same f32-table config with the f32 buffer
   beside it;
   `[batch-predict-parquet]` and `[text-features]` in a child process
   (pandas and pyarrow load there): the smoke test split written as
   parquet and scored through `batch_predict(input_format="parquet")`,
   predictions bit for bit `[batch-predict]`'s; the text-side-features
   example on the card;
   `[ranker]` the concat-MLP ranker at flagship widths, batch 8,192, three
   Adam steps (2 launches of #1 and 2 of #3 a step) against the plain route
   on the card and a host step;
   `[multi-seed]` `multi_seed_train` with 3 seeds at flagship widths, 4
   steps of 8,192 and an eval batch; seed 1 alone bit for bit;
   `[sweep]` random (3 trials) and TPE (4 trials) sweeps over 2 spawned
   worker processes, each trial training the flagship on this card;
26b. data parallelism with sharded tables: `[mesh]` the flagship BCE step
   (bf16 compute, f32 tables, batch 262,144 sorted by user) on a one-rank
   NCCL group, its plan the planner's at 2-8 devices (user table
   row-sharded, item table table-wise) forced on one: 3 eager sharded steps
   counted (#1, #4, #8 and tower_fwd twice a step), against the one-device
   step from the same start at the reference's bars (largest differences
   printed), then K = 16 sharded steps as one CUDA graph with its NCCL
   collectives captured, bit for bit the eager sharded steps, its replayed
   ms a step beside the one-device graph's; `[shard-kernels]` the
   shard-local work of 4 ranks run in turn on the gathered global batch,
   the user table row-sharded (sorted path) and the item table as a
   table-wise bucket (device sort): the partial pools (#1) sum to the
   one-device gather bit for bit, each shard's #4 update is the one-device
   update's rows bit for bit (padded and untouched rows unchanged), each
   shard's #4 ms beside the one-device call's;
26c. M12(b) on the same one-rank group: `[mesh-int8]` `[mesh]` with int8
   tables under the planner's int8 plan (items in `__tw_bucket_d128_int8__`):
   3 counted steps (#5, #6, #8, tower_fwd twice a step) against the
   one-device int8 steps, the K = 16 graph bit for bit, replayed ms beside
   the one-device int8 graph's; `[mesh-a2a]` the item table forced
   row-sharded through `sharded_exchange="alltoall"` (capacity 1.25): 3
   counted steps (#1 three times, #3 once a step), one step against the dense exchange
   from one start (the forward and the towers bit for bit, the item rows
   within one bf16 rounding of their pre-aggregated sums), 3 steps with the
   block kernels in f32 against the dense exchange at the reference's bars,
   the bf16 wire at the reference's bars, a capacity of 0.05 that overflows
   (the count, and `train_one_epoch_packed` raising), the K = 16 graph with
   `all_to_all_single` captured bit for bit, replayed ms beside the dense
   sharded and one-device graphs'; `[mesh-column]` the item table forced
   column-sharded: a batch's pools bit for bit the one-device step's, 3
   counted steps (#1 twice, #4, #3 once a step) within atol 1e-5 of the
   one-device steps, the K = 16 graph bit for bit; `[shard-kernels]` again
   with int8 tables (#5 pools, #6 rows bit for bit), the all-to-all exchange
   by hand over 4 ranks (routes, #3, the buffers transposed, each owner's #1
   and #4: the pool bit for bit, the tables within atol 1e-5, the overflow
   the plain route's) and 4 column shards (#1 joined bit for bit, #3 and the
   epilogue within atol 1e-5), each shard's ms beside the one-device call's;
   `[kernel]` #1 with `round_rows` (bags of 4 and 16 slots into bf16 and the
   BCE step's item call): bit for bit its plain version, its ms beside the
   mode off;
26d. M12(c) on the same one-rank group: `[serve-mesh]`
   `RetrievalService(mesh=)` over the 49,687-item corpus, k = 100, for 16
   and 1,000 users (counted: 7 + 2 launches of #1), items and scores bit for
   bit the one-device service's, then the corpus in 4 shards by hand
   (`topk_shard_candidates`, the pad row masked, `topk_merge`) bit for bit
   the one-device top-k, each shard's and the merge's device ms and the
   direct calls' ms beside the one-device service's; `[mesh-softmax]`
   `[train-softmax]`'s f32 batch of 8,192 with logQ through the sharded
   step (the data-parallel softmax's stripe at row offset 0): 3 counted
   steps (#1, #4 twice, #9, #10, #11 once a step) against the one-device
   steps, the K = 16 graph with the all-gather, the backward's
   reduce-scatter and the count's all-reduce captured bit for bit the eager
   steps, replayed ms beside the one-device graph's; `[mesh-compact]`
   `[mesh]`'s graph fed compact payloads placed by `compact_shardings`
   (counted: its first call), bit for bit the sharded packed graph and the
   one-device compact graph after 32 steps, replayed ms of the three;
   `[shard-kernels]` the 8,192 batch's 4 stripes of [2,048, 8,192] at row
   offsets 0-6,144, at D = 64 and again at D = 256: #9, #10 and #11 against
   their plain versions (each launched, counted; at D = 256 each of #10 and
   #11 after its p kernel), the stripes' dc summed
   against the square's, (num, den) summed against the whole batch's, each
   stripe's kernel ms beside its bound;
26e. the wide softmax and the device-sorted gather: `[kernel]` #9, #10 and
   #11 at D = 192 and 256 on the 8,192 square and at D = 2,048 on a 4,096
   square and its stripe of 1,024 rows (its lse equal to the square's rows,
   its dq bit for bit), with `[kernel]`'s bars, two launches bit for bit,
   kernel, plain, bound and composed ms; there #10 and #11 are the p kernel
   (`softmax_lse_p`) and two products: the p kernel's panel against the
   plain one (every p of weight bit for bit, the rest within one bf16 ulp),
   each product against its plain version, `softmax_lse_grads` bit for bit
   the single wrappers, each piece's and the whole backward's kernel, plain
   and bound ms (the function's and the three launches'), and at 8,192^2, D
   = 256 the backward in panels of 32 MB against one panel;
   `[train-softmax-wide]` `[train-softmax]` with towers (512,
   256), so D = 256 at the loss: 3 eager steps counted (#9, #10, #11 and the
   p kernel once, #1 and #4 twice a step), 3 more each against the host CPU's plain step,
   the K = 16 graph against eager steps as in phase 16, and eager steps of
   the chunked plain route beside the kernels', and the p kernel and #9
   timed on the state 100 steps later; `[train-wide-table]` the flagship
   tables at D = 1,024 (f32 and int8, batch 65,536) and D = 30 (f32,
   8,192), BCE in f32: 3 eager steps counted a case (#1 and #4, or #5 and
   #6, twice a step), 3 more each against the host CPU's plain step (rows
   fed by a sample whose ReLU gate opens on one side only counted and
   exempt from the update's bound), then the D = 1,024 int8 model served
   (#5); `[kernel]` #3-#7 at D = 1,024 and 30 (the span walk's general
   route) and `[pipeline-wide]` (`cli.train --embedding-dim 1024`, one
   epoch on the pipeline's shards); `[train-devsort]` phase
   16's BCE step with f32 tables and no host sort (`sorted_feature=None`),
   `device_sorted_gather=True` beside False from one state: 3 eager steps of
   each (#1 twice a step either way), their states compared (bit for bit,
   else within rtol 1e-5 / atol 1e-6, printed), the K = 16 graph of each,
   the device ms of the route's gather, its sort and its permute beside the
   plain gather's on the 105.6 MB user table and the item table; then an
   int8 user table (#5 on the route): 3 eager steps against False;
26f. bf16 parameters and the native reader: `[kernel]` #3's bf16 mode
   (`buffer_dtype=bf16`, a bf16 table's gradient) at the ranker's 8,192
   slots with the device sort's permutation into bf16 [206,209, 128] and
   [49,688, 128] and on 262,144 rank^-1 item ids: bit for bit its plain
   version, two launches too, its ms beside the f32 mode's;
   `[train-bf16param]` the flagship at `param_dtype="bfloat16"` (bf16
   tables and towers under `OptaxAdam`, bf16 compute, batch 262,144,
   `block_sorted_kernel="off"`): 2 macros of 16 through
   `train_one_epoch_packed` counted (#1, #4, #8 and tower_fwd twice a
   step), the state's addresses kept and Adam's moments moved in place, bit
   for bit 32 eager steps, one step against the host CPU's, the replayed
   ms; `[ranker-bf16]` `[ranker]` with bf16 tables and MLP (2 launches of
   #1 and 2 of #3's bf16 mode a step; the tables after one step bit for bit
   the plain route's on the card, the host CPU's within the CPU tests'
   bars); `[native-reader]` the smoke replica's compressed split through
   the native C++ reader and numpy, bit for bit, their seconds;
27. with --profile, torch.profiler traces of the serving calls, of the
   three train steps and of a graph replay: device busy time, idle share and
   the largest device items, the gather kernel's (#1 or #5) device ms a call
   or a replayed step; and for each graph the SM clock and the active
   throttle reasons (nvidia-smi) before, during and after 20 more replays;
   and the device kernels of one bf16 tower forward: one tower_fwd, no GEMM.

The process must not have imported JAX, the JAX package, pandas or pyarrow.
The card's machine has pandas and pyarrow, but the port's data path runs on
numpy and the standard library by choice; the per-user table (a pandas
DataFrame, as the reference's), the parquet input and the text features run
in child processes.
The line before the last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import csv
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.compact import (
    CompactScheme,
    batch_from_compact,
    compact_from_packed,
    make_compact_train_step,
)
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_eval_step,
    make_packed_train_step,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
from two_tower_recommender_model_tpu_torch.data.prepacked import PrepackedFeaturizer
from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (
    export_feature_embeddings,
    make_retrieval_eval_fn,
)
from two_tower_recommender_model_tpu_torch.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model_tpu_torch.models import concat_mlp
from two_tower_recommender_model_tpu_torch.models.two_tower import forward as two_tower_forward
from two_tower_recommender_model_tpu_torch.models.two_tower import init_params, towers_forward
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    pooled_embeddings as two_tower_pooled,
)
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    block_sorted_aggregate_reference,
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import (
    block_sorted_lookup,
    device_sorted_lookup,
    pooled_lookup,
)
from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk
from two_tower_recommender_model_tpu_torch.ops.probe_sum import (
    probe_block_sums,
    probe_block_sums2,
    probe_block_sums2_reference,
    probe_block_sums_reference,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import (
    QuantizedTable,
    dequantize_table,
    quantize_table,
)
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    SPLIT_STAGES as ADAGRAD_SPLIT_STAGES,
    quantize_rows,
    quantized_pooled_gather,
    quantized_pooled_gather_reference,
    quantized_rowwise_adagrad_fused,
    quantized_rowwise_adagrad_fused_reference,
)
from two_tower_recommender_model_tpu_torch.ops.relu_ties import (
    relu_ties,
    relu_ties_reference,
    tie_mask,
)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import (
    row_subtract,
    row_subtract_reference,
)
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import (
    SPLIT_STAGES as BWD_SPLIT_STAGES,
    tower_backward,
    tower_backward_reference,
)
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import (
    SPLIT_STAGES,
    _mm,
    tower_forward,
    tower_forward_reference,
)
from two_tower_recommender_model_tpu_torch.parallel import launch
from two_tower_recommender_model_tpu_torch.parallel.mesh import make_mesh
from two_tower_recommender_model_tpu_torch.parallel.planner import plan_sharding
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
from two_tower_recommender_model_tpu_torch.parallel.sharded import (
    a2a_cap,
    a2a_owner_rows,
    a2a_pool,
    a2a_responsible,
    a2a_route,
    a2a_send_grads,
    a2a_send_ids,
    alltoall_tables,
    compact_shardings,
    macro_batch_sharding,
    make_sharded_compact_multi_step,
    make_sharded_forward,
    make_sharded_multi_step,
    make_sharded_train_step,
    partial_pool,
    shard_local_ids,
    shard_train_state,
    sorted_partial_rows,
    topk_merge,
    topk_shard_candidates,
    unshard_train_state,
)
from two_tower_recommender_model_tpu_torch.serving import RetrievalService, Scorer
from two_tower_recommender_model_tpu_torch.serving.batch import batch_predict
from two_tower_recommender_model_tpu_torch.serving.scorer import (
    load_scorer,
    load_scorer_from_registry,
)
from two_tower_recommender_model_tpu_torch.serving.server import ModelServer
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib
from two_tower_recommender_model_tpu_torch.train import step as step_lib
from two_tower_recommender_model_tpu_torch.tools import probe_consumer
from two_tower_recommender_model_tpu_torch.train.loop import (
    evaluate,
    train_one_epoch_packed,
    train_val_test,
)
from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch, map_leaves
from two_tower_recommender_model_tpu_torch.train.resilient import resilient_fit
from two_tower_recommender_model_tpu_torch.utils.checkpoint import (
    STATE_FILE,
    Checkpointer,
    export_model,
    load_model,
)
from two_tower_recommender_model_tpu_torch.utils.profiling import (
    StepTimer,
    device_memory_stats,
    profile_trace,
)
from two_tower_recommender_model_tpu_torch.utils.registry import ModelRegistry, register_from_run
from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger

NUM_USERS, NUM_ITEMS, DIM, LAYERS = 206_209, 49_688, 128, (128, 64)
BAGS = 8192
EXPORT_BATCH = 8192  # ids per launch of export_feature_embeddings (its batch_size)
REPS = 50  # timed launches per version
REQ_REPS = 5  # HTTP requests per payload
TRACE_TRIES = 3  # profiler traces per call before an incomplete one fails the run
TRAIN_BATCH = 262_144  # the flagship training batch
TRAIN_STEPS, WARMUP_STEPS, POOL = 10, 2, 4  # counted steps, warm-up steps, distinct batches
GRAPH_K, GRAPH_POOL, GRAPH_MACROS = 16, 6, 5  # steps a graph, distinct batches, timed macros
SOFTMAX_BATCH, SOFTMAX_BIG = 8192, 65_536  # the sampled softmax's production and large batch
BIG_USERS = 20_000_000  # the int8 size class: 2.56e9 int8 elements, past 2^31
HIGH_ROW = 1 << 24  # the 20M-row check looks at a row above this (row x D passes 2^31)
OVERRIDE_STEPS = 3  # steps per update route in [train-override]
# NVIDIA H100 SXM peaks (data sheet, dense): the bounds are computed against these
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# exps: the special-function units' 16 a clock per SM, at the H100 SXM's 1,980 MHz boost clock
EXP_PER_CLOCK_PER_SM, EXP_CLOCK = 16, 1.98e9
class ModeCount:
    """A kernel mode's entry in KERNELS: its wrapper's library, and the
    wrapper's count of that mode's launches (e.g. `block_sorted_aggregate.
    bf16_launches`), read and reset as a wrapper's `launches` is."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    def load(self):
        return self.wrapper.load()

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.wrapper, self.attr, n)


KERNELS = {  # wrapper name -> (wrapper, source, the TPU kernel it replaces)
    "pooled_gather": (pooled_gather, "two_tower_recommender_model_tpu_torch/csrc/pooled_gather.cu",
                      "two_tower_recommender_model_tpu/ops/pallas_embedding.py:40"),
    "rowwise_adagrad": (rowwise_adagrad,
                        "two_tower_recommender_model_tpu_torch/csrc/rowwise_adagrad.cu",
                        "two_tower_recommender_model_tpu/ops/block_sorted.py:212"),
    "tower_bwd": (tower_backward, "two_tower_recommender_model_tpu_torch/csrc/tower_bwd.cu",
                  "two_tower_recommender_model_tpu/ops/tower_bwd.py:59"),
    "softmax_lse_fwd": (sk.softmax_lse_fwd,
                        "two_tower_recommender_model_tpu_torch/csrc/softmax_lse.cu",
                        "two_tower_recommender_model_tpu/ops/softmax_kernel.py:84"),
    "softmax_lse_dq": (sk.softmax_lse_dq,
                       "two_tower_recommender_model_tpu_torch/csrc/softmax_lse.cu",
                       "two_tower_recommender_model_tpu/ops/softmax_kernel.py:111"),
    "softmax_lse_dc": (sk.softmax_lse_dc,
                       "two_tower_recommender_model_tpu_torch/csrc/softmax_lse.cu",
                       "two_tower_recommender_model_tpu/ops/softmax_kernel.py:138"),
    # part of #10 and #11 at a wide D: p of a panel of q rows, which both compute (`_dq_kernel`
    # :111, `_dc_kernel` :138), once, for their products (counted in softmax_lse_dq / _dc)
    "softmax_lse_p": (sk.softmax_lse_p,
                      "two_tower_recommender_model_tpu_torch/csrc/softmax_lse.cu",
                      "two_tower_recommender_model_tpu/ops/softmax_kernel.py:111"),
    "quantized_pooled_gather": (quantized_pooled_gather,
                                "two_tower_recommender_model_tpu_torch/csrc/quantized_gather.cu",
                                "two_tower_recommender_model_tpu/ops/block_sorted.py:460"),
    "quantized_rowwise_adagrad": (quantized_rowwise_adagrad_fused,
                                  "two_tower_recommender_model_tpu_torch/csrc/quantized_adagrad.cu",
                                  "two_tower_recommender_model_tpu/ops/block_sorted.py:576"),
    "block_sorted_aggregate": (block_sorted_aggregate,
                               "two_tower_recommender_model_tpu_torch/csrc/rowwise_adagrad.cu",
                               "two_tower_recommender_model_tpu/ops/block_sorted.py:156"),
    # #3's bf16 mode (a bf16 table's gradient: the ranker at param_dtype="bfloat16"); its
    # launches are also block_sorted_aggregate's
    "block_sorted_aggregate_bf16": (ModeCount(block_sorted_aggregate, "bf16_launches"),
                                    "two_tower_recommender_model_tpu_torch/csrc/rowwise_adagrad.cu",
                                    "two_tower_recommender_model_tpu/ops/block_sorted.py:156"),
    "row_subtract": (row_subtract, "two_tower_recommender_model_tpu_torch/csrc/row_subtract.cu",
                     "two_tower_recommender_model_tpu/ops/pallas_update.py:35"),
    "probe_block_sums": (probe_block_sums,
                         "two_tower_recommender_model_tpu_torch/csrc/probe_sum.cu",
                         "tools/probe_consumer.py:62"),
    "probe_block_sums2": (probe_block_sums2,
                          "two_tower_recommender_model_tpu_torch/csrc/probe_sum.cu",
                          "tools/probe_consumer.py:80"),
    # not a pallas_call: the bias and ReLU of the two-GEMM route of the fused tower's bf16
    # forward (XLA fuses them into the reference's GEMMs), ties decided in k order; off the
    # main path since tower_fwd, checked and timed as that route's
    "relu_ties": (relu_ties, "two_tower_recommender_model_tpu_torch/csrc/relu_ties.cu",
                  "two_tower_recommender_model_tpu/models/mlp.py:89"),
    # not a pallas_call: the fused tower's whole bf16 forward (both GEMMs, biases, ReLUs and
    # relu_ties's tie recompute), the reference's two dots that XLA fuses
    "tower_fwd": (tower_forward, "two_tower_recommender_model_tpu_torch/csrc/tower_fwd.cu",
                  "two_tower_recommender_model_tpu/models/mlp.py:89"),
}
# kernels a BCE bf16 step launches: the f32 tables' and the int8 tables'; tower_fwd for each
# of the two towers
BCE_F32 = {"pooled_gather": 2, "rowwise_adagrad": 2, "tower_bwd": 2, "tower_fwd": 2}
BCE_INT8 = {"quantized_pooled_gather": 2, "quantized_rowwise_adagrad": 2, "tower_bwd": 2,
            "tower_fwd": 2}
SOFTMAX_F32 = {"pooled_gather": 2, "rowwise_adagrad": 2, "softmax_lse_fwd": 1, "softmax_lse_dq": 1,
               "softmax_lse_dc": 1}  # f32 compute: off the tower kernels' gate
SOFTMAX_BF16 = {**SOFTMAX_F32, "tower_bwd": 2, "tower_fwd": 2}
# at a wide D (128 < D): the backward's p kernel once a panel, one panel at the batch of 8,192
SOFTMAX_WIDE_F32 = {**SOFTMAX_F32, "softmax_lse_p": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float, peak_ops: float, n_exp: float = 0) -> dict:
    """The least time the card could take for a call: the largest of its
    bytes (each input read once, each output written once) over the memory
    rate, its operations over the peak rate for their type, and its exps
    (where it takes them) over the special-function units' rate:
    EXP_PER_CLOCK_PER_SM x the card's SMs x EXP_CLOCK."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {"bytes": n_bytes / PEAK_BYTES * 1e3, "operations": n_ops / peak_ops * 1e3,
             "exp": n_exp / (EXP_PER_CLOCK_PER_SM * sms * EXP_CLOCK) * 1e3}
    by = max(times, key=times.get)  # ties go to the first
    return {"bound_ms": times[by], "bound_by": by}


def median_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median device ms over `reps` launches of `fn`, each after an L2 flush (a
    serving lookup meets a cold cache: the user table is twice the 50 MB L2).
    The flush is a read, so no dirty lines are written back during the timed
    launch. A GPU-side sleep queued first keeps the card busy while the host
    enqueues the events and `fn`, so the events bracket the device work alone."""
    fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)  # ~1 ms of spinning at H100 clocks
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


def table_parts(t) -> tuple[torch.Tensor, ...]:
    """The tensors a table is stored in: (values, scales) of an int8 table."""
    return (t.values, t.scales) if isinstance(t, QuantizedTable) else (t.detach(),)


def table_f32(t) -> torch.Tensor:
    """The f32 rows a table stands for."""
    return dequantize_table(t) if isinstance(t, QuantizedTable) else t.detach().float()


def table_bytes(model) -> dict[str, int]:
    return {name: sum(p.numel() * p.element_size() for p in table_parts(t))
            for name, t in model.tables.items()}


def gather_bound(table_row_bytes: int, ids: torch.Tensor, w: torch.Tensor, n: int,
                 out: torch.Tensor, extra_bytes: int = 0) -> dict:
    """The bound of a pooled gather: each distinct live row read once (with
    `extra_bytes` beside it, the int8 scale), each output row written once,
    the ids and weights read; 2 FLOPs an element of a live slot (3 for int8)."""
    live = (ids >= 0) & (ids < n) & (w != 0)
    rows = int(torch.unique(ids[live]).numel())
    slots = int(live.sum())
    n_bytes = (rows * (table_row_bytes + extra_bytes) + out.numel() * out.element_size()
               + ids.numel() * 4 + w.numel() * 4)
    flops = (3 if extra_bytes else 2) * slots * out.shape[1]
    return {**bound(n_bytes, flops, PEAK_F32), "rows": rows}


def plan_note(wrapper, *args) -> str:
    """The launch plan a gather wrapper picks for these tensors, for the log."""
    return f", {wrapper.plan(*args)}"


def host_ms(fn, reps: int = 200) -> float:
    """Median host ms of one call of `fn`, which launches and does not wait
    for the card (a wrapper's checks, allocation, plan and launch)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_kernel(dev: torch.device) -> dict:
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    user_table = torch.empty((NUM_USERS, DIM), device=dev).uniform_(-1, 1, generator=gen)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB > L2

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # one slot, ~10% dead (mask 0 with id 0, as the featurizer emits them)
    live = rng.random((BAGS, 1)) > 0.1
    ids1 = on_card(np.where(live, rng.integers(0, NUM_USERS, (BAGS, 1)), 0).astype(np.int32))
    w1 = on_card(live.astype(np.float32))
    # three slots, mean weights, some slots dead
    live3 = rng.random((BAGS, 3)) > 0.2
    ids3 = on_card(np.where(live3, rng.integers(0, NUM_USERS, (BAGS, 3)), 0).astype(np.int32))
    w3 = live3.astype(np.float32)
    w3 = on_card(w3 / np.maximum(w3.sum(1, keepdims=True), 1.0))
    # sentinels: a quarter of the ids at or past N
    sent = rng.random((BAGS, 1)) < 0.25
    ids_s = on_card(np.where(sent, NUM_USERS + rng.integers(0, 1000, (BAGS, 1)),
                             rng.integers(0, NUM_USERS, (BAGS, 1))).astype(np.int32))
    ones = torch.ones((BAGS, 1), device=dev)
    bf16_table = user_table.to(torch.bfloat16)
    item_table = user_table[:NUM_ITEMS].contiguous()
    item_ids = on_card(rng.integers(0, NUM_ITEMS, (BAGS, 1)).astype(np.int32))

    cases = [
        # name, args, exact?
        ("user f32 L=1", (user_table, ids1, w1, torch.float32), True),
        ("user f32 L=3 mean", (user_table, ids3, w3, torch.float32), False),
        ("user f32 sentinels", (user_table, ids_s, ones, torch.float32), True),
        ("user bf16->bf16 L=1", (bf16_table, ids1, w1, torch.bfloat16), True),
        ("item f32 export", (item_table, item_ids, ones, torch.float32), True),
    ]
    # the serving calls' other sizes (/invocations of 1 and 100 rows, /retrieve of 16 and
    # 1,000 users) and the BCE train step's two calls (262,144 bags, bf16 out: the user
    # table with the batch sorted by user id, the item table): a draw of their own
    srng = np.random.default_rng(10)
    for b in (1, 16, 100, 1000):
        live_b = srng.random((b, 1)) > 0.1
        cases.append((f"user f32 L=1 B={b}", (
            user_table, on_card(np.where(live_b, srng.integers(0, NUM_USERS, (b, 1)), 0)
                                .astype(np.int32)), on_card(live_b.astype(np.float32)),
            torch.float32), True))
    train_ones = torch.ones((TRAIN_BATCH, 1), device=dev)
    cases += [
        ("user f32->bf16 sorted (the train step's)", (user_table, on_card(np.sort(
            srng.integers(0, NUM_USERS, (TRAIN_BATCH, 1)), axis=0).astype(np.int32)),
            train_ones, torch.bfloat16), True),
        ("item f32->bf16 (the train step's)", (item_table, on_card(srng.integers(
            0, NUM_ITEMS, (TRAIN_BATCH, 1)).astype(np.int32)), train_ones, torch.bfloat16), True),
    ]
    # the bf16-table BCE step's two calls (the bf16 tables into bf16, the same ids) and
    # the softmax step's two (8,192 bags from the f32 tables into bf16, the user batch
    # sorted as the step sorts it)
    user_train_ids, item_train_ids = cases[-2][1][1], cases[-1][1][1]
    cases += [
        ("user bf16->bf16 sorted (the bf16-table train step's)",
         (bf16_table, user_train_ids, train_ones, torch.bfloat16), True),
        ("item bf16->bf16 (the bf16-table train step's)",
         (item_table.to(torch.bfloat16), item_train_ids, train_ones, torch.bfloat16), True),
        ("user f32->bf16 sorted (the softmax step's)", (user_table, on_card(np.sort(
            srng.integers(0, NUM_USERS, (BAGS, 1)), axis=0).astype(np.int32)), ones,
            torch.bfloat16), True),
        ("item f32->bf16 (the softmax step's)", (item_table, on_card(srng.integers(
            0, NUM_ITEMS, (BAGS, 1)).astype(np.int32)), ones, torch.bfloat16), True),
    ]
    # the lookup's mode under bf16 compute on an f32 table (`round_rows`: each row rounded
    # to bf16, the bag summed in slot order, rounded once), the mask as the weights: bags of
    # 4 and 16 slots, ~30% dead, and the BCE step's item call (one slot, as the step makes it)
    for bag_l in (4, 16):
        live_l = srng.random((BAGS, bag_l)) > 0.3
        cases.append((f"user f32->bf16 L={bag_l} round_rows (a bag under bf16 compute)", (
            user_table, on_card(np.where(live_l, srng.integers(0, NUM_USERS, (BAGS, bag_l)), 0)
                                .astype(np.int32)), on_card(live_l.astype(np.float32)),
            torch.bfloat16, True), True))
    cases.append(("item f32->bf16 round_rows (the train step's)",
                  (item_table, item_train_ids, train_ones, torch.bfloat16, True), True))
    results = {}
    for name, (table, ids, w, out_dtype, *mode), exact in cases:
        round_rows = bool(mode and mode[0])
        got = pooled_gather(table, ids, w, out_dtype, round_rows=round_rows)
        want = pooled_gather_reference(table, ids, w, out_dtype, round_rows=round_rows)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if exact:
            if not bitwise_equal(got, want):
                raise AssertionError(f"{name}: kernel != plain version (max abs diff {err})")
        elif err > 1e-5 * want.float().abs().max().item():  # summation order differs
            raise AssertionError(f"{name}: max abs diff {err} > 1e-5 x max |plain|")
        if name == "user f32 sentinels":
            zero_rows = got[ids_s[:, 0] >= NUM_USERS]
            if zero_rows.numel() == 0 or torch.count_nonzero(zero_rows).item() != 0:
                raise AssertionError("sentinel ids must give exact zero rows")
        ms = median_ms(lambda: pooled_gather(table, ids, w, out_dtype, round_rows=round_rows),
                       flush)
        plain_ms = median_ms(lambda: pooled_gather_reference(table, ids, w, out_dtype,
                                                             round_rows=round_rows), flush)
        b = gather_bound(table.shape[1] * table.element_size(), ids, w, table.shape[0], got)
        log(f"[kernel] {name}: [{ids.shape[0]}, {ids.shape[1]}] from [{table.shape[0]}, "
            f"{table.shape[1]}] {table.dtype} -> {out_dtype} "
            f"{'bitwise equal' if exact else 'within 1e-5 x max|plain|'}, max_abs_err={err!r}, "
            f"kernel_ms={ms!r}, plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by "
            f"{b['bound_by']} ({b['rows']} distinct live rows)"
            f"{plan_note(pooled_gather, table, ids, got, round_rows)}")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
    # the main case (one slot, the serving lookup): the one PyTorch call that computes
    # the same function, timed here and used nowhere in the port
    ids64, offsets = ids1[:, 0].long(), torch.arange(BAGS, device=dev)
    w_flat = w1[:, 0].contiguous()

    def library():
        return torch.nn.functional.embedding_bag(ids64, user_table, offsets, mode="sum",
                                                 per_sample_weights=w_flat)

    torch.testing.assert_close(library(), pooled_gather_reference(user_table, ids1, w1,
                                                                  torch.float32))
    library_ms = median_ms(library, flush)
    # and at the BCE step's user call (262,144 sorted bags; the library's output is f32)
    step_ids, step_offsets = user_train_ids[:, 0].long(), torch.arange(TRAIN_BATCH, device=dev)

    def library_step():
        return torch.nn.functional.embedding_bag(step_ids, user_table, step_offsets, mode="sum",
                                                 per_sample_weights=train_ones[:, 0])

    torch.testing.assert_close(library_step(), pooled_gather_reference(
        user_table, user_train_ids, train_ones, torch.float32))
    library_step_ms = median_ms(library_step, flush)
    main, floor = results["user f32 L=1"], results["user f32 L=1 B=1"]
    host = {b: host_ms(lambda: pooled_gather(user_table, ids, w, torch.float32))
            for b, ids, w in ((BAGS, ids1, w1), (1, ids1[:1], w1[:1]))}
    out = torch.empty((BAGS, DIM), device=dev)
    plan_ms = host_ms(lambda: pooled_gather.plan(user_table, ids1, out))
    rounded, plain_mode = (results[f"item f32->bf16{m} (the train step's)"]
                           for m in (" round_rows", ""))
    log(f"[kernel] pooled_gather round_rows at the BCE step's item call: kernel_ms="
        f"{rounded['ms']!r} against the mode off on the same inputs {plain_mode['ms']!r} "
        f"(ratio {rounded['ms'] / plain_mode['ms']!r})")
    step = results["user f32->bf16 sorted (the train step's)"]
    log(f"[kernel] pooled_gather at the BCE step's {TRAIN_BATCH} sorted user bags: kernel_ms="
        f"{step['ms']!r} (into bf16), library_ms={library_step_ms!r} (F.embedding_bag, sum, "
        f"per-sample weights, into f32)")
    log(f"[kernel] pooled_gather user f32 L=1: library_ms={library_ms!r} (F.embedding_bag); "
        f"latency floor (1 bag) {floor['ms']!r} ms; {BAGS} bags {main['ms']!r} ms, "
        f"{main['ms'] - floor['ms']!r} above the floor against a bound of {main['bound_ms']!r}; "
        f"host ms a call (checks, plan, launch): {BAGS} bags {host[BAGS]!r}, 1 bag {host[1]!r}; "
        f"of it the plan alone {plan_ms!r}")
    return {"max_abs_err": max(r["max_abs_err"] for r in results.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": library_ms,
            "ms_bce_step_call": step["ms"], "library_ms_bce_step_call": library_step_ms}


LR, EPS = 0.05, 1e-10  # row-wise Adagrad's learning rate and epsilon in the kernel phase


def within_rel(got: torch.Tensor, want: torch.Tensor, rel: float, label: str) -> float:
    """Fail unless |got - want| <= rel x max|want| everywhere; the max abs
    difference."""
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item()
    if err > bound:
        raise AssertionError(f"{label}: max abs diff {err!r} > {rel!r} x max|plain| = {bound!r}")
    return err


def phase_adagrad_kernel(dev: torch.device) -> dict:
    """Kernel #4 against its plain version at the train steps' shapes: the
    BCE step's 262,144 ids (the user table's sorted ids with f32 and bf16
    gradients, the item table's device sort with bf16 gradients read through
    the sort's permutation) and the softmax step's 8,192 (the same two
    tables, f32 gradients as its f32-compute step and bf16 as its
    bf16-compute step, and rank^-1 item ids), where the span walk deals each
    span to several warps. Untouched rows must keep their bits, the rest
    agree within rtol 1e-5 (f32 summation order), and two launches on the
    same inputs must be bit for bit equal."""
    rng = np.random.default_rng(2)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    results = {}
    for name, n, m, order, grad_dtype in (
            ("user f32 sorted", NUM_USERS, TRAIN_BATCH, "sorted", torch.float32),
            ("user bf16 sorted", NUM_USERS, TRAIN_BATCH, "sorted", torch.bfloat16),
            ("item bf16 device-sorted", NUM_ITEMS, TRAIN_BATCH, "device", torch.bfloat16),
            ("user f32 sorted", NUM_USERS, SOFTMAX_BATCH, "sorted", torch.float32),
            ("user bf16 sorted", NUM_USERS, SOFTMAX_BATCH, "sorted", torch.bfloat16),
            ("item f32 device-sorted", NUM_ITEMS, SOFTMAX_BATCH, "device", torch.float32),
            ("item bf16 device-sorted", NUM_ITEMS, SOFTMAX_BATCH, "device", torch.bfloat16),
            ("item f32 device-sorted, ids drawn as rank^-1", NUM_ITEMS, SOFTMAX_BATCH, "skewed",
             torch.float32)):
        perm = None
        if order == "skewed":
            ids_t, perm = skewed_item_ids(rng, m, dev)
        else:
            ids = rng.integers(0, n, m)
            ids[rng.random(m) < 0.05] = n  # dead slots carry the sentinel N
            ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
            if order == "sorted":
                ids_t = torch.sort(ids_t).values
            else:
                ids_t, perm = torch.sort(ids_t, stable=True)
                perm = perm.to(torch.int32)
        grads = torch.from_numpy(rng.normal(size=(m, DIM)).astype(np.float32)).to(dev, grad_dtype)
        table = torch.from_numpy(rng.normal(size=(n, DIM)).astype(np.float32)).to(dev)
        acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
        t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
        t_2, a_2 = table.clone(), acc.clone()
        rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS, perm=perm)
        rowwise_adagrad(t_2, a_2, ids_t, grads, LR, EPS, perm=perm)
        rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS, perm=perm)
        torch.cuda.synchronize()
        label = f"rowwise_adagrad {name}, {m} ids"
        if not (bitwise_equal(t_k, t_2) and bitwise_equal(a_k, a_2)):
            raise AssertionError(f"{label}: two launches on the same inputs differ")
        del t_2, a_2
        live = torch.zeros(n, dtype=torch.bool, device=dev)
        live[ids_t[ids_t < n].long()] = True
        if not (bitwise_equal(t_k[~live], table[~live]) and bitwise_equal(a_k[~live], acc[~live])):
            raise AssertionError(f"{label}: rows no live id names changed")
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
        err = max((t_k - t_p).abs().max().item(), (a_k - a_p).abs().max().item())
        ms = median_ms(lambda: rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS, perm=perm), flush)
        plain_ms = median_ms(
            lambda: rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS, perm=perm), flush)
        touched = int(live.sum())
        # grads, ids (and the permutation) read once, each touched row and accumulator read and
        # written
        b = bound(m * DIM * grads.element_size() + m * (4 if perm is None else 8)
                  + touched * (DIM + 1) * 4 * 2, 4 * m * DIM, PEAK_F32)
        log(f"[kernel] {label} into f32 [{n}, {DIM}], {touched} rows touched, longest run "
            f"{longest_run(ids_t, n)}; untouched rows bitwise, the rest within rtol 1e-5, two "
            f"launches bit for bit equal; max_abs_err={err!r}, kernel_ms={ms!r}, "
            f"plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by {b['bound_by']}")
        results[(name, m)] = (err, ms, plain_ms, b)
    main = ("user bf16 sorted", TRAIN_BATCH)  # the flagship step's sorted update
    err, ms, plain_ms, b = results[main]
    log(f"[kernel] rowwise_adagrad {main[0]}, {main[1]} ids: bound_ms={b['bound_ms']!r} by "
        f"{b['bound_by']}; no single PyTorch call computes it")
    return {"max_abs_err": max(r[0] for r in results.values()), "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None}


def phase_adagrad_bf16_table(dev: torch.device) -> None:
    """Kernel #4 on the user table stored in bf16, at the bf16-table train
    step's shapes: 262,144 sorted ids, f32 gradients (the only gradients a
    bf16 table gets). Untouched rows keep their bits; a touched row equals
    the plain version's or lies one bf16 ulp from it (the f32 sums run in
    different orders before the one rounding; atol 1e-6 where a result cancels
    to nearly zero); accumulators within rtol 1e-5.
    The same gradients into an f32 copy of the table are timed beside it."""
    rng = np.random.default_rng(9)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    m, n = TRAIN_BATCH, NUM_USERS
    ids = rng.integers(0, n, m)
    ids[rng.random(m) < 0.05] = n
    ids_t = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev)).values
    grads = torch.from_numpy(rng.normal(size=(m, DIM)).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, DIM)).astype(np.float32)).to(dev, torch.bfloat16)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS)
    rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS)
    torch.cuda.synchronize()
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids_t[ids_t < n].long()] = True
    if not (bitwise_equal(t_k[~live], table[~live]) and bitwise_equal(a_k[~live], acc[~live])):
        raise AssertionError("rowwise_adagrad bf16 table: rows no live id names changed")
    got, want = t_k[live].float(), t_p[live].float()
    if bitwise_equal(t_k[live], table[live]):
        raise AssertionError("rowwise_adagrad bf16 table: touched rows did not change")
    err = (got - want).abs()
    # one bf16 ulp of x is at most 2^-7 |x|; where row and update cancel to nearly zero the two
    # f32 results differ by summation-order noise alone: the f32 tables' atol, 1e-6
    bad = err > 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6
    if bad.any():
        raise AssertionError(f"rowwise_adagrad bf16 table: {int(bad.sum())} values more than one "
                             f"bf16 ulp from the plain version (largest {err[bad].max().item()!r})")
    differ = (got != want).float().mean().item()
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    t32, a32 = table.float(), acc.clone()
    ms = median_ms(lambda: rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS), flush)
    plain_ms = median_ms(lambda: rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS), flush)
    f32_ms = median_ms(lambda: rowwise_adagrad(t32, a32, ids_t, grads, LR, EPS), flush)
    touched = int(live.sum())
    # grads and ids read once, each touched bf16 row and f32 accumulator read and written
    b = bound(m * DIM * 4 + m * 4 + touched * (DIM * 2 + 4) * 2, 4 * m * DIM, PEAK_F32)
    log(f"[kernel] rowwise_adagrad bf16 table, f32 gradients: {m} sorted ids into bf16 [{n}, "
        f"{DIM}], {touched} rows touched; untouched rows bitwise, touched rows equal or one bf16 "
        f"ulp apart (share_of_touched_values_that_differ={differ!r}, max_abs_err="
        f"{err.max().item()!r}), accumulators within rtol 1e-5; kernel_ms={ms!r}, "
        f"plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by {b['bound_by']}; the same gradients "
        f"into the f32 table: kernel_ms={f32_ms!r}; no single PyTorch call computes it")


def phase_probe_kernels(dev: torch.device) -> dict[str, dict]:
    """Kernels #12 and #13 against their plain versions at the probe's
    shapes: every block's sum within 1e-5 x the block's sum of magnitudes
    (f32 summation order), two launches bit for bit equal (a fixed order, no
    atomics). The library yardstick is `x.sum()` (`a.sum() + b.sum()`): one
    call over the same bytes, used nowhere in the port."""
    rng = np.random.default_rng(12)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    m = probe_consumer.M
    stats = {}

    def draw(d, dtype):
        return torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, dtype)

    def case(name, kernel, plain, library, operands):
        got, again, want = kernel(*operands), kernel(*operands), plain(*operands)
        torch.cuda.synchronize()
        if not bitwise_equal(got, again):
            raise AssertionError(f"{name}: two launches disagree")
        tol = 1e-5 * sum(probe_block_sums_reference(x.abs()) for x in operands)
        err = (got - want).abs()
        if got.shape != (m // 512,) or (err > tol).any():
            raise AssertionError(f"{name}: max abs diff {err.max().item()!r} > 1e-5 x sum|x| of "
                                 "the block")
        ms = median_ms(lambda: kernel(*operands), flush)
        plain_ms = median_ms(lambda: plain(*operands), flush)
        library_ms = median_ms(library, flush)
        x = operands[0]
        n_bytes = len(operands) * (m // 512 * 512) * x.shape[1] * x.element_size() + m // 512 * 4
        b = bound(n_bytes, len(operands) * m * x.shape[1], PEAK_F32)
        log(f"[kernel] {name}: {len(operands)} x [{m}, {x.shape[1]}] {x.dtype} -> f32 "
            f"[{m // 512}], each block within 1e-5 x its sum|x|, two launches bitwise equal; "
            f"max_abs_err={err.max().item()!r}, kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
            f"bound_ms={b['bound_ms']!r} by {b['bound_by']} ({n_bytes} bytes), "
            f"library_ms={library_ms!r} (the whole-array sum)")
        return {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms, **b,
                "library_ms": library_ms}

    x = draw(128, torch.float32)
    stats["probe_block_sums"] = case("probe_block_sums", probe_block_sums,
                                     probe_block_sums_reference, lambda: x.sum(), (x,))
    x16 = x.to(torch.bfloat16)
    bf16 = case("probe_block_sums bf16", probe_block_sums, probe_block_sums_reference,
                lambda: x16.sum(dtype=torch.float32), (x16,))
    stats["probe_block_sums"]["max_abs_err"] = max(stats["probe_block_sums"]["max_abs_err"],
                                                   bf16["max_abs_err"])
    del x, x16
    a, b_ = draw(64, torch.float32), draw(64, torch.float32)
    stats["probe_block_sums2"] = case("probe_block_sums2", probe_block_sums2,
                                      probe_block_sums2_reference, lambda: a.sum() + b_.sum(),
                                      (a, b_))
    return stats


def phase_probe(dev: torch.device) -> dict[str, int]:
    """The gather probe at its full shapes, through the tool's entry point;
    its runs are the main path of kernels #12 and #13."""
    reset_launches()
    records = probe_consumer.run(device=dev, emit=lambda line: log(f"[probe] {line}"))
    launches = read_launches()
    if [r["case"] for r in records] != list(probe_consumer.CASES):
        raise AssertionError(f"[probe] cases {[r['case'] for r in records]}")
    if not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in records):
        raise AssertionError(f"[probe] bad times: {records}")
    per_case = probe_consumer.K + 1  # a warm-up call and K timed ones
    want = {"probe_block_sums": 3 * per_case, "probe_block_sums2": per_case,
            "pooled_gather": 2 * per_case}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"[probe] launches {launches}, expected {want}")
    by = {r["case"]: r["ms"] for r in records}
    log(f"[probe] M={probe_consumer.M} N={probe_consumer.N}, median of {probe_consumer.K} "
        f"launches each after an L2 flush; sorted ids against ids as drawn through the pooled "
        f"gather: k1_sorted / k1_unsorted = {by['k1_sorted'] / by['k1_unsorted']!r}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


SKEWED = "item bf16 device-sorted, ids drawn as rank^-1"


def skewed_item_ids(rng, m: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`m` item ids drawn with probability proportional to rank^-1 over the
    flagship's items, the ranks given to the ids at random (as
    `SyntheticClickstream(popularity=1.0)` gives them), 5% dead slots with
    the sentinel N; sorted on the card with the permutation, as the train
    step's device sort hands them to the update."""
    w = 1.0 / np.arange(1, NUM_ITEMS + 1)
    ids = rng.permutation(NUM_ITEMS)[rng.choice(NUM_ITEMS, size=m, p=w / w.sum())]
    ids[rng.random(m) < 0.05] = NUM_ITEMS
    ids_t, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev), stable=True)
    return ids_t, perm.to(torch.int32)


def longest_run(sorted_ids: torch.Tensor, n: int) -> int:
    """The most positions one live id holds."""
    live = sorted_ids[sorted_ids < n]
    return int(torch.unique_consecutive(live, return_counts=True)[1].max().item())


def skewed_rowwise_adagrad(dev, ids_t, perm, grads, flush) -> float:
    """Kernel #4 on the skewed ids against an f32 item table: untouched rows
    bitwise, the rest within rtol 1e-5, two launches bit for bit equal (the
    hot ids' pieces are added in one order). Returns the max abs error."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(size=(NUM_ITEMS, DIM)).astype(np.float32)).to(dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=NUM_ITEMS)).astype(np.float32)).to(dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    t_2, a_2 = table.clone(), acc.clone()
    rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS, perm=perm)
    rowwise_adagrad(t_2, a_2, ids_t, grads, LR, EPS, perm=perm)
    rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS, perm=perm)
    torch.cuda.synchronize()
    if not (bitwise_equal(t_k, t_2) and bitwise_equal(a_k, a_2)):
        raise AssertionError("rowwise_adagrad skewed: two launches on the same inputs differ")
    del t_2, a_2
    live = torch.zeros(NUM_ITEMS, dtype=torch.bool, device=dev)
    live[ids_t[ids_t < NUM_ITEMS].long()] = True
    if not (bitwise_equal(t_k[~live], table[~live]) and bitwise_equal(a_k[~live], acc[~live])):
        raise AssertionError("rowwise_adagrad skewed: rows no live id names changed")
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    err = max((t_k - t_p).abs().max().item(), (a_k - a_p).abs().max().item())
    ms = median_ms(lambda: rowwise_adagrad(t_k, a_k, ids_t, grads, LR, EPS, perm=perm), flush)
    plain_ms = median_ms(
        lambda: rowwise_adagrad_reference(t_p, a_p, ids_t, grads, LR, EPS, perm=perm), flush)
    m, touched = ids_t.shape[0], int(live.sum())
    # grads, ids and the permutation read once, each touched row and accumulator read and written
    b = bound(m * DIM * grads.element_size() + m * 8 + touched * (DIM + 1) * 4 * 2, 4 * m * DIM,
              PEAK_F32)
    log(f"[kernel] rowwise_adagrad {SKEWED}: {m} ids into f32 [{NUM_ITEMS}, {DIM}], {touched} "
        f"rows touched, longest run {longest_run(ids_t, NUM_ITEMS)}; untouched rows bitwise, the "
        f"rest within rtol 1e-5, two launches bit for bit equal; max_abs_err={err!r}, "
        f"kernel_ms={ms!r}, plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by "
        f"{b['bound_by']}; no single PyTorch call computes it")
    return err


def skewed_aggregate(dev, ids_t, perm, grads, flush) -> float:
    """Kernel #3 on the skewed ids, their gradients in sorted order (as the
    aggregate takes them): rows without ids exact zero, two launches bit for
    bit equal, and each element within 1e-5 x the sum of the magnitudes added
    into it of an f64 sum of the same terms and of the plain version's. That
    is the f32 summation order's bound: the plain version adds a hot id's
    21,842 terms in the order its atomics land, and an element of such a row
    that cancels to a few units differs between two of its own launches by
    more than 1e-5 of itself; the f64 sum is the fixed yardstick. Each
    version's distance from it is printed. Returns the max abs error against
    the plain version."""
    sg = grads[perm.long()]
    got = block_sorted_aggregate(NUM_ITEMS, ids_t, sg)
    again = block_sorted_aggregate(NUM_ITEMS, ids_t, sg)
    want = block_sorted_aggregate_reference(NUM_ITEMS, ids_t, sg)
    torch.cuda.synchronize()
    if not bitwise_equal(got, again):
        raise AssertionError("block_sorted_aggregate skewed: two launches on the same inputs "
                             "differ")
    del again
    live_ids = ids_t < NUM_ITEMS
    ids64, grads32 = ids_t[live_ids].long(), sg[live_ids].float()
    named = torch.zeros(NUM_ITEMS, dtype=torch.bool, device=dev)
    named[ids64] = True
    if torch.count_nonzero(got[~named]).item() != 0:
        raise AssertionError("block_sorted_aggregate skewed: a row without ids is not exact zero")
    magnitude = torch.zeros((NUM_ITEMS, DIM), device=dev).index_add_(0, ids64, grads32.abs())
    exact = torch.zeros((NUM_ITEMS, DIM), dtype=torch.float64, device=dev).index_add_(
        0, ids64, grads32.double())
    for other, what in ((exact, "an f64 sum"), (want, "the plain version")):
        over = ((got.double() - other).abs() - 1e-5 * magnitude.double()).max().item()
        if over > 0:
            raise AssertionError(f"block_sorted_aggregate skewed: an element differs from {what} "
                                 f"by {over!r} more than 1e-5 x its sum of magnitudes")
    err = (got - want).abs().max().item()
    off_exact = {"kernel": (got.double() - exact).abs().max().item(),
                 "plain": (want.double() - exact).abs().max().item()}
    del exact

    def aggregate_library():  # on ids and gradients prepared for it (int64, f32, live only)
        return torch.zeros((NUM_ITEMS, DIM), device=dev).index_add_(0, ids64, grads32)

    ms = median_ms(lambda: block_sorted_aggregate(NUM_ITEMS, ids_t, sg), flush)
    plain_ms = median_ms(lambda: block_sorted_aggregate_reference(NUM_ITEMS, ids_t, sg), flush)
    library_ms = median_ms(aggregate_library, flush)
    m = ids_t.shape[0]
    b = bound(m * DIM * sg.element_size() + m * 4 + NUM_ITEMS * DIM * 4, m * DIM, PEAK_F32)
    log(f"[kernel] block_sorted_aggregate {SKEWED}: {m} ids into f32 [{NUM_ITEMS}, {DIM}] "
        f"(zeroed by the wrapper, timed with it), {int(named.sum())} rows named, longest run "
        f"{longest_run(ids_t, NUM_ITEMS)}; rows without ids exact zero, each element within "
        f"1e-5 x its sum of magnitudes of an f64 sum and of the plain version, two launches bit "
        f"for bit equal; max_abs_err={err!r}, "
        f"max abs diff from an f64 sum "
        f"{off_exact!r}; kernel_ms={ms!r}, plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by "
        f"{b['bound_by']}, library_ms={library_ms!r} (zeros.index_add_ on int64 ids and f32 "
        "gradients)")
    return err


def phase_int8_kernels(dev: torch.device) -> dict[str, dict]:
    """Kernels #5, #6, #3 and #7 against their plain versions at the int8
    train step's shapes (and #5 at the serving lookup's); #6, #4 and #3 also
    on item ids drawn as rank^-1."""
    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    stats: dict[str, dict] = {}

    def on_card(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    # --- #5: the int8 pooled gather on the flagship user table -------------------
    user = quantize_table(torch.empty((NUM_USERS, DIM), device=dev).uniform_(-1, 1, generator=gen))
    values, scales = user.values, user.scales

    def gather_case(name, b, slots, out_dtype, sentinels=False, draw=rng):
        live = draw.random((b, slots)) > (0.1 if slots == 1 else 0.2)
        ids = np.where(live, draw.integers(0, NUM_USERS, (b, slots)), 0)
        w = live.astype(np.float32)
        if slots > 1:  # mean pooling comes pre-scaled
            w = w / np.maximum(w.sum(1, keepdims=True), 1.0)
        if sentinels:  # a quarter of the ids at or past N, every weight 1
            sent = draw.random((b, 1)) < 0.25
            ids = np.where(sent, NUM_USERS + draw.integers(0, 1000, (b, 1)), ids)
            w = np.ones((b, 1), np.float32)
        ids, w = on_card(ids.astype(np.int32)), on_card(w)
        got = quantized_pooled_gather(values, scales, ids, w, out_dtype)
        want = quantized_pooled_gather_reference(values, scales, ids, w, out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if slots == 1:
            if not bitwise_equal(got, want):
                raise AssertionError(f"{name}: kernel != plain version (max abs diff {err})")
        else:
            within_rel(got, want, 1e-5, name)  # f32 summation order
        if sentinels:
            zero_rows = got[ids[:, 0] >= NUM_USERS]
            if zero_rows.numel() == 0 or torch.count_nonzero(zero_rows).item() != 0:
                raise AssertionError("sentinel ids must give exact zero rows")
        ms = median_ms(lambda: quantized_pooled_gather(values, scales, ids, w, out_dtype), flush)
        plain_ms = median_ms(
            lambda: quantized_pooled_gather_reference(values, scales, ids, w, out_dtype), flush)
        # a distinct live row is read once with its scale, a bag writes its row
        b_ = gather_bound(DIM, ids, w, NUM_USERS, got, extra_bytes=4)
        log(f"[kernel] quantized_pooled_gather {name}: [{b}, {slots}] from int8 [{NUM_USERS}, "
            f"{DIM}] {'bitwise equal' if slots == 1 else 'within 1e-5 x max|plain|'}, "
            f"max_abs_err={err!r}, kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
            f"bound_ms={b_['bound_ms']!r} by {b_['bound_by']} ({b_['rows']} distinct live rows)"
            f"{plan_note(quantized_pooled_gather, values, ids, got)}; no single PyTorch call "
            "computes it")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_["bound_ms"],
                "bound_by": b_["bound_by"], "library_ms": None}

    cases = [gather_case("f32 out L=1", BAGS, 1, torch.float32),
             gather_case("bf16 out L=1 (the train step's)", TRAIN_BATCH, 1, torch.bfloat16),
             gather_case("f32 out L=3 mean", BAGS, 3, torch.float32),
             gather_case("f32 out sentinels", BAGS, 1, torch.float32, sentinels=True)]
    # /invocations of 1 and 100 rows: a draw of their own
    srng = np.random.default_rng(14)
    floor = gather_case("f32 out L=1 B=1", 1, 1, torch.float32, draw=srng)
    cases += [floor, gather_case("f32 out L=1 B=100", 100, 1, torch.float32, draw=srng)]
    host = {}
    for b in (BAGS, 1):  # the ids' values do not change the host's work
        ids_h = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        w_h = torch.ones((b, 1), device=dev)
        host[b] = host_ms(
            lambda: quantized_pooled_gather(values, scales, ids_h, w_h, torch.float32))
    log(f"[kernel] quantized_pooled_gather latency floor (1 bag) {floor['ms']!r} ms; {BAGS} bags "
        f"{cases[0]['ms']!r} ms, {cases[0]['ms'] - floor['ms']!r} above the floor against a "
        f"bound of {cases[0]['bound_ms']!r}; host ms a call (checks, plan, launch): {BAGS} bags "
        f"{host[BAGS]!r}, 1 bag {host[1]!r}")
    stats["quantized_pooled_gather"] = {**cases[1],
                                        "max_abs_err": max(c["max_abs_err"] for c in cases)}

    # --- #6: the fused int8 row-wise Adagrad --------------------------------------
    m = TRAIN_BATCH
    user_sorted = None  # the user table's sorted ids and bf16 gradients, reused by #3 and #7
    results = []
    for name, n, sort, grad_dtype in (("user f32 sorted", NUM_USERS, True, torch.float32),
                                      ("user bf16 sorted", NUM_USERS, True, torch.bfloat16),
                                      ("item bf16 device-sorted", NUM_ITEMS, False, torch.bfloat16),
                                      (SKEWED, NUM_ITEMS, False, torch.bfloat16)):
        if name == SKEWED:  # its own draws: the cases after it see the same numbers as before
            ids, perm = skewed_item_ids(np.random.default_rng(7), m, dev)
            ids_t = ids
            grads = on_card(np.random.default_rng(8).normal(size=(m, DIM)).astype(np.float32),
                            grad_dtype)
        else:
            ids = rng.integers(0, n, m)
            ids[rng.random(m) < 0.05] = n  # dead slots carry the sentinel N
            ids_t = on_card(ids.astype(np.int32))
            perm = None
            if sort:
                ids_t = torch.sort(ids_t).values
            else:
                ids_t, perm = torch.sort(ids_t, stable=True)
                perm = perm.to(torch.int32)
            grads = on_card(rng.normal(size=(m, DIM)).astype(np.float32), grad_dtype)
        table = quantize_table(on_card(rng.normal(size=(n, DIM)).astype(np.float32)))
        acc = on_card(np.abs(rng.normal(size=n)).astype(np.float32))
        kern = (table.values.clone(), table.scales.clone(), acc.clone())
        plain = (table.values.clone(), table.scales.clone(), acc.clone())
        again = (table.values.clone(), table.scales.clone(), acc.clone())
        quantized_rowwise_adagrad_fused(*kern, ids_t, grads, LR, EPS, perm=perm)
        quantized_rowwise_adagrad_fused(*again, ids_t, grads, LR, EPS, perm=perm)
        quantized_rowwise_adagrad_fused_reference(*plain, ids_t, grads, LR, EPS, perm=perm)
        torch.cuda.synchronize()
        if not all(bitwise_equal(a, b) for a, b in zip(kern, again)):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        del again
        live = torch.zeros(n, dtype=torch.bool, device=dev)
        live[ids_t[ids_t < n].long()] = True
        for got, start, what in zip(kern, (table.values, table.scales, acc),
                                    ("values", "scales", "accumulators")):
            if not bitwise_equal(got[~live], start[~live]):
                raise AssertionError(f"{name}: {what} of rows no live id names changed")
        torch.testing.assert_close(kern[1], plain[1], rtol=1e-5, atol=1e-6)  # f32 sum order
        torch.testing.assert_close(kern[2], plain[2], rtol=1e-5, atol=1e-6)
        # the order of the sum may move a value across a rounding boundary: one step
        steps = (kern[0].int() - plain[0].int()).abs()
        if steps.max().item() > 1:
            raise AssertionError(f"{name}: int8 values differ by {steps.max().item()} steps")
        differ = (steps != 0).sum().item() / max(int(live.sum()) * DIM, 1)
        err = max((kern[1] - plain[1]).abs().max().item(), (kern[2] - plain[2]).abs().max().item())
        ms = median_ms(lambda: quantized_rowwise_adagrad_fused(*kern, ids_t, grads, LR, EPS,
                                                               perm=perm), flush)
        plain_ms = median_ms(lambda: quantized_rowwise_adagrad_fused_reference(
            *plain, ids_t, grads, LR, EPS, perm=perm), flush)
        touched = int(live.sum())
        # grads and ids (and the permutation) read once; each touched row's int8 values, scale
        # and accumulator read and written
        b_ = bound(m * DIM * grads.element_size() + m * 4 * (1 if perm is None else 2)
                   + touched * (DIM + 8) * 2, 4 * m * DIM + 8 * touched * DIM, PEAK_F32)
        log(f"[kernel] quantized_rowwise_adagrad {name}: {m} ids into int8 [{n}, {DIM}], "
            f"{touched} rows touched, longest run {longest_run(ids_t, n)}; untouched rows "
            f"bitwise, scales and accumulators within rtol 1e-5 (max_abs_err={err!r}), int8 "
            f"values within one step (share_of_touched_values_that_differ={differ!r}), two "
            f"launches bit for bit equal; kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
            f"bound_ms={b_['bound_ms']!r} by {b_['bound_by']}; no single PyTorch call computes it")
        results.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b_,
                        "library_ms": None})
        if name == "user bf16 sorted":
            user_sorted = (ids_t, grads, live)
            adagrad_split(dev, kern, ids_t, grads, flush)
        if name == SKEWED:
            skewed_errs = (skewed_rowwise_adagrad(dev, ids_t, perm, grads, flush),
                           skewed_aggregate(dev, ids_t, perm, grads, flush))
    stats["quantized_rowwise_adagrad"] = {  # the step's sorted update: user table, bf16
        **results[1], "max_abs_err": max(r["max_abs_err"] for r in results)}

    # --- #3: the dense aggregate at the same ids -----------------------------------
    ids_t, grads, live = user_sorted
    got = block_sorted_aggregate(NUM_USERS, ids_t, grads)
    want = block_sorted_aggregate_reference(NUM_USERS, ids_t, grads)
    torch.cuda.synchronize()
    if torch.count_nonzero(got[~live]).item() != 0:
        raise AssertionError("block_sorted_aggregate: a row without ids is not exact zero")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # f32 summation order
    err = (got - want).abs().max().item()
    ids64, grads32 = ids_t[ids_t < NUM_USERS].long(), grads[ids_t < NUM_USERS].float()

    def aggregate_library():  # on ids and gradients prepared for it (int64, f32, live only)
        return torch.zeros((NUM_USERS, DIM), device=dev).index_add_(0, ids64, grads32)

    torch.testing.assert_close(aggregate_library(), want, rtol=1e-5, atol=1e-5)
    ms = median_ms(lambda: block_sorted_aggregate(NUM_USERS, ids_t, grads), flush)
    plain_ms = median_ms(lambda: block_sorted_aggregate_reference(NUM_USERS, ids_t, grads), flush)
    library_ms = median_ms(aggregate_library, flush)
    b_ = bound(m * DIM * grads.element_size() + m * 4 + NUM_USERS * DIM * 4, m * DIM, PEAK_F32)
    log(f"[kernel] block_sorted_aggregate user bf16 sorted: {m} ids into f32 [{NUM_USERS}, {DIM}] "
        f"(zeroed by the wrapper, timed with it); rows without ids exact zero, the rest within "
        f"rtol 1e-5; max_abs_err={err!r}, kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
        f"bound_ms={b_['bound_ms']!r} by {b_['bound_by']}, library_ms={library_ms!r} "
        "(zeros.index_add_ on int64 ids and f32 gradients)")
    stats["block_sorted_aggregate"] = {"max_abs_err": max(err, skewed_errs[1]), "ms": ms,
                                       "plain_ms": plain_ms, **b_, "library_ms": library_ms}
    stats["rowwise_adagrad on skewed ids"] = {"max_abs_err": skewed_errs[0]}

    # --- #7: the row subtract on that batch's distinct ids --------------------------
    rows = torch.unique(ids_t)  # distinct, the sentinel N among them
    upd = on_card(rng.normal(size=(rows.shape[0], DIM)).astype(np.float32))
    table = on_card(rng.normal(size=(NUM_USERS, DIM)).astype(np.float32))
    t_k, t_p, t_l = table.clone(), table.clone(), table.clone()
    row_subtract(t_k, rows, upd)
    row_subtract_reference(t_p, rows, upd)
    live_rows = rows[rows < NUM_USERS].long()
    live_upd = upd[rows < NUM_USERS].contiguous()

    def subtract_library():  # on int64 live ids
        return t_l.index_add_(0, live_rows, live_upd, alpha=-1)

    subtract_library()
    torch.cuda.synchronize()
    if not (bitwise_equal(t_k, t_p) and bitwise_equal(t_l, t_p)):
        raise AssertionError("row_subtract: kernel, plain version and index_add_ differ")
    if bitwise_equal(t_k, table):
        raise AssertionError("row_subtract changed nothing")
    ms = median_ms(lambda: row_subtract(t_k, rows, upd), flush)
    plain_ms = median_ms(lambda: row_subtract_reference(t_p, rows, upd), flush)
    library_ms = median_ms(subtract_library, flush)
    k = live_rows.shape[0]
    b_ = bound(rows.shape[0] * 4 + k * DIM * 4 * 3, k * DIM, PEAK_F32)
    log(f"[kernel] row_subtract: {rows.shape[0]} distinct ids ({k} live) into f32 [{NUM_USERS}, "
        f"{DIM}]: bitwise equal; kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
        f"bound_ms={b_['bound_ms']!r} by {b_['bound_by']}, library_ms={library_ms!r} "
        "(index_add_ alpha=-1 on int64 live ids)")
    stats["row_subtract"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b_,
                             "library_ms": library_ms}
    return stats


def adagrad_split(dev, table: tuple, ids: torch.Tensor, grads: torch.Tensor,
                  flush: torch.Tensor) -> None:
    """#6's split at the int8 step's sorted user ids (`tile_split`: the
    gradient rows read and discarded; and the run sums; and the epilogue
    without the quantization; the whole kernel), and #4 on the same ids into
    an f32 table (twice the bytes)."""
    split = tile_split(lambda stage: quantized_rowwise_adagrad_fused.split(
        stage, *table, ids, grads, LR, EPS), flush, ADAGRAD_SPLIT_STAGES)
    f32 = torch.empty((NUM_USERS, DIM), device=dev).uniform_(
        -1, 1, generator=torch.Generator(device=dev).manual_seed(9))
    acc = torch.ones(NUM_USERS, device=dev)
    ms4 = median_ms(lambda: rowwise_adagrad(f32, acc, ids, grads, LR, EPS), flush)
    log(f"[kernel] quantized_rowwise_adagrad tile split at {ids.shape[0]} sorted user ids, bf16 "
        f"gradients (ms each stage adds to the kernel run up to it): {split['split_ms']!r}; the "
        f"runs up to each stage {split['upto_ms']!r}; rowwise_adagrad (#4) on the same ids "
        f"into an f32 table {ms4!r} ms; {card_line()}")
    regs = ptxas_kernels(quantized_rowwise_adagrad_fused.load().log, "span_runs_kernel")
    log(f"[kernel] quantized_rowwise_adagrad span_runs_kernel (every instantiation, the split's "
        f"too): {regs!r}")


def tower_composed(x, dq, out, w1, b1, w2):
    """Kernel #8's function as PyTorch calls on bf16 operands: a yardstick
    of speed for the kernel, used nowhere in the port. TOWER_COMPOSED_CALLS
    calls: 5 bf16 GEMMs (the layer-1 recompute, dh1, dx, dW1, dW2, each
    summed in f32 by cuBLAS and rounded to bf16 once), 2 compares, 2
    selects, the bias add, the ReLU, 2 widenings and 2 column sums. It
    rounds dh1 to bf16 before db1 and the weight gradients to bf16, where
    the kernel keeps f32: the same function at bf16 output precision."""
    d2 = torch.where(out > 0, dq, 0)
    pre1 = x @ w1 + b1
    h1 = torch.relu(pre1)
    d1 = torch.where(pre1 > 0, d2 @ w2.T, 0)
    return d1 @ w1.T, x.T @ d1, d1.float().sum(0), h1.T @ d2, d2.float().sum(0)


TOWER_COMPOSED_CALLS = 15


WIDE_KERNEL_CASES = ((1024, 65_536), (30, 8192))  # (D, sorted ids): [train-wide-table]'s calls


def phase_wide_table_kernels(dev: torch.device) -> None:
    """#3, #4, #5, #6 and #7 at the widths of `[train-wide-table]` (D =
    1,024 at 65,536 ids, D = 30 at 8,192: the general walk, #5's wide and
    one-int8-a-lane paths, #7's element path) on the flagship user table,
    uniform sorted ids (and #4 on rank^-1 item ids through the device sort,
    in f32 and bf16-buffer mode: long runs, pass 2), each against its plain
    version at the card tests' tolerances, two launches bit for bit, and
    its time beside its bound (bytes: each input read once, each output
    written once) and, where one PyTorch call computes the same, its time."""
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    reps = 20

    def line(name, label, got_err, fn, plain, n_bytes, library=None, note="", plain_reps=reps):
        ms, plain_ms = median_ms(fn, flush, reps), median_ms(plain, flush, plain_reps)
        b = bound(n_bytes, 0, PEAK_F32)
        lib = f"library_ms={median_ms(library, flush, reps)!r}" if library else "no single " \
            "PyTorch call computes it"
        log(f"[kernel] {name} {label}: max_abs_err={got_err!r}{note}, kernel_ms={ms!r}, "
            f"plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by {b['bound_by']} (n={reps}); "
            f"{lib}; {card_line()}")

    def twice_equal(label, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not bitwise_equal(x, y):
                raise AssertionError(f"{label}: two launches on the same inputs differ")

    for d, m in WIDE_KERNEL_CASES:
        n = NUM_USERS
        ids = torch.from_numpy(np.sort(rng.integers(0, n, m)).astype(np.int32)).to(dev)
        grads = torch.empty((m, d), device=dev).normal_(generator=gen)
        table = torch.empty((n, d), device=dev).uniform_(-1, 1, generator=gen)
        acc = torch.empty(n, device=dev).uniform_(0, 1, generator=gen)
        rows = int(torch.unique(ids).numel())
        label = f"D={d}, {m} sorted ids into [{n}, {d}], f32 grads, {rows} rows touched"
        # #4
        t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
        rowwise_adagrad(t_k, a_k, ids, grads, 0.05)
        rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05)
        torch.cuda.synchronize()
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
        twice_equal(f"rowwise_adagrad {label}", lambda: [rowwise_adagrad(
            table.clone(), acc.clone(), ids, grads, 0.05)[0]])
        line("rowwise_adagrad", label, (t_k - t_p).abs().max().item(),
             lambda: rowwise_adagrad(t_k, a_k, ids, grads, 0.05),
             lambda: rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05),
             m * d * 4 + m * 4 + rows * (d * 4 * 2 + 8))
        del t_k, t_p
        # #3
        got = block_sorted_aggregate(n, ids, grads)
        want = block_sorted_aggregate_reference(n, ids, grads)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        twice_equal(f"block_sorted_aggregate {label}",
                    lambda: [block_sorted_aggregate(n, ids, grads)])
        line("block_sorted_aggregate", label + " (memset included)",
             (got - want).abs().max().item(), lambda: block_sorted_aggregate(n, ids, grads),
             lambda: block_sorted_aggregate_reference(n, ids, grads),
             m * d * 4 + m * 4 + n * d * 4,
             library=lambda: torch.zeros((n, d), device=dev).index_add_(0, ids.long(), grads))
        del got, want
        # #6 and #5 on the table quantized
        qt = quantize_table(table)
        k = (qt.values.clone(), qt.scales.clone(), acc.clone())
        p = (qt.values.clone(), qt.scales.clone(), acc.clone())
        quantized_rowwise_adagrad_fused(*k, ids, grads, 0.05)
        quantized_rowwise_adagrad_fused_reference(*p, ids, grads, 0.05)
        torch.cuda.synchronize()
        steps = (k[0].int() - p[0].int()).abs().max().item()
        if steps > 1:
            raise AssertionError(f"quantized_rowwise_adagrad {label}: int8 values {steps} steps "
                                 "apart")
        torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
        twice_equal(f"quantized_rowwise_adagrad {label}", lambda: list(
            quantized_rowwise_adagrad_fused(qt.values.clone(), qt.scales.clone(), acc.clone(),
                                            ids, grads, 0.05)))
        line("quantized_rowwise_adagrad", label, float(steps),
             lambda: quantized_rowwise_adagrad_fused(*k, ids, grads, 0.05),
             lambda: quantized_rowwise_adagrad_fused_reference(*p, ids, grads, 0.05),
             m * d * 4 + m * 4 + rows * (d * 2 + 16), note=" (int8 steps)")
        bags = ids[:, None]
        w = torch.ones((m, 1), device=dev)
        got = quantized_pooled_gather(qt.values, qt.scales, bags, w)
        want = quantized_pooled_gather_reference(qt.values, qt.scales, bags, w)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            raise AssertionError(f"quantized_pooled_gather {label}: kernel != plain version")
        line("quantized_pooled_gather", f"D={d}, [{m}, 1] bags into f32", 0.0,
             lambda: quantized_pooled_gather(qt.values, qt.scales, bags, w),
             lambda: quantized_pooled_gather_reference(qt.values, qt.scales, bags, w),
             rows * (d + 4) + m * d * 4 + m * 8,  # distinct rows and scales, the output, ids, w
             note=f" (bitwise equal{plan_note(quantized_pooled_gather, qt.values, bags, got)})")
        del qt, k, p, got, want
        # #7: one id a run, distinct
        uniq = torch.unique(ids).int()
        upd = grads[:uniq.numel()].contiguous()
        s_k, s_p = table.clone(), table.clone()
        row_subtract(s_k, uniq, upd)
        row_subtract_reference(s_p, uniq, upd)
        torch.cuda.synchronize()
        if not bitwise_equal(s_k, s_p):
            raise AssertionError(f"row_subtract D={d}: kernel != plain version")
        line("row_subtract", f"D={d}, {uniq.numel()} distinct ids into [{n}, {d}]", 0.0,
             lambda: row_subtract(s_k, uniq, upd), lambda: row_subtract_reference(s_p, uniq, upd),
             uniq.numel() * (d * 4 * 3 + 4),
             library=lambda: s_p.index_add_(0, uniq.long(), upd, alpha=-1), note=" (bitwise)")
        del s_k, s_p, table, grads
    # #4 on rank^-1 item ids at D = 1,024: the device sort's permutation, long runs
    d, m = WIDE_KERNEL_CASES[0]
    raw, perm = skewed_item_ids(rng, m, dev)
    run = longest_run(raw, NUM_ITEMS)
    grads = torch.empty((m, d), device=dev).normal_(generator=gen)
    table = torch.empty((NUM_ITEMS, d), device=dev).uniform_(-1, 1, generator=gen)
    acc = torch.empty(NUM_ITEMS, device=dev).uniform_(0, 1, generator=gen)
    rows = int(torch.unique(raw).numel())
    for buf in (None, torch.bfloat16):
        mode = "bf16 buffer" if buf is not None else "f32 sums"
        label = (f"D={d}, {m} rank^-1 item ids (longest run {run}) into [{NUM_ITEMS}, {d}] "
                 f"through the sort's perm, {mode}")
        t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
        rowwise_adagrad(t_k, a_k, raw, grads, 0.05, perm=perm, buffer_dtype=buf)
        rowwise_adagrad_reference(t_p, a_p, raw, grads, 0.05, perm=perm, buffer_dtype=buf)
        torch.cuda.synchronize()
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
        twice_equal(f"rowwise_adagrad {label}", lambda: [rowwise_adagrad(
            table.clone(), acc.clone(), raw, grads, 0.05, perm=perm, buffer_dtype=buf)[0]])
        line("rowwise_adagrad", label, (t_k - t_p).abs().max().item(),
             lambda: rowwise_adagrad(t_k, a_k, raw, grads, 0.05, perm=perm, buffer_dtype=buf),
             lambda: rowwise_adagrad_reference(t_p, a_p, raw, grads, 0.05, perm=perm,
                                               buffer_dtype=buf),
             m * d * 4 + m * 8 + rows * (d * 4 * 2 + 8),
             plain_reps=3 if buf is not None else reps)  # the bf16 buffer's loop: a step a rank


def phase_tower_kernel(dev: torch.device) -> dict:
    """Kernel #8 against its plain version at the flagship tower's shapes,
    with bf16 io (the bf16 step's) and f32 io, and at H2 = 128. dx, dW1 and
    dW2 within one bf16 ulp of their largest magnitude: each product takes
    bf16-rounded intermediates (pre1, d1, dx), and where an f32 sum lands on
    a bf16 rounding boundary the two versions, which sum in different
    orders, round it to neighbouring bf16 values. db1 and db2 sum unrounded
    f32 values: within 1e-5 x max. Then the layer whose every layer-1 sum
    sits at a bf16 rounding tie (`tie_inputs`), held to the plain version
    with pre1 summed in k order (the decisions the kernel takes there). Two
    launches on the same inputs must agree bit for bit. Beside the kernel's
    time: the plain version's, the bound and the kernel's share of it, and
    `tower_composed`'s (bf16 GEMMs and masks); then the registers and spills
    of the kernel's instantiations and, at the BCE shape, its tile split."""
    rng = np.random.default_rng(3)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    h2 = LAYERS[1]

    def on_card(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def draw(rows: int, width: int):
        x = on_card(rng.normal(size=(rows, DIM)), torch.bfloat16)
        dq = on_card(rng.normal(size=(rows, width)) / rows, torch.bfloat16)
        out = on_card(np.maximum(rng.normal(size=(rows, width)), 0), torch.bfloat16)
        w1 = on_card(rng.normal(size=(DIM, DIM), scale=0.1))
        b1 = on_card(rng.normal(size=DIM) * 0.1)
        w2 = on_card(rng.normal(size=(DIM, width), scale=0.1))
        # the weights as the towers pass them: bf16
        return (x, dq, out, *(w.to(torch.bfloat16) for w in (w1, b1, w2)))

    x, dq, out, w1, b1, w2 = draw(TRAIN_BATCH, h2)
    ta, tw, tb = tie_inputs(16_384, DIM, 4)
    tie_case = (on_card(ta, torch.bfloat16), on_card(rng.normal(loc=0.5, size=(16_384, h2)),
                                                     torch.bfloat16),
                on_card(np.maximum(rng.normal(size=(16_384, h2)), 0), torch.bfloat16),
                on_card(tw, torch.bfloat16), on_card(tb, torch.bfloat16),
                on_card(rng.normal(size=(DIM, h2), scale=0.1), torch.bfloat16))
    cases = {"bf16 io": ((x, dq, out, w1, b1, w2), tower_backward_reference),
             "f32 io": ((x.float(), dq.float(), out.float(), w1, b1, w2),
                        tower_backward_reference),
             "bf16 io, H2 = 128": (draw(TRAIN_BATCH, 128), tower_backward_reference),
             "every layer-1 sum at a tie": (tie_case, k_order_backward)}
    labels = ("dx", "dW1", "db1", "dW2", "db2")
    results = {}
    for case, (args, plain) in cases.items():
        got = [t.clone() for t in tower_backward(*args)]
        again = tower_backward(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        errs = [within_rel(g, w, 2.0 ** -8 if i in (0, 1, 3) else 1e-5, f"tower_bwd {case} {label}")
                for i, (g, w, label) in enumerate(zip(got, want, labels))]
        if not all(bitwise_equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"tower_bwd {case}: two launches on the same inputs differ")
        rows, width = args[0].shape[0], args[1].shape[1]
        io_bytes = args[0].element_size()
        # x, dq and out read and dx written, the weights read, their gradients written
        b = bound(rows * (2 * DIM + 2 * width) * io_bytes + 2 * (DIM * DIM + DIM + DIM * width)
                  + 4 * (DIM * DIM + DIM + DIM * width + width),
                  2 * rows * DIM * (3 * DIM + 2 * width), PEAK_BF16)
        ms = median_ms(lambda: tower_backward(*args), flush)
        plain_ms = median_ms(lambda: plain(*args), flush, reps=5 if plain is k_order_backward
                             else REPS)
        log(f"[kernel] tower_bwd {case} [{rows}, {DIM}] -> [{DIM}] -> [{width}]: dx, dW1, dW2 "
            f"within 2^-8 x max|plain|, db within 1e-5 x max|plain|, two launches bit for bit "
            f"equal; max_abs_err(dx, dW1, db1, dW2, db2)={errs!r}, kernel_ms={ms!r}, "
            f"plain_ms={plain_ms!r}, bound_ms={b['bound_ms']!r} by {b['bound_by']} "
            f"({b['bound_ms'] / ms!r} of it)")
        results[case] = (max(errs), ms, plain_ms, b)
    # the yardstick's own distance from the plain version, printed, not held: its bf16
    # GEMMs sum on the tensor cores and take ReLU decisions at rounding ties as they fall
    composed = tower_composed(x, dq, out, w1, b1, w2)
    want = tower_backward_reference(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() and g.shape == w.shape for g, w in zip(composed, want)):
        raise AssertionError("tower_composed: not finite or of another shape")
    comp_errs = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                 for g, w in zip(composed, want)]
    composed_ms = median_ms(lambda: tower_composed(x, dq, out, w1, b1, w2), flush)
    _, ms, plain_ms, b = results["bf16 io"]
    log(f"[kernel] tower_bwd: bound_ms={b['bound_ms']!r} by {b['bound_by']} "
        f"({b['bound_ms'] / ms!r} of the kernel's time); no single PyTorch call computes it; "
        f"composed_ms={composed_ms!r} ({TOWER_COMPOSED_CALLS} PyTorch calls, 5 of them bf16 "
        f"GEMMs; max abs diff from the plain version over its max: {comp_errs!r})")
    for line in ptxas_kernels(tower_backward.load().log, "tower_bwd_kernel"):
        log(f"[kernel] tower_bwd build: {line}")
    split = tile_split(lambda stage: tower_backward.split(stage, x, dq, out, w1, b1, w2), flush,
                       BWD_SPLIT_STAGES)
    log(f"[kernel] tower_bwd tile split at [{TRAIN_BATCH}, {DIM}] -> [{DIM}] -> [{h2}] bf16 io "
        f"(ms each stage adds to the kernel run up to it): {split['split_ms']!r}; the runs up "
        f"to each stage {split['upto_ms']!r}")
    return {"max_abs_err": max(r[0] for r in results.values()), "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "composed_ms": composed_ms}


def k_order_backward(x, dq, out, w1, b1, w2):
    """The plain version of kernel #8 with pre1 summed in k order (one fmaf a
    k, as an f32 GEMM sums it): the ReLU decisions the kernel, the forward
    and the host take where a layer-1 sum sits at a bf16 rounding tie."""
    def bf(t):
        return t.to(torch.bfloat16).float()
    d2 = torch.where(out.float() > 0, dq.float(), 0.0)
    a, w = bf(x), bf(w1)
    s = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        s = s + a[:, k:k + 1] * w[k]
    pre1 = (s.to(torch.bfloat16) + b1.to(torch.bfloat16)).float()
    d1 = torch.where(pre1 > 0, bf(d2) @ bf(w2).T, 0.0)
    dx = (bf(d1) @ bf(w1).T).to(x.dtype)
    return dx, a.T @ bf(d1), d1.sum(0), torch.relu(pre1).T @ bf(d2), d2.sum(0)


def ptxas_kernels(build_log: str, name: str) -> list[str]:
    """Each instantiation of the kernel `name` in a build's `-Xptxas -v` log:
    its template arguments (io dtype, then its integer arguments), its
    registers a thread and its spill bytes."""
    found, entry, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = (m.group(1) if name in m.group(1) else None), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            tail = entry[entry.index(name) + len(name):]
            io = "bf16" if tail.startswith("I13__nv_bfloat16") else "f32"
            ints = re.findall(r"L[ib](\d+)E", tail.split("CUtensorMap")[0])
            regs = re.search(r"Used (\d+) registers", line).group(1)
            found.append(f"<{io}, {', '.join(ints)}>: {regs} registers; {spill}")
            entry = None
    return found


def wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of `fn` between two synchronizes: for a plain version
    that synchronizes inside (a `nonzero`), where device events would also
    take in the host's wait."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tie_inputs(b: int, n: int, seed: int):
    """A layer whose every sum sits within a few f32 ulps of a bf16 rounding
    midpoint against -bias (as `tests/torch_tie_cases.py` builds it): column
    c of w starts with m_c in [1, 2) and 2^-8 against a's leading 1, 1, the
    bias is -m_c, and the other 126 products are ~2^-24."""
    rng = np.random.default_rng(seed)
    m = 1 + rng.integers(0, 128, n) / 128
    a = rng.normal(size=(b, DIM))
    a[:, :2] = 1.0
    w = rng.normal(size=(DIM, n)) * 2.0 ** -24
    w[0], w[1] = m, 2.0 ** -8
    return a, w, -m


def phase_relu_ties_kernel(dev: torch.device) -> dict:
    """relu_ties against its plain version at the four calls a BCE step of
    the two-GEMM route takes (layer 1 [262,144, 128] and layer 2 [262,144,
    64] of each tower, K = 128; off the main path since tower_fwd) on draws
    at the towers' scales, and on a layer whose every sum sits at a rounding
    tie (every value recomputed): bit for bit (values), two launches bit for
    bit; the share of values the tie test recomputes; the kernel's ms a call
    and a BCE step beside the plain version's, the bound and the two PyTorch
    calls it replaced (`relu(y + b)`, not the same function at a tie)."""
    rng = np.random.default_rng(9)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def on_card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    lim = 1 / DIM ** 0.5  # init_mlp's bound
    x = on_card(rng.normal(size=(TRAIN_BATCH, DIM), scale=0.05))
    w1, b1 = on_card(rng.uniform(-lim, lim, (DIM, DIM))), on_card(rng.uniform(-lim, lim, DIM))
    w2 = on_card(rng.uniform(-lim, lim, (DIM, LAYERS[1])))
    b2 = on_card(rng.uniform(-lim, lim, LAYERS[1]))
    y1 = torch.matmul(x, w1)
    h1 = relu_ties(y1, b1, x, w1)
    ta, tw, tb = (on_card(v) for v in tie_inputs(16_384, DIM, 10))
    cases = {"layer 1": (y1, b1, x, w1), "layer 2": (torch.matmul(h1, w2), b2, h1, w2),
             "every sum at a tie": (torch.matmul(ta, tw), tb, ta, tw)}
    out = {}
    for label, args in cases.items():
        got = relu_ties(*args).clone()
        again = relu_ties(*args)
        want = relu_ties_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"relu_ties {label}: {bad} values differ from the plain version")
        if not bitwise_equal(got, again):
            raise AssertionError(f"relu_ties {label}: two launches on the same inputs differ")
        y, bias, a, w = args
        ties = tie_mask(y, bias)
        marked = int(ties.sum())
        rows, n = y.shape
        ms = median_ms(lambda: relu_ties(*args), flush)
        plain_ms = wall_ms(lambda: relu_ties_reference(*args))
        composed_ms = median_ms(lambda: torch.relu(y + bias), flush)
        # y read and out written; b; each row of a and column of w that a tie sums, once
        tie_rows = int(ties.any(1).sum() + ties.any(0).sum())
        b = bound(4 * rows * n + 2 * n + 2 * a.shape[1] * tie_rows, 2 * marked * a.shape[1],
                  PEAK_F32)
        out[label] = (ms, plain_ms, b)
        log(f"[kernel] relu_ties {label} [{rows}, {n}], K={a.shape[1]}: bit for bit the plain "
            f"version (values), two launches bit for bit; recomputed {marked} of {y.numel()} "
            f"({marked / y.numel()!r}); kernel_ms={ms!r} plain_ms={plain_ms!r} (host ms, it "
            f"synchronizes) bound_ms={b['bound_ms']!r} by {b['bound_by']}; relu(y + b) "
            f"(2 PyTorch calls, the route it replaces) {composed_ms!r} ms")
    (ms1, plain1, b1_), (ms2, plain2, b2_) = out["layer 1"], out["layer 2"]
    log(f"[kernel] relu_ties a BCE step of the two-GEMM route (2 towers x the two layers): "
        f"kernel {2 * (ms1 + ms2)!r} ms, bound {2 * (b1_['bound_ms'] + b2_['bound_ms'])!r} ms")
    return {"max_abs_err": 0.0, "ms": ms1, "plain_ms": plain1, **b1_, "library_ms": None,
            "ms_a_bce_step": 2 * (ms1 + ms2)}


def k_order_tower(x, w1, b1, w2, b2) -> torch.Tensor:
    """The fused tower's bf16 forward with every product summed in k order
    (a product of bf16 values is exact in f32 and each add rounds once: an
    f32 GEMM's fmaf chain): the k-order route, whose ReLU decisions the
    forward must make at rounding ties."""
    def layer(a, w, b):
        a, w = a.float(), w.float()
        s = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
        for k in range(a.shape[1]):
            s = s + a[:, k:k + 1] * w[k]
        return torch.relu(s.to(torch.bfloat16) + b)
    return layer(layer(x, w1, b1), w2, b2)


def two_gemm_route(x, w1, b1, w2, b2) -> torch.Tensor:
    """The forward before tower_fwd: a cuBLAS GEMM and relu_ties a layer (the
    same function as the fused kernel's, up to the order of the sums)."""
    h1 = relu_ties(_mm(x, w1), b1, x, w1)
    return relu_ties(_mm(h1, w2), b2, h1, w2)


def tile_split(launch, flush: torch.Tensor, stages) -> dict[str, dict[str, float]]:
    """A tile's time split into its stages: `launch(stage)` runs the kernel
    up to that stage of `stages` (the last: the whole kernel; e.g.
    tower_fwd's x loads alone; and the products; and the epilogues, ties
    taken as none; and the tie rounds; and the output stores), and a
    stage's ms is what it adds to the run before it, so the parts sum to the
    whole kernel's median."""
    upto = {stage: median_ms(lambda: launch(stage), flush) for stage in stages}
    split, before = {}, 0.0
    for stage in stages:
        split[stage] = upto[stage] - before
        before = upto[stage]
    return {"upto_ms": upto, "split_ms": split}


def phase_tower_fwd_kernel(dev: torch.device, profile: bool) -> dict:
    """tower_fwd (the fused tower's bf16 forward) against its plain version
    (`tower_forward_reference`: cuBLAS GEMMs and relu_ties's plain version)
    at the BCE step's two tower calls ([262,144, 128 -> 128 -> 64], draws at
    the towers' scales, the weights as the towers pass them: `nn.Linear`
    weights' transposed views), at H2 = 128, on the tie inputs (every
    layer-1 sum at a rounding tie) at 16,384 rows, and at 65,536 rows with
    two layer-1 columns at ties (the towers' few ties a tile, but in every
    row): values within 2^-8 x
    max|plain| (another order of the tensor cores' sums), two launches bit
    for bit, the share of values bit for bit the plain version's, the ReLU
    decisions that differ from the plain version's and, where every layer-1
    sum ties, from the k-order route's (none may; with two tied columns, h1
    in them, W2 = I, bit for bit the k-order route's), the share of each layer's values
    the plain route recomputes; the kernel's ms beside the plain version's,
    the bound (bytes: x read, out written, the weights; FLOPs: both products
    and the ties' recompute) and its share, and the two-GEMM route's ms,
    split into its `_mm` and relu_ties calls; at the BCE step's shape the
    kernel's tile split (`tile_split`). Under --profile, the device
    kernels of one bf16 tower forward through `Mlp2Relu`'s path: one
    tower_fwd, no GEMM."""
    rng = np.random.default_rng(12)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def on_card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    lim = 1 / DIM ** 0.5  # init_mlp's bound

    def towers_draw(rows: int, h2: int):
        x = on_card(rng.normal(size=(rows, DIM), scale=0.05))
        w1 = on_card(rng.uniform(-lim, lim, (DIM, DIM))).T  # an nn.Linear weight's .T
        w2 = on_card(rng.uniform(-lim, lim, (h2, DIM))).T
        return x, w1, on_card(rng.uniform(-lim, lim, DIM)), w2, on_card(rng.uniform(-lim, lim, h2))

    ta, tw, tb = tie_inputs(16_384, DIM, 13)
    sa, sw, sb = tie_inputs(65_536, DIM, 14)  # two columns at ties, the rest drawn
    sw[:, 2:], sb[2:] = rng.uniform(-lim, lim, (DIM, DIM - 2)), rng.uniform(-lim, lim, DIM - 2)

    def layer2():
        return (on_card(rng.normal(size=(DIM, LAYERS[1]), scale=0.1)),
                on_card(rng.normal(size=LAYERS[1], scale=0.1)))

    cases = {"user tower": towers_draw(TRAIN_BATCH, LAYERS[1]),
             "item tower": towers_draw(TRAIN_BATCH, LAYERS[1]),
             "H2 = 128": towers_draw(TRAIN_BATCH, 128),
             "every layer-1 sum at a tie": (on_card(ta), on_card(tw), on_card(tb), *layer2()),
             "two layer-1 columns at a tie": (on_card(sa), on_card(sw), on_card(sb), *layer2())}
    out = {}
    for label, args in cases.items():
        x, w1, b1, w2, b2 = args
        rows, h2 = x.shape[0], w2.shape[1]
        got = tower_forward(*args).clone()
        again = tower_forward(*args)
        want = tower_forward_reference(*args)
        torch.cuda.synchronize()
        err = within_rel(got, want, 2.0 ** -8, f"tower_fwd {label}")
        if not bitwise_equal(got, again):
            raise AssertionError(f"tower_fwd {label}: two launches on the same inputs differ")
        same = (got == want).float().mean().item()
        flips = int(((got > 0) != (want > 0)).sum())
        k_note = ""
        if label == "every layer-1 sum at a tie":  # h1 is the k-order route's
            k_flips = int(((got > 0) != (k_order_tower(*args) > 0)).sum())
            if k_flips:
                raise AssertionError(f"tower_fwd {label}: {k_flips} ReLU decisions differ from "
                                     "the k-order route's")
            k_note = "; 0 decisions differ from the k-order route's"
        elif label == "two layer-1 columns at a tie":  # out = h1 with W2 = I, b2 = 0
            eye = torch.eye(DIM, dtype=torch.bfloat16, device=dev)
            zero = torch.zeros(DIM, dtype=torch.bfloat16, device=dev)
            h1_k = k_order_tower(x, w1, b1, eye, zero)[:, :2]
            if not torch.equal(tower_forward(x, w1, b1, eye, zero)[:, :2], h1_k):
                raise AssertionError(f"tower_fwd {label}: h1 in the tied columns is not the "
                                     "k-order route's")
            k_note = "; h1 in the tied columns bit for bit the k-order route's"
        y1 = _mm(x, w1)
        h1 = relu_ties_reference(y1, b1, x, w1)
        y2 = _mm(h1, w2)
        ties = (int(tie_mask(y1, b1).sum()), int(tie_mask(y2, b2).sum()))
        ms = median_ms(lambda: tower_forward(*args), flush)
        plain_ms = wall_ms(lambda: tower_forward_reference(*args))
        route = {"_mm 1": median_ms(lambda: _mm(x, w1), flush),
                 "relu_ties 1": median_ms(lambda: relu_ties(y1, b1, x, w1), flush),
                 "_mm 2": median_ms(lambda: _mm(h1, w2), flush),
                 "relu_ties 2": median_ms(lambda: relu_ties(y2, b2, h1, w2), flush)}
        route_ms = median_ms(lambda: two_gemm_route(*args), flush)
        n_bytes = 2 * (rows * (DIM + h2) + DIM * DIM + DIM + DIM * h2 + h2)
        b = bound(n_bytes, 2 * rows * DIM * (DIM + h2) + 2 * DIM * sum(ties), PEAK_BF16)
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                      "route_ms": route_ms}
        log(f"[kernel] tower_fwd {label} [{rows}, {DIM}] -> [{DIM}] -> [{h2}] bf16: within "
            f"2^-8 x max|plain| (max_abs_err={err!r}), two launches bit for bit, "
            f"{same!r} of the values bit for bit the plain version's, {flips} ReLU decisions "
            f"differ from it{k_note}; the plain route recomputes {ties[0]} of {rows * DIM} "
            f"({ties[0] / (rows * DIM)!r}) in layer 1, {ties[1]} of {rows * h2} "
            f"({ties[1] / (rows * h2)!r}) in layer 2; kernel_ms={ms!r} plain_ms={plain_ms!r} "
            f"(host ms, it synchronizes) bound_ms={b['bound_ms']!r} by {b['bound_by']} "
            f"({b['bound_ms'] / ms!r} of it); the two-GEMM route {route_ms!r} ms "
            f"({ {k: v for k, v in route.items()} }), {route_ms / ms!r}x the kernel")
    user, item = out["user tower"], out["item tower"]
    log(f"[kernel] tower_fwd a BCE step (2 towers): kernel {user['ms'] + item['ms']!r} ms, bound "
        f"{user['bound_ms'] + item['bound_ms']!r} ms "
        f"({(user['bound_ms'] + item['bound_ms']) / (user['ms'] + item['ms'])!r} of it); the "
        f"two-GEMM route {user['route_ms'] + item['route_ms']!r} ms")
    if profile:
        from two_tower_recommender_model_tpu_torch.models.mlp import _mlp2_fwd_impl

        x, w1, b1, w2, b2 = cases["user tower"]
        kernels = profile_direct(lambda: _mlp2_fwd_impl(w1, b1, w2, b2, x),
                                 "bf16 tower forward", 1, calls=5, marker="tower_fwd")
        gemms = [name for name in kernels if any(
            m in name.lower() for m in ("gemm", "xmma", "cutlass", "sm90_", "ampere_"))]
        if gemms or len(kernels) != 1:
            raise AssertionError(f"[profile] the bf16 tower forward runs {sorted(kernels)}: "
                                 f"one tower_fwd and no GEMM expected")
    args = cases["user tower"]
    split = tile_split(lambda stage: tower_forward.split(stage, *args), flush, SPLIT_STAGES)
    log(f"[kernel] tower_fwd tile split at [{TRAIN_BATCH}, {DIM}] -> [{DIM}] -> [{LAYERS[1]}] "
        f"(ms each stage adds to the kernel run up to it): {split['split_ms']!r}; the runs up "
        f"to each stage {split['upto_ms']!r}")
    return {**user, "library_ms": None, "max_abs_err": max(r["max_abs_err"] for r in out.values()),
            "ms_a_bce_step": user["ms"] + item["ms"]}


def softmax_case(dev, rng, bq: int, bk: int, row_offset: int, n_valid: int | None, d: int = 64):
    """Inputs of one softmax kernel case: bf16-valued q and c, item ids as
    drawn from the flagship's 49,688 items (they repeat) plus forced repeats,
    logQ, and the cotangent the loss hands the lse (label / count)."""
    def on_card(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    q16 = on_card(rng.normal(size=(bk, d)).astype(np.float32), torch.bfloat16)
    c16 = on_card(rng.normal(size=(bk, d)).astype(np.float32), torch.bfloat16)
    ids = rng.integers(1, NUM_ITEMS, bk).astype(np.int32)
    ids[:64] = ids[64:128]  # forced accidental hits
    ids[bk // 2:bk // 2 + 64] = ids[7]
    counts = np.bincount(ids, minlength=NUM_ITEMS).astype(np.float32)
    log_q = np.log(np.maximum(counts[ids], 1.0) / bk).astype(np.float32)
    labels = (rng.random(bk) < 0.7).astype(np.float32)
    g = labels / max(labels.sum(), 1.0)
    rows = slice(row_offset, row_offset + bq)
    ids_t = on_card(ids)
    adj = sk._merged_adj(on_card(log_q), n_valid, bk, dev)
    args = (q16[rows].contiguous(), c16, adj, ids_t[rows].contiguous(), ids_t, row_offset, 1.0)
    return args, on_card(g[rows].astype(np.float32))


def grad_close(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """dq or dc: within 1e-3 x max|plain| and cosine > 0.99999. p is rounded
    to bf16 per score; the kernel and the plain version sum a score in
    different orders, so a p on a rounding boundary rounds either way, one
    bf16 ulp (2^-8) of one p among the thousands a row sums."""
    err = within_rel(got, want, 1e-3, label)
    cos = torch.nn.functional.cosine_similarity(got.flatten().double(), want.flatten().double(),
                                                dim=0).item()
    if not cos > 0.99999:
        raise AssertionError(f"{label}: cosine {cos!r} <= 0.99999")
    return err


def softmax_composed(q16, c16, adj, row_ids, col_ids, row_offset, inv_t, lse, g, which, pos):
    """Kernel #10's (`which="dq"`) or #11's ("dc") function of the square case
    as PyTorch calls: a yardstick of speed for the kernels, used nowhere in
    the port. SOFTMAX_COMPOSED_CALLS calls: the bf16 cuBLAS scores q16 @
    c16.T (summed in f32, rounded to bf16 once, where the kernels keep the
    f32 sum), the widening, 1/T, adj, the duplicate mask (two compares, an
    and, a fill; `pos` is arange(B), made outside), exp(s - lse) * g and its
    bf16 rounding, the second bf16 GEMM, its widening and 1/T. It allocates
    the [B, B] scores that the kernels never write."""
    s = (q16 @ c16.T).float() * inv_t - adj
    dup = (row_ids[:, None] == col_ids) & (row_offset + pos[:, None] != pos)
    p = (torch.exp(s.masked_fill(dup, sk.NEG) - lse[:, None]) * g[:, None]).to(torch.bfloat16)
    return ((p @ c16) if which == "dq" else (p.T @ q16)).float() * inv_t


SOFTMAX_COMPOSED_CALLS = 16


WIDE_SQUARE = 4096  # the D = 2,048 square of [kernel] (its stripe: a quarter of the rows)
SMALL_PANEL_BYTES = 32 << 20  # a panel that may stay in the 50 MB L2 between its three passes


def p_close(got: torch.Tensor, want: torch.Tensor, ex: torch.Tensor, g: torch.Tensor,
            label: str) -> float:
    """A panel of p (bf16) against the plain one: every p of weight
    (exp(s - lse) >= 2^-10) bit for bit, the rest within one bf16 ulp (the
    spacing at the larger magnitude, 2^-133 below 2^-126) or within 2^-126 |g|
    (ex2.approx flushes an exp below 2^-126 to zero); the max abs
    difference."""
    weighty = ex >= 2.0 ** -10
    if not bitwise_equal(got[weighty], want[weighty]):
        n = int((got[weighty].view(torch.int16) != want[weighty].view(torch.int16)).sum())
        raise AssertionError(f"{label}: {n} p of weight differ from the plain version's bits")
    a, b = got.float(), want.float()
    m = torch.maximum(torch.maximum(a.abs(), b.abs()), torch.tensor(2.0 ** -126, device=a.device))
    _, e = torch.frexp(m)
    ulp = torch.maximum(torch.ldexp(torch.ones_like(m), e - 8), 2.0 ** -126 * g.abs()[:, None])
    diff = (a - b).abs()
    if not (diff <= ulp).all():
        raise AssertionError(f"{label}: {int((diff > ulp).sum())} p past one bf16 ulp")
    return diff.max().item()


def softmax_wide_parts(dev, label: str, args, lse, g, got: tuple, want: tuple, flush,
                       reps: int) -> dict:
    """#10 and #11 at a wide D, a piece at a time, on the case's inputs (one
    panel: every case here fits one): the p kernel's panel against
    `p_panel_reference` (`p_close`), two launches bit for bit; each product
    on that panel against its plain version at `grad_close`'s bars; the
    both-gradients entry (`softmax_lse_grads`, one p for both) bit for bit
    the single wrappers' dq and dc (`got`) and within `grad_close` of the
    plain backward (`want`). Kernel and plain ms of the p kernel, of each
    product and of the backward as a whole, each with its bound: the p
    kernel's by its 2 BQ BK D operations, its exps and its bytes (q, c and
    the scalars read, P written); a product's by its 2 BQ BK D and the
    bytes of P, its operand and its output; the whole backward's as a
    function (6 BQ BK D: the score once and the two products; q, c, dq and
    dc) and as these three launches (P written once and read twice beside).
    At the main path's square (8,192, D = 256) also the backward in panels
    of SMALL_PANEL_BYTES against one panel: dq bit for bit, dc within
    `grad_close`, both timed."""
    q16, c16, adj, row_ids, col_ids, off, inv_t = args
    (bq, d), bk = q16.shape, c16.shape[0]
    qp, cp = sk._pad_dim(q16), sk._pad_dim(c16)
    dp = qp.shape[1]
    largs = (*args, lse, g)
    cols = torch.arange(bk, device=dev)
    s = sk._scores(qp.float(), cp.float(), adj, row_ids, col_ids, cols[off:off + bq], cols, inv_t)
    ex = torch.exp(s - lse[:, None])
    del s
    p = sk.softmax_lse_p(*largs, 0, bq)
    p2 = sk.softmax_lse_p(*largs, 0, bq)
    want_p = sk.p_panel_reference(*largs, 0, bq)
    torch.cuda.synchronize()
    if not bitwise_equal(p, p2):
        raise AssertionError(f"{label}: two launches of the p kernel differ")
    p_err = p_close(p, want_p, ex, g, f"{label} p")
    n_weighty = int((ex >= 2.0 ** -10).sum())
    del p2, want_p, ex
    dq_o = torch.empty((bq, dp), dtype=torch.float32, device=dev)
    dc_o = torch.empty((bk, dp), dtype=torch.float32, device=dev)
    sk.softmax_lse_dq.product(p, cp, dq_o, inv_t)
    sk.softmax_lse_dc.product(p, qp, dc_o, inv_t)
    want_dq_o = sk.dq_product_reference(p, cp, inv_t)
    want_dc_o = sk.dc_product_reference(p, qp, torch.empty_like(dc_o), inv_t, True, True)
    both = sk.softmax_lse_grads(*largs)
    torch.cuda.synchronize()
    errs = {"dq_product": grad_close(dq_o, want_dq_o, f"{label} dq product"),
            "dc_product": grad_close(dc_o, want_dc_o, f"{label} dc product")}
    del want_dq_o, want_dc_o
    if not (bitwise_equal(both[0], got[0]) and bitwise_equal(both[1], got[1])):
        raise AssertionError(f"{label}: softmax_lse_grads differs from the single wrappers")
    grad_close(both[0], want[0], f"{label} softmax_lse_grads dq")
    grad_close(both[1], want[1], f"{label} softmax_lse_grads dc")
    small = (bq + bk) * (dp * 2 + 12)  # q and c in bf16; ids, adj, lse, g
    p_bytes, flops = bq * bk * 2, 2 * bq * bk * dp
    calls = {
        "p": (lambda: sk.softmax_lse_p(*largs, 0, bq, out=p),
              lambda: sk.p_panel_reference(*largs, 0, bq),
              bound(small + p_bytes, flops, PEAK_BF16, bq * bk)),
        "dq_product": (lambda: sk.softmax_lse_dq.product(p, cp, dq_o, inv_t),
                       lambda: sk.dq_product_reference(p, cp, inv_t),
                       bound(p_bytes + bk * dp * 2 + bq * dp * 4, flops, PEAK_BF16)),
        "dc_product": (lambda: sk.softmax_lse_dc.product(p, qp, dc_o, inv_t),
                       lambda: sk.dc_product_reference(p, qp, dc_o, inv_t, True, True),
                       bound(p_bytes + bq * dp * 2 + bk * dp * 4, flops, PEAK_BF16)),
        "backward": (lambda: sk.softmax_lse_grads(*largs),
                     lambda: sk.lse_backward_reference(*largs),
                     bound(small + (bq + bk) * dp * 4, 3 * flops, PEAK_BF16, bq * bk)),
    }
    out: dict = {"rows_of_weight": n_weighty, "p_max_abs_err": p_err,
                 **{f"{k}_max_abs_err": v for k, v in errs.items()}}
    for name, (kernel, plain, b) in calls.items():
        out[f"{name}_ms"] = median_ms(kernel, flush, reps)
        out[f"{name}_plain_ms"] = median_ms(plain, flush, reps)
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = b["bound_ms"], b["bound_by"]
    three = bound(small + 3 * p_bytes + (bq + bk) * dp * 4, 3 * flops, PEAK_BF16, bq * bk)
    out["three_launches_bound_ms"], out["three_launches_bound_by"] = (three["bound_ms"],
                                                                      three["bound_by"])
    out["p"] = {"ms": out["p_ms"], "plain_ms": out["p_plain_ms"],
                **calls["p"][2], "library_ms": None}
    if (bq, bk, d) == (SOFTMAX_BATCH, SOFTMAX_BATCH, 256):
        panel = sk.PANEL_BYTES
        try:
            sk.PANEL_BYTES = SMALL_PANEL_BYTES
            rows = sk.panel_rows(bq, bk)
            small_panels = sk.softmax_lse_grads(*largs)
            torch.cuda.synchronize()
            if not bitwise_equal(small_panels[0], both[0]):
                raise AssertionError(f"{label}: dq in panels of {rows} rows differs")
            grad_close(small_panels[1], both[1], f"{label} dc in panels of {rows} rows")
            out[f"backward_ms_in_panels_of_{rows}_rows"] = median_ms(
                lambda: sk.softmax_lse_grads(*largs), flush, reps)
        finally:
            sk.PANEL_BYTES = panel
        out["backward_ms_one_panel_again"] = median_ms(lambda: sk.softmax_lse_grads(*largs),
                                                       flush, reps)
    return out


def phase_softmax_kernel(dev: torch.device) -> dict[str, dict]:
    """Kernels #9, #10 and #11 against their plain versions: the square case
    at the production batch (with and without padded columns) and at the
    large batch, and one stripe of a four-way data-parallel split, which must
    also equal its rows of the square case; then at wide D (the kernels'
    TMA + wgmma ring): the production square at D = 192 and 256, and a square
    of WIDE_SQUARE and its stripe at D = 2,048. Two launches of each kernel
    on the same inputs must agree bit for bit in every case. The bounds
    count one exp a score. At the main path's shape (D = 64), and at D = 256
    and 2,048, beside the kernels' times: `softmax_composed`'s (bf16 GEMMs
    and elementwise calls). At a wide D, #10 and #11 are the p kernel and
    their products (`softmax_wide_parts`), and a stripe's dq rows must be bit
    for bit its square's."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    names = ("softmax_lse_fwd", "softmax_lse_dq", "softmax_lse_dc")
    stats: dict[str, dict] = {n: {"max_abs_err": 0.0} for n in (*names, "softmax_lse_p")}
    wide: dict[str, dict] = {}  # label -> the wide backward's parts
    squares = {}  # (bk, d) -> the square case's (lse, dq), for its stripe
    for label, bq, bk, off, n_valid, reps, d in (
            ("square", SOFTMAX_BATCH, SOFTMAX_BATCH, 0, None, 20, 64),
            ("stripe of the square", SOFTMAX_BATCH // 4, SOFTMAX_BATCH, SOFTMAX_BATCH // 4, None,
             20, 64),
            ("square", SOFTMAX_BATCH, SOFTMAX_BATCH, 0, None, 20, 128),
            ("stripe of the square", SOFTMAX_BATCH // 4, SOFTMAX_BATCH, 3 * SOFTMAX_BATCH // 4,
             None, 20, 128),
            ("square, padded columns", SOFTMAX_BATCH, SOFTMAX_BATCH, 0, SOFTMAX_BATCH - 192, 5,
             64),
            ("large square", SOFTMAX_BIG, SOFTMAX_BIG, 0, None, 3, 64),
            ("stripe of the large square", SOFTMAX_BIG // 4, SOFTMAX_BIG, SOFTMAX_BIG // 2, None,
             3, 64),
            ("wide square", SOFTMAX_BATCH, SOFTMAX_BATCH, 0, None, 5, 192),
            ("wide square", SOFTMAX_BATCH, SOFTMAX_BATCH, 0, None, 10, 256),
            ("wide square", WIDE_SQUARE, WIDE_SQUARE, 0, None, 5, 2048),
            ("stripe of the wide square", WIDE_SQUARE // 4, WIDE_SQUARE, WIDE_SQUARE // 2, None,
             5, 2048)):
        label = f"{label} [{bq} x {bk}, row_offset={off}, n_valid={n_valid}]"
        # a stripe reuses its square's draws, so its rows are that case's rows
        seed = 6 if bk in (SOFTMAX_BIG, WIDE_SQUARE) else 5
        args, g = softmax_case(dev, np.random.default_rng(seed), bq, bk, off, n_valid, d)
        lse, lse2 = sk.softmax_lse_fwd(*args), sk.softmax_lse_fwd(*args)
        want_lse = sk.lse_forward_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=1e-5)  # f32 summation order
        if not bitwise_equal(lse, lse2):
            raise AssertionError(f"{label}: two launches of the forward on the same inputs differ")
        del lse2
        # both backwards from the plain lse, so only the backward itself is compared
        dq, dc = sk.softmax_lse_dq(*args, want_lse, g), sk.softmax_lse_dc(*args, want_lse, g)
        want_dq, want_dc = sk.lse_backward_reference(*args, want_lse, g)
        dq2, dc2 = sk.softmax_lse_dq(*args, want_lse, g), sk.softmax_lse_dc(*args, want_lse, g)
        torch.cuda.synchronize()
        if not (bitwise_equal(dq, dq2) and bitwise_equal(dc, dc2)):
            raise AssertionError(f"{label}: two launches of dq or dc on the same inputs differ")
        del dq2, dc2
        errs = {"softmax_lse_fwd": (lse - want_lse).abs().max().item(),
                "softmax_lse_dq": grad_close(dq, want_dq, f"{label} dq"),
                "softmax_lse_dc": grad_close(dc, want_dc, f"{label} dc")}
        scales = {"softmax_lse_fwd": want_lse.abs().max().item(),
                  "softmax_lse_dq": want_dq.abs().max().item(),
                  "softmax_lse_dc": want_dc.abs().max().item()}
        if n_valid is not None and not (want_dc[n_valid:] == 0).all() & (dc[n_valid:] == 0).all():
            raise AssertionError(f"{label}: padded columns took a gradient")
        main_case = (bq, bk, n_valid, d) == (SOFTMAX_BATCH, SOFTMAX_BATCH, None, 64)
        if bq == bk and n_valid is None:
            squares[bk, d] = (lse, dq)
        if off:  # the stripe is rows [off, off + bq) of the square case
            square = squares[bk, d]
            # #9's column chunks follow BK alone (`fwd_chunks`), merged in chunk order
            if not bitwise_equal(lse, square[0][off:off + bq]):
                raise AssertionError(f"{label}: the stripe's lse differs from the square's rows")
            # the same p rows meet the same column chunks and tiles in the same order
            # (at D <= 128 `bwd_chunks` follows BK alone; wider, the same k order)
            if not bitwise_equal(dq, square[1][off:off + bq]):
                raise AssertionError(f"{label}: the stripe's dq rows differ from the square's")
        small = (bq + bk) * (d * 2 + 12)  # q and c in bf16; ids, adj, lse, g
        calls = {
            "softmax_lse_fwd": (lambda: sk.softmax_lse_fwd(*args),
                                lambda: sk.lse_forward_reference(*args),
                                bound(small + bq * 4, 2 * bq * bk * d, PEAK_BF16, bq * bk)),
            "softmax_lse_dq": (lambda: sk.softmax_lse_dq(*args, want_lse, g),
                               lambda: sk.lse_backward_reference(*args, want_lse, g,
                                                                 need_dc=False),
                               bound(small + bq * d * 4, 4 * bq * bk * d, PEAK_BF16, bq * bk)),
            "softmax_lse_dc": (lambda: sk.softmax_lse_dc(*args, want_lse, g),
                               lambda: sk.lse_backward_reference(*args, want_lse, g,
                                                                 need_dq=False),
                               bound(small + bk * d * 4, 4 * bq * bk * d, PEAK_BF16, bq * bk)),
        }
        for name, (kernel, plain, b) in calls.items():
            ms, plain_ms = median_ms(kernel, flush, reps), median_ms(plain, flush, reps)
            log(f"[kernel] {name} {label} D={d}: max_abs_err={errs[name]!r} "
                f"(x max|plain| {errs[name] / scales[name]!r}) kernel_ms={ms!r} "
                f"plain_ms={plain_ms!r} bound_ms={b['bound_ms']!r} by {b['bound_by']} "
                f"(share of the bound {b['bound_ms'] / ms!r}; n={reps}); no single PyTorch "
                "call computes it")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], errs[name])
            if main_case:  # the main path's shape: the train step's batch
                st.update(ms=ms, plain_ms=plain_ms, **b, library_ms=None)
            elif bq == bk and d > 64:
                st[f"D={d}"] = {"ms": ms, "plain_ms": plain_ms, **b}
        if main_case or (bq == bk and d in (256, 2048)):
            pos = torch.arange(bk, device=dev)
            for name, which, want in (("softmax_lse_dq", "dq", want_dq),
                                      ("softmax_lse_dc", "dc", want_dc)):
                comp = softmax_composed(*args, want_lse, g, which, pos)
                torch.cuda.synchronize()
                if not (torch.isfinite(comp).all() and comp.shape == want.shape):
                    raise AssertionError(f"softmax_composed {which}: not finite or of another "
                                         "shape")
                # its distance from the plain version, printed, not held: its scores are bf16
                comp_err = ((comp - want).abs().max() / want.abs().max()).item()
                composed_ms = median_ms(
                    lambda: softmax_composed(*args, want_lse, g, which, pos), flush, reps)
                row = stats[name] if main_case else stats[name][f"D={d}"]
                log(f"[kernel] {name} {label} D={d}: composed_ms={composed_ms!r} "
                    f"({SOFTMAX_COMPOSED_CALLS} PyTorch calls, 2 of them bf16 GEMMs; max abs "
                    f"diff from the plain version over its max: {comp_err!r}) against "
                    f"kernel_ms={row['ms']!r}")
                row["composed_ms"] = composed_ms
        if d > 128:
            key = f"{label} D={d}"
            wide[key] = softmax_wide_parts(dev, key, args, want_lse, g, (dq, dc),
                                           (want_dq, want_dc), flush, reps)
            stats["softmax_lse_p"]["max_abs_err"] = max(stats["softmax_lse_p"]["max_abs_err"],
                                                        wide[key]["p_max_abs_err"])
            if (bq, bk, d) == (SOFTMAX_BATCH, SOFTMAX_BATCH, 256):  # [train-softmax-wide]'s
                stats["softmax_lse_p"].update(wide[key]["p"])
    build_log = sk.softmax_lse_dq.load().log
    for line in ptxas_kernels(build_log, "lse_bwd_kernel"):  # <io, DP, OWN_Q>
        log(f"[kernel] #10 / #11 at D <= 128, lse_bwd_kernel{line}; {card_line()}")
    for line in ptxas_kernels(build_log, "lse_fwd_kernel"):  # <io, DP>
        log(f"[kernel] #9 at D <= 128, lse_fwd_kernel{line}; {card_line()}")
    for name in ("softmax_lse_dq", "softmax_lse_dc"):
        for dp in (64, 128):
            plan = getattr(sk, name).plan(dev, SOFTMAX_BATCH, dp)
            if plan["chunks"] != sk.bwd_chunks(SOFTMAX_BATCH):  # the kernel's rule is the wrapper's
                raise AssertionError(f"{name}: the kernel cuts {SOFTMAX_BATCH} streamed rows in "
                                     f"{plan['chunks']} chunks, bwd_chunks in "
                                     f"{sk.bwd_chunks(SOFTMAX_BATCH)}")
            log(f"[kernel] {name} at D={dp} over {SOFTMAX_BATCH} streamed rows: {plan!r} "
                f"({'chunk sums to a workspace, then a merge launch' if plan['chunks'] > 1 else 'one launch'}; "
                "no thread-block clusters)")
    for label, parts in wide.items():
        log(f"[kernel] the wide backward {label}: " + ", ".join(
            f"{k} {v!r}" for k, v in parts.items() if k != "p") + f"; {card_line()}")
    for name in names:
        wide = {k: stats[name].pop(k) for k in [k for k in stats[name] if k.startswith("D=")]}
        log(f"[kernel] {name} at wide D (squares): {wide!r}; {card_line()}")
    return stats


def reset_launches() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


def tower_fwd_launches(cfg, batch_sizes) -> int:
    """tower_fwd launches of two-tower forwards over batches of these sizes:
    under bf16 compute on the card each tower whose shapes pass the fused
    tower's gate (B % 512 == 0 at the flagship's widths) is one launch."""
    if cfg.compute_dtype != "bfloat16":
        return 0
    return 2 * sum(1 for n in batch_sizes if n % 512 == 0)


def timed_steps(train_step, state, pool, first: int, n: int):
    """`n` steps over the pool starting at batch `first`, each ended by a
    synchronize: (state, last out, per-step ms)."""
    times, out = [], None
    for i in range(first, first + n):
        t0 = time.perf_counter()
        state, out = train_step(state, pool[i % len(pool)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, out, times


def flagship_batches(dev: torch.device) -> tuple[list, list]:
    """The flagship's packed training pool and validation batches, on the
    card: sorted by user id, the label in the ids. One set serves every
    flagship BCE phase (the packing does not depend on the tables' storage)."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    t0 = time.perf_counter()
    pool = [map_leaves(feat(cols), lambda t: t.to(dev))  # the first POOL serve every eager phase
            for cols in ds.batches(TRAIN_BATCH, GRAPH_POOL, split="train")]
    val = [map_leaves(feat(cols), lambda t: t.to(dev))
           for cols in ds.batches(TRAIN_BATCH, 2, split="val")]
    log(f"[train] {GRAPH_POOL} training and {len(val)} validation batches of {TRAIN_BATCH} sampled, "
        f"packed and on the card in {time.perf_counter() - t0!r} s (before the counted steps)")
    return pool, val


def named_rows(cfg, pool, dev: torch.device) -> dict[str, torch.Tensor]:
    """Per table, the mask of rows that some batch of the pool names."""
    touched = {t.name: torch.zeros(t.num_embeddings, dtype=torch.bool, device=dev)
               for t in cfg.tables}
    for pb in pool:
        batch = unpack_batch(pb, cfg, pack_label=True)
        for fc in cfg.features:
            f = batch.features[fc.name]
            touched[fc.table][f.ids[f.mask > 0].long()] = True
    return touched


def phase_train(dev: torch.device, profile: bool, batches: tuple[list, list],
                table_dtype: str | None = None):
    """The flagship BCE training slice at full width, through the port's
    entry points, with f32 tables (`[train]`) or, under `table_dtype="int8"`,
    int8 tables (`[train-int8]`); the counted steps are the main path.
    Returns (launches, state, cfg)."""
    tag = "[train-int8]" if table_dtype == "int8" else "[train]"
    want = BCE_INT8 if table_dtype == "int8" else BCE_F32
    pool, val = batches
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, table_dtype=table_dtype)
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="bfloat16", loss="bce")
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                        pack_label=True)
    touched = named_rows(cfg, pool, dev)
    before = {name: [p.clone() for p in table_parts(t)] for name, t in state.model.tables.items()}
    before_f32 = {name: table_f32(t).clone() for name, t in state.model.tables.items()}

    state, _, _ = timed_steps(train_step, state, pool, 0, WARMUP_STEPS)
    # --- the main path, counted ---------------------------------------------------
    reset_launches()
    state, out, times = timed_steps(train_step, state, pool, WARMUP_STEPS, TRAIN_STEPS)
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    for name, n in launches.items():
        if n != want.get(name, 0) * TRAIN_STEPS:
            raise AssertionError(f"{tag} {name}: {n} launches in {TRAIN_STEPS} steps, "
                                 f"expected {want.get(name, 0)} a step")
    step_ms = statistics.median(times)
    loss = out["loss"].float().item()
    if not np.isfinite(loss):
        raise AssertionError(f"{tag} loss is not finite: {loss}")
    log(f"{tag} flagship bf16 step, {table_dtype or 'float32'} tables "
        f"{table_bytes(state.model)} bytes, batch {TRAIN_BATCH}: median_step_ms={step_ms!r} "
        f"min_step_ms={min(times)!r} examples_per_s={TRAIN_BATCH / step_ms * 1e3!r} "
        f"(n={TRAIN_STEPS}, after {WARMUP_STEPS} warm-up steps), loss={loss!r}, "
        f"launches per step: { {k: v // TRAIN_STEPS for k, v in launches.items() if v} }")
    for name, t in state.model.tables.items():
        if table_dtype == "int8" and not (isinstance(t, QuantizedTable)
                                          and t.values.dtype == torch.int8
                                          and t.scales.dtype == torch.float32
                                          and state.adagrad_acc[name].dtype == torch.float32):
            raise AssertionError(f"{tag} {name}: not an int8 table with f32 scales any more")
        keep = ~touched[name]
        for part, start in zip(table_parts(t), before[name]):
            if not bitwise_equal(part[keep], start[keep]):
                raise AssertionError(f"{tag} {name}: rows no batch named changed")
        moved = (table_f32(t) != before_f32[name]).any(dim=1).sum().item()
        log(f"{tag} {name}: {int(keep.sum())} untouched rows kept their bits; "
            f"{moved} of {int(touched[name].sum())} touched rows moved")
    # "auto" is on, on the card
    after = check_against_host(tag, state, dataclasses.replace(cfg, fused_tower_backward="on"),
                               tcfg, dense_opt, train_step, pool[0])
    if table_dtype == "int8":  # the margin the forward's tie repair moved, same steps
        with forward_without_tie_repair():
            before_repair = host_check_after(f"{tag} without the tie repair:", dev, cfg, tcfg,
                                             pool, strict=False)
        log(f"{tag} host-check margin (largest diff / bound) with the tie repair "
            f"{max(after.values())!r}, without {before_repair!r}")
    evaluate_card(tag, state, cfg, tcfg, val)
    if profile:
        profile_direct(lambda: train_step(state, pool[0]), f"{tag[1:-1]} step", 2, calls=5,
                       marker="quantized_gather" if table_dtype == "int8" else "pooled_gather")
    return launches, state, cfg


def phase_train_big_int8(dev: torch.device, pool: list) -> None:
    """Three steps with a 20,000,000-row int8 user table (2.56e9 int8
    elements: row offsets pass 2^31), initialized chunk by chunk. The
    flagship's batches with the user ids spread over the larger table."""
    cfg = cfg_lib.two_tower_model_config(BIG_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="bfloat16", loss="bce")
    small = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                           layer_sizes=LAYERS)
    t0 = time.perf_counter()
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    user_feature = cfg.query_tower.features[0]
    user_table = cfg.feature(user_feature).table
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    big_pool = []
    for pb in pool[:3]:  # the same interactions, user u -> 96 u (below 20,000,000)
        batch = unpack_batch(pb, small, pack_label=True)
        cols = {fc.name: batch.features[fc.name].ids[:, 0].cpu().numpy().astype(np.int64)
                for fc in small.features}
        cols[user_feature] = cols[user_feature] * 96
        cols["label"] = batch.labels.cpu().numpy().astype(np.int64)
        big_pool.append(map_leaves(feat(cols), lambda t: t.to(dev)))
    table = state.model.tables[user_table]
    named = named_rows(cfg, big_pool, dev)[user_table]
    # a named row past 2^24 whose upper neighbour no batch names
    cand = torch.nonzero(named[:-1] & ~named[1:]).flatten()
    row = int(cand[cand > HIGH_ROW][-1])
    before = table.values[row:row + 2].clone(), table.scales[row:row + 2].clone()
    train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                        pack_label=True)
    made = read_launches()
    state, out, times = timed_steps(train_step, state, big_pool, 0, 3)
    made = {k: v - made[k] for k, v in read_launches().items() if v - made[k]}
    loss = out["loss"].float().item()
    if not np.isfinite(loss):
        raise AssertionError(f"[train-int8] 20M-row table: loss is not finite: {loss}")
    if made != {k: 3 * v for k, v in BCE_INT8.items()}:
        raise AssertionError(f"[train-int8] 20M-row table: launches {made}")
    after = table.values[row:row + 2], table.scales[row:row + 2]
    if torch.equal(after[0][0], before[0][0]):
        raise AssertionError(f"[train-int8] 20M-row table: named row {row} did not change")
    if not (torch.equal(after[0][1], before[0][1]) and bitwise_equal(after[1][1:], before[1][1:])):
        raise AssertionError(f"[train-int8] 20M-row table: unnamed row {row + 1} changed")
    log(f"[train-int8] {BIG_USERS}-row int8 user table ({table_bytes(state.model)} bytes, "
        f"{table.values.numel()} int8 elements), created in {init_s!r} s: 3 steps, "
        f"step_ms={times!r}, loss={loss!r}, launches {made}; named row {row} (> {HIGH_ROW}) changed, "
        f"its unnamed neighbour kept its bytes and scale")


def sorted_first(update):
    """An update that needs non-decreasing ids, behind a stable device sort."""
    def upd(table, acc, fids, fgrads, lr, eps):
        sids, perm = torch.sort(fids, stable=True)
        return update(table, acc, sids, fgrads[perm], lr, eps)
    return upd


def phase_train_override(dev: torch.device, pool: list) -> dict[str, int]:
    """The f32 flagship in f32 compute: from one state, three steps with the
    default update (kernel #4), three with `sparse_update=
    block_sorted_rowwise_adagrad` (the dense aggregate, kernel #3) and three
    with `sparse_update=pallas_sparse_rowwise_adagrad` (the row subtract,
    kernel #7). The routes sum a row's gradients in different orders, which
    moves its update (about the learning rate, 0.05, a step while the
    accumulators are young) by 1e-6 of itself, whatever is left of the element
    after the update: after the first step, which every route takes from the
    same state, all tables and accumulators agree within rtol 1e-5 / atol
    1e-6. From the second step on those 1e-7 differences feed back through
    the towers, where a ReLU whose pre-activation lies within them of zero
    opens in one route and stays shut in another; that changes the gradient
    of the rows of that example by a finite amount. So the end states after
    three steps are held to the same tolerance on all but at most 1 row in
    10,000, and the rows outside it are counted and printed. The counted
    steps of the two overrides are the main path of #3 and #7."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="float32", loss="bce")
    base, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                  cfg, tcfg)
    routes = {  # name -> (sparse_update, the kernel each step launches twice)
        "default": (None, "rowwise_adagrad"),
        # the dense aggregate needs sorted ids; the item table's arrive unsorted
        "block_sorted_rowwise_adagrad": (sorted_first(opt_lib.block_sorted_rowwise_adagrad),
                                         "block_sorted_aggregate"),
        "pallas_sparse_rowwise_adagrad": (opt_lib.pallas_sparse_rowwise_adagrad, "row_subtract"),
    }
    update_kernels = {kernel for _, kernel in routes.values()}
    total = {name: 0 for name in KERNELS}
    ends, firsts = {}, {}

    def tables_and_accs(state):
        return {**{n: t.detach().clone() for n, t in state.model.tables.items()},
                **{f"{n} accumulator": a.clone() for n, a in state.adagrad_acc.items()}}

    for name, (sparse_update, kernel) in routes.items():
        state = base.copy()
        train_step = make_packed_train_step(
            step_lib.make_train_step(cfg, tcfg, dense_opt, sparse_update=sparse_update), cfg,
            pack_label=True)
        # --- the main path of #3 and #7, counted -----------------------------------
        reset_launches()
        state, _, first_time = timed_steps(train_step, state, pool, 0, 1)
        firsts[name] = tables_and_accs(state)  # device copies: no kernel of the count
        state, out, times = timed_steps(train_step, state, pool, 1, OVERRIDE_STEPS - 1)
        times = first_time + times
        launches = read_launches()
        # --- checks, not counted ----------------------------------------------------
        for k in update_kernels:
            if launches[k] != (2 * OVERRIDE_STEPS if k == kernel else 0):
                raise AssertionError(f"[train-override] {name}: {k} launched {launches[k]} times "
                                     f"in {OVERRIDE_STEPS} steps")
        if not np.isfinite(out["loss"].item()):
            raise AssertionError(f"[train-override] {name}: loss is not finite")
        for k, v in launches.items():
            total[k] += v
        ends[name] = state
        log(f"[train-override] {name}: f32 flagship, batch {TRAIN_BATCH}, {OVERRIDE_STEPS} steps, "
            f"step_ms={times!r} (median {statistics.median(times)!r}), loss={out['loss'].item()!r}, "
            f"launches { {k: v for k, v in launches.items() if v} }")
    outside = {}
    for name in routes:
        for tname, want in firsts["default"].items():  # one step from the same state: all rows
            torch.testing.assert_close(firsts[name][tname], want, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{name} {tname} after one step: {m}")
        for tname, want in tables_and_accs(ends["default"]).items():
            got = tables_and_accs(ends[name])[tname]
            off = (got - want).abs() > 1e-6 + 1e-5 * want.abs()
            rows = int(off.reshape(off.shape[0], -1).any(dim=1).sum())
            if rows > off.shape[0] * 1e-4:
                raise AssertionError(f"[train-override] {name} {tname}: {rows} of {off.shape[0]} "
                                     f"rows outside rtol 1e-5 / atol 1e-6 after {OVERRIDE_STEPS} "
                                     f"steps (max abs diff {(got - want).abs().max().item()!r})")
            if rows:
                outside[f"{name} {tname}"] = rows
    log("[train-override] the three routes' tables and accumulators agree within rtol 1e-5 / "
        f"atol 1e-6 on every row after one step, and after {OVERRIDE_STEPS} steps on all rows "
        f"but these (ReLU gates that opened in one route only; at most 1 row in 10,000 "
        f"allowed): {outside!r}")
    return total


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a train state, by name: tables (an int8 table's values
    and scales), accumulators, towers, Adam's moments and counts, item
    counts."""
    out = {}
    for name, t in state.model.tables.items():
        for part, label in zip(table_parts(t), ("", ".scales")):
            out[name + label] = part
        out[name + ".acc"] = state.adagrad_acc[name]
    for i, p in enumerate(step_lib.tower_parameters(state.model)):
        out[f"tower{i}"] = p.detach()
        for key, v in state.dense_opt_state.state[p].items():
            out[f"tower{i}.{key}"] = v
    if state.item_counts is not None:
        out["item_counts"] = state.item_counts
    return out


def compare_states(label: str, eager, graphed) -> str:
    """The replayed state against the eager one, tensor by tensor: bit for
    bit, else within rtol 1e-5 / atol 1e-6 (a library product that took
    another algorithm under capture would show at that level), else fail."""
    torch.cuda.synchronize()
    a, b = state_tensors(eager), state_tensors(graphed)
    if a.keys() != b.keys() or eager.step != graphed.step:
        raise AssertionError(f"{label}: states differ in shape: steps {eager.step}, "
                             f"{graphed.step}")
    differ = {}
    for name in a:
        if not bitwise_equal(a[name], b[name]):
            torch.testing.assert_close(b[name].float(), a[name].float(), rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{label} {name}: {m}")
            differ[name] = (a[name].float() - b[name].float()).abs().max().item()
    if differ:
        return f"within rtol 1e-5 / atol 1e-6, not bitwise: max abs diffs {differ!r}"
    return f"bit for bit equal ({len(a)} tensors)"


def stack_on_card(batches: list):
    """K packed batches on the card as one macro-batch: a leading axis K on
    every leaf."""
    first = batches[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first) if getattr(first, f.name) is not None})


def phase_train_graph(dev: torch.device, name: str, cfg, tcfg, pool: list, want: dict,
                      profile: bool, marker: str = "pooled_gather",
                      tag: str = "[train-graph]") -> dict[str, int]:
    """K = 16 train steps as one CUDA graph (`make_multi_step`) against eager
    steps, from two copies of one fresh state. The first multi-step call
    (warm-up on a copy, capture, first replay) is the main path and is
    counted: a replay launches nothing from Python, so the count is the
    warm-up's and the capture's launches. Under --profile, a replay's device
    time and #4's device ms a step."""
    label = f"{tag[1:-1]} {name}"  # the profile's
    tag, k = f"{tag} {name}:", GRAPH_K
    batch_size = pool[0].batch_size
    base, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                  cfg, tcfg)
    step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                  pack_label=True)
    multi = step_lib.make_multi_step(step)

    def macro(j):  # rotations of the pool: distinct payloads for j < len(pool)
        return [pool[(j + i) % len(pool)] for i in range(k)]

    def eager_steps(state, batches):
        losses, times = [], []
        for pb in batches:
            t0 = time.perf_counter()
            state, out = step(state, pb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(out["loss"].float())
        return state, torch.stack(losses), times

    eager, graphed = base.copy(), base.copy()
    start = {n_: t.clone() for n_, t in state_tensors(base).items()}
    del base
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager, losses_e, times_e = eager_steps(eager, macro(0))
    peak_eager = torch.cuda.max_memory_allocated()
    # --- the main path, counted: warm-up on a copy, capture, first replay ---------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    graphed, out_g = multi(graphed, stack_on_card(macro(0)))
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ----------------------------------------------------------
    calls = k + step_lib.WARMUP_STEPS
    for kernel, n in launches.items():
        if n != want.get(kernel, 0) * calls:
            raise AssertionError(f"{tag} {kernel}: {n} launches for {step_lib.WARMUP_STEPS} "
                                 f"warm-up and {k} captured steps, expected "
                                 f"{want.get(kernel, 0)} a step")
    if (multi.captures, multi.replays) != (1, 1) or graphed.step != k:
        raise AssertionError(f"{tag} captures {multi.captures}, replays {multi.replays}, step "
                             f"{graphed.step}")
    if not bitwise_equal(out_g["loss"], losses_e) or not torch.isfinite(losses_e).all():
        raise AssertionError(f"{tag} the {k} losses differ: {out_g['loss']} != {losses_e}")
    first = compare_states(f"{tag} after {k} steps", eager, graphed)
    # a second macro of another payload: a replay that read a stale buffer would repeat the first
    after_one = {n_: t.clone() for n_, t in state_tensors(graphed).items()}
    eager, losses_e2, times_e2 = eager_steps(eager, macro(1))
    graphed, out_g2 = multi(graphed, stack_on_card(macro(1)))
    peak_graph = torch.cuda.max_memory_allocated()
    second = compare_states(f"{tag} after {2 * k} steps", eager, graphed)
    now = state_tensors(graphed)
    moved = [n_ for n_ in now if not bitwise_equal(now[n_], after_one[n_])]
    if not bitwise_equal(out_g2["loss"], losses_e2) or bitwise_equal(out_g2["loss"], out_g["loss"]):
        raise AssertionError(f"{tag} the second macro's losses: {out_g2['loss']}")
    if len(moved) < len(now) - 1 or any(bitwise_equal(after_one[n_], start[n_]) for n_ in moved):
        raise AssertionError(f"{tag} the second replay moved only {moved}")
    if not bitwise_equal(out_g["loss"], losses_e):  # the first losses are a copy, not the buffer
        raise AssertionError(f"{tag} the second replay overwrote the first macro's losses")
    if graphed.item_counts is not None:
        counted = graphed.item_counts.sum().item()
        if counted != 2 * k * batch_size:
            raise AssertionError(f"{tag} item_counts sums to {counted}")
    if multi.captures != 1:
        raise AssertionError(f"{tag} a second payload captured anew ({multi.captures})")
    # --- times: replays over distinct payloads; eager steps with and without a sync each ---
    replay_ms = []
    for j in range(2, 2 + GRAPH_MACROS):
        stacked = stack_on_card(macro(j))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed, out = multi(graphed, stacked)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3 / k)
    unsynced_ms = []
    for j in range(2, 2 + GRAPH_MACROS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pb in macro(j):
            eager, _ = step(eager, pb)
        torch.cuda.synchronize()
        unsynced_ms.append((time.perf_counter() - t0) * 1e3 / k)
    eager_ms = statistics.median(times_e + times_e2)
    graph_ms = statistics.median(replay_ms)
    log(f"{tag} batch {batch_size}, K={k}: end states after {k} steps {first}; after {2 * k} "
        f"steps (a second payload) {second}; {k} losses bitwise equal; eager median_step_ms="
        f"{eager_ms!r} (a sync after each, n={2 * k}), eager_ms_per_step_one_sync_per_{k}="
        f"{statistics.median(unsynced_ms)!r} (n={GRAPH_MACROS}), replayed_ms_per_step={graph_ms!r} "
        f"(min {min(replay_ms)!r}, n={GRAPH_MACROS} macros of distinct payloads, payload copy "
        f"and rate upload included), examples_per_s={batch_size / graph_ms * 1e3!r}; launches "
        f"captured per step { {k_: v // calls for k_, v in launches.items() if v} }, "
        f"captures={multi.captures} replays={multi.replays}; first call (warm-up on a copy, "
        f"capture, replay) {first_call_s!r} s; peak_memory_gb eager={peak_eager / 1e9!r} "
        f"graph={peak_graph / 1e9!r} (both states resident in both)")
    if profile:
        stacked = stack_on_card(macro(0))
        log_clocks(f"[profile] {label}", lambda: multi(graphed, stacked), SAMPLED_MACROS)
        device_ms = profile_direct(lambda: multi(graphed, stacked), f"{label}, replay of {k} steps",
                                   2 * k, calls=3, marker=marker)
        adagrad = [v for name, v in device_ms.items() if is_rowwise_adagrad(name)]
        log(f"{tag} rowwise_adagrad device ms a replayed step: " + (
            f"{sum(v[0] for v in adagrad) / k!r} in {sum(v[1] for v in adagrad) / k!r} launches "
            "(all passes, all tables)" if adagrad else "none in the trace"))
        quantized = [v for name, v in device_ms.items() if "QuantizedUpdate" in name]
        if quantized:  # #6: both passes of the walk with its epilogue, all tables
            log(f"{tag} quantized_rowwise_adagrad device ms a replayed step: "
                f"{sum(v[0] for v in quantized) / k!r} in {sum(v[1] for v in quantized) / k!r} "
                "launches (all passes, all tables)")
        log_gather_ms(tag, device_ms, marker, per=k)
        if "softmax" in name:
            log_softmax_bwd_ms(tag, device_ms, per=k)
    return launches


def log_softmax_bwd_ms(label: str, device_ms: dict[str, list], per: int) -> None:
    """#10's and #11's device ms and launches a replayed step in a profile of
    `profile_direct`: at D <= 128 `lse_bwd_kernel<DP, OWN_Q>` (OWN_Q true for
    #10, false for #11) and their chunks' merge launches, at a wide D the p
    kernel and the products."""
    def ms_of(test):
        items = [v for name, v in device_ms.items() if test(name)]
        return f"{sum(v[0] for v in items) / per!r} in {sum(v[1] for v in items) / per!r} launches"

    log(f"{label} #10 device ms a replayed step: "
        f"{ms_of(lambda n: 'lse_bwd_kernel<' in n and 'true>' in n)}; #11: "
        f"{ms_of(lambda n: 'lse_bwd_kernel<' in n and 'false>' in n)}; their merges: "
        f"{ms_of(lambda n: 'lse_bwd_merge_kernel' in n)}; #9: "
        f"{ms_of(lambda n: 'lse_fwd_kernel<' in n)}, its merge "
        f"{ms_of(lambda n: 'lse_merge_kernel' in n)}")


def log_gather_ms(label: str, device_ms: dict[str, list], marker: str, per: int = 1) -> None:
    """The device ms and launches of the gather kernel whose name holds
    `marker` (`pooled_gather` #1, `quantized_gather` #5) in a profile of
    `profile_direct`, per call divided by `per` (the steps of a replay)."""
    items = [v for name, v in device_ms.items() if marker in name]
    log(f"{label} {marker} device ms {'a replayed step' if per > 1 else 'a call'}: "
        f"{sum(v[0] for v in items) / per!r} in {sum(v[1] for v in items) / per!r} launches")


def is_rowwise_adagrad(kernel_name: str) -> bool:
    """Whether a traced kernel is #4's: either pass of the span walk with the
    `AdagradUpdate` epilogue (#3 and #6 run the same templates with their own
    epilogues), or `rowwise_adagrad_kernel`, the one-pass kernel that
    csrc/rowwise_adagrad.cu held before it moved onto the walk (so a run of
    this script over that code reads the same number)."""
    return "AdagradUpdate" in kernel_name or "rowwise_adagrad_kernel" in kernel_name


SMI_CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
              "--format=csv,noheader"]
SAMPLED_MACROS = 20  # graph replays under the clock sampler


def log_clocks(label: str, fn, calls: int, period_ms: int = 20) -> None:
    """The SM clock and the active throttle reasons (nvidia-smi) before `calls`
    calls of `fn`, every `period_ms` while they run, and after: printed, not
    held. The sampler is a process of its own, stopped before this returns."""
    def query() -> str:
        out = subprocess.run(SMI_CLOCKS, capture_output=True, text=True, timeout=60)
        return (out.stdout + out.stderr).strip()

    before = query()
    sampler = subprocess.Popen([*SMI_CLOCKS, f"--loop-ms={period_ms}"], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        during = [sampler.stdout.readline().strip()]  # the sampler is up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        sampler.terminate()
        during += sampler.communicate(timeout=60)[0].strip().splitlines()
    seen = {line: during.count(line) for line in dict.fromkeys(during)}  # in order, counted
    log(f"{label}: clocks.sm, throttle reasons before: {before}; during {calls} replays "
        f"({ms!r} ms, every {period_ms} ms; samples counted): {seen}; after: {query()}")


def phase_train_graphs(dev: torch.device, profile: bool, pool: list) -> dict[str, dict]:
    """`[train-graph]` for the flagship training paths: BCE at batch 262,144
    in bf16 compute with f32, int8 and bf16 tables (the flagship pool; bf16
    tables take no block kernel), and the sampled softmax at batch 8,192 in
    f32 and in bf16 compute."""
    bce, bce_tcfg = flagship_bce()
    paths = {
        "train-graph": phase_train_graph(dev, "BCE, f32 tables, bf16 compute", bce, bce_tcfg,
                                         pool, BCE_F32, profile),
        "train-graph-int8": phase_train_graph(
            dev, "BCE, int8 tables, bf16 compute", dataclasses.replace(bce, table_dtype="int8"),
            bce_tcfg, pool, BCE_INT8, profile, marker="quantized_gather"),
        "train-graph-bf16tab": phase_train_graph(
            dev, "BCE, bf16 tables, bf16 compute", dataclasses.replace(bce, table_dtype="bfloat16"),
            dataclasses.replace(bce_tcfg, block_sorted_kernel="off"), pool, BCE_F32,
            profile),
    }
    soft = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                          layer_sizes=LAYERS)
    soft_tcfg = cfg_lib.TrainConfig(batch_size=SOFTMAX_BATCH, sorted_feature="user_id",
                                    block_sorted_kernel="float32", loss="sampled_softmax",
                                    softmax_kernel="on")
    feat = PackedFeaturizer(soft, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    soft_pool = [map_leaves(feat(cols), lambda t: t.to(dev))
                 for cols in ds.batches(SOFTMAX_BATCH, GRAPH_POOL, "train")]
    paths["train-graph-softmax"] = phase_train_graph(
        dev, "sampled softmax + logQ, f32 tables, f32 compute", soft, soft_tcfg, soft_pool,
        SOFTMAX_F32, profile)
    paths["train-graph-softmax-bf16"] = phase_train_graph(
        dev, "sampled softmax + logQ, f32 tables, bf16 compute",
        dataclasses.replace(soft, compute_dtype="bfloat16"), soft_tcfg, soft_pool,
        SOFTMAX_BF16, profile)
    return paths


def flagship_bce():
    """The flagship BCE training configuration: bf16 compute, f32 tables,
    batch 262,144 sorted by user id, the block kernels in bf16."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS, compute_dtype="bfloat16")
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="bfloat16", loss="bce")
    return cfg, tcfg


def batch_tensors(batch) -> list[torch.Tensor]:
    """A decoded `Batch`'s labels, then each feature's ids and mask."""
    out = [batch.labels]
    for name in sorted(batch.features):
        out += [batch.features[name].ids, batch.features[name].mask]
    return out


def same_batch(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(batch_tensors(a), batch_tensors(b)))


def host_bytes(batch) -> int:
    """The bytes of a flat batch's array fields (numpy arrays or tensors)."""
    leaves = (getattr(batch, f.name) for f in dataclasses.fields(batch))
    return sum(leaf.nbytes for leaf in leaves if leaf is not None)


def graph_ms(fn) -> float:
    """Median device ms of one replay of `fn` captured alone into a CUDA
    graph (no launch gaps, no host), over REPS replays timed with events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_train_compact(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-compact]`: the flagship BCE step of `[train-graph]` (f32
    tables, bf16 compute, batch 262,144 sorted by user id) fed the compact
    wire (`data/compact.py`, the user slot delta-encoded): K = 16 steps as
    one CUDA graph over CompactBatch payloads, beside the same batches as
    PackedBatch payloads through another graph, from two copies of one
    state, for 2 macros: the end states bit for bit equal. Before that the
    decode on the card against `unpack_batch`, bit for bit, with and without
    the delta slot and on a batch whose sidecar holds exceptions. The main
    path (counted) is the compact graph's first call (warm-up and capture).
    Printed beside the card line: the payload bytes a step (from the scheme,
    and the host arrays'), the replayed ms a step of both payloads, a
    macro's host-to-device copy ms from pinned memory, and the decode's
    device ms a step (the decode alone in a graph, beside `unpack_batch`'s)
    and its share of the replayed step."""
    tag, k = "[train-compact]", GRAPH_K
    cfg, tcfg = flagship_bce()
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    pbs = [feat(cols) for cols in ds.batches(TRAIN_BATCH, GRAPH_POOL, split="train")]
    scheme = CompactScheme.from_model(cfg, pack_label=True, delta_feature="user_id")
    cbs = [compact_from_packed(pb, scheme) for pb in pbs]

    def on_card(batch):
        return map_leaves(batch, lambda t: t.to(dev))

    # --- the decode on the card, bit for bit unpack_batch's ------------------------------
    rng = np.random.default_rng(12)
    sparse = feat({"user_id": rng.integers(1, NUM_USERS, 512),
                   "product_id": rng.integers(1, NUM_ITEMS, 512), "label": rng.integers(0, 2, 512)})
    no_delta = CompactScheme.from_model(cfg, pack_label=True)
    decode_cases = [("delta slot", scheme, pb) for pb in pbs[:2]] + [
        ("no delta slot", no_delta, pbs[0]), ("delta slot, sparse users", scheme, sparse)]
    for label, sch, pb in decode_cases:
        cb = compact_from_packed(pb, sch)
        got = batch_from_compact(on_card(cb), cfg, sch)
        if not same_batch(got, unpack_batch(on_card(pb), cfg, pack_label=True)):
            raise AssertionError(f"{tag} decode ({label}) differs from unpack_batch")
    exceptions = int((compact_from_packed(sparse, scheme).delta_extra > 0).sum())
    if exceptions < 100:
        raise AssertionError(f"{tag} the sparse batch holds {exceptions} delta exceptions")
    log(f"{tag} the decode on the card equals unpack_batch bit for bit (ids, masks, labels): "
        f"the user slot delta-encoded ({len(pbs[:2])} batches of {TRAIN_BATCH}), not delta-"
        f"encoded, and a batch of 512 users spread over the table ({exceptions} deltas > 255 "
        f"in the sidecar)")
    wire_step = scheme.wire_bytes_per_example * TRAIN_BATCH + 8 * scheme.delta_capacity
    if host_bytes(cbs[0]) != wire_step:
        raise AssertionError(f"{tag} a compact batch holds {host_bytes(cbs[0])} bytes, the scheme "
                             f"says {wire_step}")

    # --- graphs of the two payloads from two copies of one state ------------------------
    base, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                  cfg, tcfg)
    core = step_lib.make_train_step(cfg, tcfg, dense_opt)
    multis = {"packed": step_lib.make_multi_step(make_packed_train_step(core, cfg,
                                                                        pack_label=True)),
              "compact": step_lib.make_multi_step(make_compact_train_step(core, cfg, scheme))}
    hosts = {"packed": pbs, "compact": cbs}

    def macro(kind, j, pinned=False):
        stacked = step_lib.stack_batches([hosts[kind][(j + i) % len(pbs)] for i in range(k)])
        moved = map_leaves(stacked, lambda t: t.pin_memory() if pinned else t.to(dev))
        return moved

    states = {"packed": base.copy(), "compact": base.copy()}
    del base
    payloads = {kind: [macro(kind, j) for j in range(2 + GRAPH_MACROS)] for kind in hosts}
    torch.cuda.synchronize()
    # --- the main path, counted: the compact graph's warm-up, capture and first replay ----
    reset_launches()
    states["compact"], out_c = multis["compact"](states["compact"], payloads["compact"][0])
    torch.cuda.synchronize()
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------------
    calls = k + step_lib.WARMUP_STEPS
    for kernel, n in launches.items():
        if n != BCE_F32.get(kernel, 0) * calls:
            raise AssertionError(f"{tag} {kernel}: {n} launches in {calls} steps, expected "
                                 f"{BCE_F32.get(kernel, 0)} a step")
    states["packed"], out_p = multis["packed"](states["packed"], payloads["packed"][0])
    for kind in hosts:
        states[kind], _ = multis[kind](states[kind], payloads[kind][1])
    verdict = compare_states(f"{tag} after {2 * k} steps", states["packed"], states["compact"])
    if not verdict.startswith("bit for bit") or not bitwise_equal(out_c["loss"], out_p["loss"]):
        raise AssertionError(f"{tag} the compact-fed graph is not the packed-fed one bit for "
                             f"bit: {verdict}")
    # --- times ------------------------------------------------------------------------------
    replayed = {}
    for kind in hosts:
        times = []
        for j in range(2, 2 + GRAPH_MACROS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[kind], _ = multis[kind](states[kind], payloads[kind][j])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / k)
        replayed[kind] = statistics.median(times)
    h2d = {}
    for kind in hosts:
        pinned = macro(kind, 0, pinned=True)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            map_leaves(pinned, lambda t: t.to(dev, non_blocking=True))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        h2d[kind] = (statistics.median(times), host_bytes(pinned))
    one_c, one_p = on_card(cbs[0]), on_card(pbs[0])
    decode_ms = graph_ms(lambda: batch_from_compact(one_c, cfg, scheme))
    unpack_ms = graph_ms(lambda: unpack_batch(one_p, cfg, pack_label=True))
    card = card_line()
    log(f"{tag} {card}: batch {TRAIN_BATCH}, K={k}: end states after {2 * k} steps of the "
        f"compact-fed graph against the packed-fed one {verdict}; payload bytes a step "
        f"compact {wire_step} ({scheme.wire_bytes_per_example} B an example + a sidecar of "
        f"8 x {scheme.delta_capacity} B) against packed {host_bytes(pbs[0])} (8 B an example); "
        f"replayed_ms_per_step compact={replayed['compact']!r} packed={replayed['packed']!r} "
        f"(n={GRAPH_MACROS} macros of distinct payloads on the card, payload copy included); "
        f"a macro's host-to-device copy from pinned memory: compact {h2d['compact'][0]!r} ms for "
        f"{h2d['compact'][1]} B, packed {h2d['packed'][0]!r} ms for {h2d['packed'][1]} B; "
        f"decode device ms a step {decode_ms!r} (unpack_batch {unpack_ms!r}; the decode alone "
        f"in a graph, n={REPS}), {decode_ms / replayed['compact']!r} of the replayed step; "
        f"launches captured per step { {k_: v // calls for k_, v in launches.items() if v} }, "
        f"captures={multis['compact'].captures} replays={multis['compact'].replays}")
    if profile:
        profile_direct(lambda: multis["compact"](states["compact"], payloads["compact"][0]),
                       f"train-compact replay of {k} steps", 2 * k, calls=3)
    return launches


def phase_train_skew(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-skew]`: the flagship BCE step (f32 tables, bf16 compute) on a
    heavy-tailed catalogue: items drawn as rank^-1
    (`SyntheticClickstream(popularity=1.0)`), so each batch holds item runs of
    thousands of positions, which the item table's update (#4, through the
    device sort) takes in pieces. `phase_train_graph`'s K = 16 graph against
    eager steps over GRAPH_POOL such batches; then, as `[train]` checks its
    state, a fresh state's WARMUP_STEPS + TRAIN_STEPS eager steps over the
    same batches and one more step against the host CPU; under --profile,
    #4's device ms a replayed step."""
    cfg, tcfg = flagship_bce()
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0, popularity=1.0)
    t0 = time.perf_counter()
    pool, longest = [], []
    for cols in ds.batches(TRAIN_BATCH, GRAPH_POOL, split="train"):
        longest.append(int(np.unique(cols["product_id"], return_counts=True)[1].max()))
        pool.append(map_leaves(feat(cols), lambda t: t.to(dev)))
    log(f"[train-skew] {GRAPH_POOL} batches of {TRAIN_BATCH}, items drawn as rank^-1, sampled, "
        f"packed and on the card in {time.perf_counter() - t0!r} s; longest item run of each "
        f"batch: {longest}")
    launches = phase_train_graph(dev, "BCE, f32 tables, bf16 compute, rank^-1 items", cfg, tcfg,
                                 pool, BCE_F32, profile, tag="[train-skew]")
    margins = {}
    for repaired in (True, False):
        with contextlib.nullcontext() if repaired else forward_without_tie_repair():
            margins[repaired] = host_check_after(
                "[train-skew]" if repaired else "[train-skew] without the tie repair:", dev, cfg,
                tcfg, pool, strict=repaired, replayed_steps=SKEW_REPLAYED_STEPS)
    log(f"[train-skew] host-check margins (largest diff / bound) with the tie repair "
        f"{margins[True]!r}, without {margins[False]!r}")
    return launches


SKEW_REPLAYED_STEPS = 560  # 35 replays of a 16-step graph over the 6 skewed batches


def host_check_after(tag, dev, cfg, tcfg, pool, strict=True, replayed_steps=0) -> dict:
    """`check_against_host` on a fresh state after WARMUP_STEPS +
    TRAIN_STEPS eager steps over `pool`, and, with `replayed_steps`, on a
    fresh state after that many steps replayed as GRAPH_K-step graphs over
    rotations of the pool; each fails over its bound when `strict`. Returns
    each check's largest margin (diff / bound)."""
    out = {}
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                        pack_label=True)
    state, _, _ = timed_steps(train_step, state, pool, 0, WARMUP_STEPS + TRAIN_STEPS)
    host_cfg = dataclasses.replace(cfg, fused_tower_backward="on")  # "auto" is on, on the card
    eager = check_against_host(f"{tag} after {WARMUP_STEPS + TRAIN_STEPS} eager steps", state,
                               host_cfg, tcfg, dense_opt, train_step, pool[0], strict)
    out[f"{WARMUP_STEPS + TRAIN_STEPS} eager steps"] = max(eager.values())
    if replayed_steps:
        del state
        state, dense_opt = step_lib.create_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, tcfg)
        train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                            pack_label=True)
        multi = step_lib.make_multi_step(train_step)
        macros = [stack_on_card([pool[(j + i) % len(pool)] for i in range(GRAPH_K)])
                  for j in range(len(pool))]
        for j in range(replayed_steps // GRAPH_K):
            state, _ = multi(state, macros[j % len(macros)])
        replayed = check_against_host(f"{tag} after {state.step} replayed steps", state, host_cfg,
                                      tcfg, dense_opt, train_step, pool[0], strict)
        out[f"{state.step} replayed steps"] = max(replayed.values())
        del macros
    return out


def phase_learn_packed(dev: torch.device) -> dict[str, int]:
    """The verify drive through the packed macro-step epoch on the card:
    `train_one_epoch_packed` as `train_val_test`'s epoch, macro 8 (one CUDA
    graph, replayed), 125 batches an epoch (15 macros and a tail of 5 through
    `tail_step`), mid-epoch validation every 50 steps."""
    macro, per_epoch, batch = 8, 125, 1024
    mcfg = cfg_lib.two_tower_model_config(2000, 500, embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg, query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg_lib.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                               limit_val_batches=4, limit_test_batches=4, validation_freq=50)
    ds = SyntheticClickstream(2000, 500, seed=11, noise=0.05, latent_dim=4)
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   mcfg, tcfg)
    core = step_lib.make_train_step(mcfg, tcfg, dense_opt)
    multi = step_lib.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    tail_step = make_packed_train_step(core, mcfg)
    eval_step = step_lib.make_eval_step(mcfg, tcfg)
    feat, packed = Featurizer(mcfg, device="cpu"), PackedFeaturizer(mcfg)
    epochs, mid = [], []

    class Recorder:
        def log_metrics(self, metrics, step=None):
            if "epoch" not in metrics and "val_auroc" in metrics and step:
                mid.append(step)

    def packed_epoch(state, epoch):
        state, stats = train_one_epoch_packed(
            state, multi, ds.batches(batch, per_epoch, split=f"t{epoch}"), packed, macro=macro,
            train_cfg=tcfg, tail_step=tail_step, eval_step=eval_step,
            val_batches_factory=lambda: ds.batches(batch, 4, split="val"), val_featurizer=feat,
            logger=Recorder(), epoch=epoch)
        epochs.append(stats)
        return state, stats

    # --- the path, counted ---------------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    state, res = train_val_test(
        state, None, eval_step, mcfg, tcfg, feat, train_batches_factory=None,
        val_batches_factory=lambda: ds.batches(batch, 4, split="val"),
        test_batches_factory=lambda: ds.batches(batch, 4, split="test"),
        train_epoch_fn=packed_epoch)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    for stats in epochs:
        if (stats["train_steps"], stats["train_examples"]) != (per_epoch, per_epoch * batch):
            raise AssertionError(f"[learn-packed] an epoch counted {stats}")
    macros = per_epoch // macro
    if (multi.captures, multi.replays) != (1, 2 * macros) or state.step != 2 * per_epoch:
        raise AssertionError(f"[learn-packed] captures {multi.captures}, replays {multi.replays}, "
                             f"step {state.step}")
    # a validation at the first macro boundary at or past 50 and 100, in both epochs
    want_mid = [56, 104, per_epoch + 56, per_epoch + 104]
    if mid != want_mid:
        raise AssertionError(f"[learn-packed] mid-epoch validations at steps {mid}, expected "
                             f"{want_mid}")
    if not 0.45 <= res["baseline_val_auroc"] <= 0.55:
        raise AssertionError(f"[learn-packed] baseline val AUROC {res['baseline_val_auroc']} "
                             "outside 0.45-0.55")
    if res["val_auroc"] < 0.70:
        raise AssertionError(f"[learn-packed] final val AUROC {res['val_auroc']} < 0.70")
    if {k for k, v in launches.items() if v} != {"pooled_gather", "rowwise_adagrad"}:
        raise AssertionError(f"[learn-packed] the path did not go through its kernels alone: "
                             f"{launches}")
    log(f"[learn-packed] macro={macro}, {per_epoch} batches of {batch} an epoch ({macros} macros "
        f"replayed + {per_epoch - macros * macro} tail steps), 2 epochs: train_steps="
        f"{[e['train_steps'] for e in epochs]} train_examples="
        f"{[e['train_examples'] for e in epochs]} mid-epoch validations at steps {mid}; "
        f"baseline_val_auroc={res['baseline_val_auroc']!r} val_auroc={res['val_auroc']!r} "
        f"test_auroc={res['test_auroc']!r} train_loss={res['train_loss']!r} "
        f"examples_per_s={[e['examples_per_sec'] for e in epochs]!r} ({seconds!r} s in all), "
        f"captures={multi.captures} replays={multi.replays}, launches from Python="
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_train_bf16tab(dev: torch.device, batches: tuple[list, list]):
    """The f32-compute flagship with its tables stored in bf16
    (`table_dtype="bfloat16"`, `block_sorted_kernel="off"`: a bf16 table takes
    no block kernel in the reference), batch 262,144, host-sorted by user id;
    the counted steps are the main path. The same step with f32 tables runs
    beside it for its time. Returns (launches, state, cfg)."""
    tag = "[train-bf16tab]"
    pool, val = batches
    want = {"pooled_gather": 2, "rowwise_adagrad": 2}
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="off", loss="bce")
    f32cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                            layer_sizes=LAYERS)
    cfg = dataclasses.replace(f32cfg, table_dtype="bfloat16")
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                        pack_label=True)
    touched = named_rows(cfg, pool, dev)
    before = {name: t.detach().clone() for name, t in state.model.tables.items()}
    state, _, _ = timed_steps(train_step, state, pool, 0, WARMUP_STEPS)
    # --- the main path, counted ---------------------------------------------------
    reset_launches()
    state, out, times = timed_steps(train_step, state, pool, WARMUP_STEPS, TRAIN_STEPS)
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    for name, n in launches.items():
        if n != want.get(name, 0) * TRAIN_STEPS:
            raise AssertionError(f"{tag} {name}: {n} launches in {TRAIN_STEPS} steps, expected "
                                 f"{want.get(name, 0)} a step")
    loss = out["loss"].item()
    if not np.isfinite(loss):
        raise AssertionError(f"{tag} loss is not finite: {loss}")
    sizes = table_bytes(state.model)
    if sorted(sizes.values()) != [NUM_ITEMS * DIM * 2, NUM_USERS * DIM * 2]:
        raise AssertionError(f"{tag} table bytes {sizes}")
    step_ms = statistics.median(times)
    # the same step with f32 tables, for its time
    fstate, fopt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                               f32cfg, tcfg)
    fstep = make_packed_train_step(step_lib.make_train_step(f32cfg, tcfg, fopt), f32cfg,
                                   pack_label=True)
    fstate, _, _ = timed_steps(fstep, fstate, pool, 0, WARMUP_STEPS)
    fstate, _, ftimes = timed_steps(fstep, fstate, pool, WARMUP_STEPS, TRAIN_STEPS)
    log(f"{tag} flagship f32 compute, bf16 tables {sizes} bytes (f32: "
        f"{table_bytes(fstate.model)}), block_sorted_kernel=off, batch {TRAIN_BATCH}: "
        f"median_step_ms={step_ms!r} min_step_ms={min(times)!r} "
        f"examples_per_s={TRAIN_BATCH / step_ms * 1e3!r} (n={TRAIN_STEPS}, after {WARMUP_STEPS} "
        f"warm-up steps), loss={loss!r}, launches per step: "
        f"{ {k: v // TRAIN_STEPS for k, v in launches.items() if v} }; the same step with f32 "
        f"tables: median_step_ms={statistics.median(ftimes)!r} min_step_ms={min(ftimes)!r}")
    del fstate
    for name, t in state.model.tables.items():
        if t.dtype != torch.bfloat16 or state.adagrad_acc[name].dtype != torch.float32:
            raise AssertionError(f"{tag} {name}: not a bf16 table with f32 accumulators any more")
        keep = ~touched[name]
        if not bitwise_equal(t.detach()[keep], before[name][keep]):
            raise AssertionError(f"{tag} {name}: rows no batch named changed")
        moved = (t.detach() != before[name]).any(dim=1).sum().item()
        log(f"{tag} {name}: {int(keep.sum())} untouched rows kept their bits; "
            f"{moved} of {int(touched[name].sum())} touched rows moved")
    check_against_host(tag, state, cfg, tcfg, dense_opt, train_step, pool[0])
    evaluate_card(tag, state, cfg, tcfg, val)
    return launches, state, cfg


def table_rows(t, keep: torch.Tensor):
    """The rows `keep` of a table (an int8 table's values and scales)."""
    if isinstance(t, QuantizedTable):
        return QuantizedTable(t.values[keep.to(t.values.device)], t.scales[keep.to(t.values.device)])
    return t.detach()[keep.to(t.device)]


@torch.no_grad()
def gate_flip_rows(state, pb) -> tuple[dict[str, torch.Tensor], int]:
    """(per table the [N] bool mask of rows fed by a sample whose ReLU gate
    decision differs between the card's towers and the host's on the same
    state and batch, the number of such samples). Both forwards start from
    the same pooled rows (the gathers agree bit for bit); a pre-activation
    within the f32 summation-order noise of 0 can open its gate on one side
    only, and the two then back-propagate through different units, so
    those samples' rows take another update by the two products' orders,
    not by a kernel (an f32 step, `apply_mlp`'s matmul, bias, ReLU). Under
    bf16 compute each pre-activation is the step's: the product rounded to
    bf16 (`_mm`), the bias added in bf16, where a sum on a rounding tie
    against -b decides either way; the card's fused tower decides its
    output's gates in tower_fwd (ties summed again in k order), the host's
    plain route by its own sums."""
    model, cfg = state.model, state.model.cfg
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    batch = unpack_batch(pb, cfg, pack_label=True)
    pooled = two_tower_pooled(model.tables, batch, cfg)
    flipped = torch.zeros(batch.labels.shape[0], dtype=torch.bool, device=batch.labels.device)
    for mlp, tower in ((model.query_tower, cfg.query_tower),
                       (model.candidate_tower, cfg.candidate_tower)):
        x = torch.cat([pooled[f] for f in tower.features], dim=1).to(dt)
        xc, xh = x, x.cpu()
        # the card's output gates under bf16 compute: the fused forward's (tower_fwd)
        fused = mlp(x, dt, fused_backward=True) > 0 if dt == torch.bfloat16 else None
        n = len(mlp.layers)
        for i, layer in enumerate(mlp.layers):
            w, b = layer.weight.detach().to(dt), layer.bias.detach().to(dt)
            zc = _mm(xc, w.T) + b
            zh = _mm(xh, w.cpu().T) + b.cpu()
            if i < n - 1 or mlp.final_activation:
                card = fused if fused is not None and i == n - 1 else zc > 0
                flipped |= (card.cpu() != (zh > 0)).any(dim=1).to(flipped.device)
                zc, zh = torch.relu(zc), torch.relu(zh)
            xc, xh = zc, zh
    rows = {t.name: torch.zeros(t.num_embeddings, dtype=torch.bool, device=flipped.device)
            for t in cfg.tables}
    for fc in cfg.features:
        f = batch.features[fc.name]
        live = (f.mask > 0) & flipped[:, None]
        rows[fc.table][f.ids[live].long()] = True
    return rows, int(flipped.sum())


BF16_STORE_APART = 1e-3  # check_against_host(bf16_store=True): the share of values that may differ


def check_against_host(tag, state, host_cfg, tcfg, dense_opt, train_step, pb,
                       strict: bool = True,
                       exempt: dict[str, torch.Tensor] | None = None,
                       bf16_store: bool = False) -> dict[str, float]:
    """One step from a copy of the state on the card, against the same step
    on the host CPU, where every wrapper takes its plain version. Two bf16
    ulps of each quantity's largest magnitude (2^-7): under bf16 compute the
    logits, loss and pooled gradients are bf16 values, and in the fused
    softmax p is a bf16 value; a sum on a bf16 rounding boundary rounds
    either way in the two. An int8 table's dequantized rows get one
    quantization step of the row (scale / 127) on top: a value on a rounding
    boundary lands on either side. The item counts are integers and must be
    equal. Returns each quantity's margin, its largest difference over its
    bound (at most 1 to pass); `strict=False` measures without failing.
    `exempt` (per table, a [N] bool mask: `gate_flip_rows`) takes rows out of
    the update's bound, counted in the log; every other check is as above.
    `bf16_store` gives a bf16 table's rows one bf16 ulp of each stored value
    on top, as an int8 table's get a quantization step: the updated value
    rounds to bf16 once, and one on a rounding boundary lands on either
    side. Such flips are rare, so at most BF16_STORE_APART of the table's
    values may differ at all: a store that rounds another way (truncates,
    say) moves about half of the updated values by an ulp and fails."""
    card = state.copy()
    host = state.copy("cpu")
    host.model.cfg = host_cfg
    host_step = make_packed_train_step(step_lib.make_train_step(host_cfg, tcfg, dense_opt),
                                       host_cfg, pack_label=True)
    before = {name: [p.cpu() for p in table_parts(t)] for name, t in card.model.tables.items()}
    before_f32 = {name: table_f32(t).cpu() for name, t in card.model.tables.items()}
    t0 = time.perf_counter()
    card, cout = train_step(card, pb)
    host, hout = host_step(host, map_leaves(pb, lambda t: t.cpu()))
    host_s = time.perf_counter() - t0
    rel = 2.0 ** -7
    errs, margins = {}, {}

    def held(label, diff, bound):
        """Record |got - want| against its bound; fail over it when strict."""
        errs[label] = max(errs.get(label, 0.0), diff)
        margins[label] = max(margins.get(label, 0.0), diff / bound if bound else float(diff > 0))
        if strict and diff > bound:
            raise AssertionError(f"{tag} host check {label}: max abs diff {diff!r} > its bound "
                                 f"{bound!r}")

    def rel_held(label, got, want):
        held(label, (got.float() - want.float()).abs().max().item(),
             rel * want.float().abs().max().item())

    rel_held("loss", cout["loss"].cpu().reshape(1), hout["loss"].reshape(1))
    rel_held("logits", cout["logits"].cpu(), hout["logits"])
    for name, t0_ in before_f32.items():
        got_t, want_t = card.model.tables[name], host.model.tables[name]
        same = torch.ones(t0_.shape[0], dtype=torch.bool)
        for part, start in zip(table_parts(want_t), before[name]):
            same &= (part == start).reshape(t0_.shape[0], -1).all(dim=1)
        for part, start in zip(table_parts(got_t), before[name]):
            if not torch.equal(part.cpu()[same], start[same]):
                raise AssertionError(f"host check {name}: rows the host step kept moved on the "
                                     "card")
        got, want = table_f32(got_t).cpu(), table_f32(want_t)
        if exempt is not None and exempt[name].any():
            keep = ~exempt[name].cpu()
            errs[f"{name} rows exempt"] = int((~keep).sum())
            got, want, t0_ = got[keep], want[keep], t0_[keep]
            got_t, want_t = (table_rows(got_t, keep), table_rows(want_t, keep))
        if isinstance(got_t, QuantizedTable):
            step = torch.maximum(got_t.scales.cpu(), want_t.scales)[:, None] / 127
            diff = (got - want).abs()
            over = diff / (rel * (want - t0_).abs().max() + step)
            errs[name] = diff.max().item()
            margins[name] = over.max().item()
            if strict and margins[name] > 1:
                raise AssertionError(f"host check {name}: dequantized rows differ by "
                                     f"{diff.max().item()!r}, more than 2^-7 x max|update| plus "
                                     "one quantization step")
            errs[f"{name} values that differ"] = (
                (got_t.values.cpu() != want_t.values).sum().item() / got_t.values.numel())
        elif bf16_store and got_t.dtype == torch.bfloat16:
            big = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
            diff = (got - want).abs()
            margin = (diff / (rel * (want - t0_).abs().max() + ulp)).max().item()
            apart = (got != want).float().mean().item()
            errs[f"{name} update"], margins[f"{name} update"] = diff.max().item(), margin
            errs[f"{name} values that differ"] = apart
            margins[f"{name} values that differ"] = apart / BF16_STORE_APART
            if strict and margin > 1:
                raise AssertionError(f"{tag} host check {name}: rows differ by "
                                     f"{diff.max().item()!r}, more than 2^-7 x max|update| plus "
                                     "one bf16 ulp of the value")
            if strict and apart > BF16_STORE_APART:
                raise AssertionError(f"{tag} host check {name}: {apart!r} of the values differ, "
                                     f"more than {BF16_STORE_APART!r}: not rounding boundaries "
                                     "alone")
        else:
            rel_held(f"{name} update", got - t0_, want - t0_)
        rel_held(f"{name} acc", card.adagrad_acc[name].cpu(), host.adagrad_acc[name])
    for (pc, sc), (ph, sh) in zip(card.dense_opt_state.state.items(),
                                  host.dense_opt_state.state.items()):
        rel_held("tower grads", sc["exp_avg"].cpu(), sh["exp_avg"])
    if card.item_counts is not None:
        if not torch.equal(card.item_counts.cpu(), host.item_counts):
            raise AssertionError(f"{tag} host check: item counts differ")
        errs["item_counts"] = 0.0
    log(f"{tag} one step from a copied state, card against host CPU (plain versions, "
        f"{host_s!r} s): " + ("within 2^-7 x max|host| each" if strict else "measured") +
        f"; max abs diffs {errs!r}; margins (diff / bound, at most 1 passes) {margins!r}, the "
        f"largest {max(margins.values())!r}")
    return margins


@contextlib.contextmanager
def forward_without_tie_repair():
    """The fused tower's bf16 forward without the tie repair: two cuBLAS GEMMs
    (`_mm`), each with `relu(y + b)` of its own sums on the card (the measure
    of what the repair moved; nothing counts as a tower_fwd launch inside)."""
    from two_tower_recommender_model_tpu_torch.models import mlp

    saved = mlp.tower_forward
    mlp.tower_forward = lambda x, w1, b1, w2, b2: torch.relu(
        _mm(torch.relu(_mm(x, w1) + b1), w2) + b2)
    try:
        yield
    finally:
        mlp.tower_forward = saved


def evaluate_card(tag, state, cfg, tcfg, val) -> None:
    eval_step = make_packed_eval_step(step_lib.make_eval_step(cfg, tcfg), cfg, pack_label=True)
    es = step_lib.eval_state_init(device=state.device)
    for pb in val:
        es = eval_step(state, es, pb)
    loss, auroc = float(mean_compute(es.loss)), float(auroc_compute(es.auroc))
    if not (np.isfinite(loss) and 0.0 <= auroc <= 1.0):
        raise AssertionError(f"{tag} eval gave loss {loss}, auroc {auroc}")
    log(f"{tag} eval over {len(val)} validation batches of {TRAIN_BATCH}: "
        f"val_loss={loss!r} val_auroc={auroc!r}")


def phase_train_softmax(dev: torch.device, profile: bool) -> dict[str, int]:
    """The sampled-softmax training slice at the flagship's full width,
    through the port's entry points; the counted steps at batch 8,192 are the
    main path."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    tcfg = cfg_lib.TrainConfig(batch_size=SOFTMAX_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="float32", loss="sampled_softmax",
                               softmax_kernel="on")
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)

    def batches(size, n, split):
        return [map_leaves(feat(cols), lambda t: t.to(dev)) for cols in ds.batches(size, n, split)]

    def packed_step(c, t):
        return make_packed_train_step(step_lib.make_train_step(c, t, dense_opt), c,
                                      pack_label=True)

    pool = batches(SOFTMAX_BATCH, POOL, "train")
    train_step = packed_step(cfg, tcfg)
    state, _, _ = timed_steps(train_step, state, pool, 0, WARMUP_STEPS)
    # --- the main path, counted ---------------------------------------------------
    reset_launches()
    state, out, times = timed_steps(train_step, state, pool, WARMUP_STEPS, TRAIN_STEPS)
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    per_step = {"pooled_gather": 2, "rowwise_adagrad": 2, "tower_bwd": 0,  # f32: off #8's gate
                "softmax_lse_fwd": 1, "softmax_lse_dq": 1, "softmax_lse_dc": 1}
    for name, n in launches.items():
        if n != per_step.get(name, 0) * TRAIN_STEPS:
            raise AssertionError(f"[train-softmax] {name}: {n} launches in {TRAIN_STEPS} steps, "
                                 f"expected {per_step.get(name, 0)} a step")
    loss = out["loss"].item()
    if not np.isfinite(loss):
        raise AssertionError(f"[train-softmax] loss is not finite: {loss}")
    counted = state.item_counts.sum().item()
    if counted != (WARMUP_STEPS + TRAIN_STEPS) * SOFTMAX_BATCH:
        raise AssertionError(f"[train-softmax] item_counts sums to {counted}")
    step_ms = statistics.median(times)
    log(f"[train-softmax] flagship f32 step, sampled softmax + logQ, kernels on, batch "
        f"{SOFTMAX_BATCH}: median_step_ms={step_ms!r} min_step_ms={min(times)!r} "
        f"examples_per_s={SOFTMAX_BATCH / step_ms * 1e3!r} (n={TRAIN_STEPS}, after "
        f"{WARMUP_STEPS} warm-up steps), loss={loss!r}, item_counts sum={counted!r}, "
        f"launches per step: { {k: v // TRAIN_STEPS for k, v in launches.items() if v} }")
    check_against_host("[train-softmax]", state, cfg, tcfg, dense_opt, train_step, pool[0])
    if profile:
        profile_direct(lambda: train_step(state, pool[0]), "train-softmax step", 2, calls=5)

    # the same configuration with the plain chunked route, for the record
    off_step = packed_step(cfg, dataclasses.replace(tcfg, softmax_kernel="off"))
    state, _, _ = timed_steps(off_step, state, pool, 0, 1)
    state, _, off_times = timed_steps(off_step, state, pool, 1, 5)
    log(f"[train-softmax] batch {SOFTMAX_BATCH}, softmax_kernel=off (chunked plain route): "
        f"median_step_ms={statistics.median(off_times)!r} (n=5) against {step_ms!r} with the "
        f"kernels")

    # the large batch: three steps with the kernels, three with the chunked plain route
    big = batches(SOFTMAX_BIG, 2, "big")
    for kernel in ("on", "off"):
        big_step = packed_step(cfg, dataclasses.replace(tcfg, batch_size=SOFTMAX_BIG,
                                                        softmax_kernel=kernel))
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        state, _, _ = timed_steps(big_step, state, big, 0, 1)
        state, out, big_times = timed_steps(big_step, state, big, 1, 3)
        made = {k: v - before[k] for k, v in read_launches().items() if k.startswith("softmax")}
        # D = 64: #9, #10 and #11 once a step, no p kernel (the wide backward's)
        if made != {k: 4 if kernel == "on" and k != "softmax_lse_p" else 0 for k in made}:
            raise AssertionError(f"[train-softmax] batch {SOFTMAX_BIG} {kernel}: {made}")
        if not np.isfinite(out["loss"].item()):
            raise AssertionError(f"[train-softmax] batch {SOFTMAX_BIG}: loss is not finite")
        big_ms = statistics.median(big_times)
        log(f"[train-softmax] batch {SOFTMAX_BIG}, softmax_kernel={kernel}: "
            f"median_step_ms={big_ms!r} examples_per_s={SOFTMAX_BIG / big_ms * 1e3!r} (n=3, "
            f"after 1 warm-up step), loss={out['loss'].item()!r}, "
            f"peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9!r}")

    # bf16 compute: the tower backward (#8) and forward launch beside the softmax kernels
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    btcfg = dataclasses.replace(tcfg, block_sorted_kernel="bfloat16")
    bstate, bopt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                               bcfg, btcfg)
    bstep = make_packed_train_step(step_lib.make_train_step(bcfg, btcfg, bopt), bcfg,
                                   pack_label=True)
    before = read_launches()
    bstate, out, btimes = timed_steps(bstep, bstate, pool, 0, 2)
    made = {k: v - before[k] for k, v in read_launches().items() if v - before[k]}
    want = {k: 2 * n for k, n in SOFTMAX_BF16.items()}
    if made != want or not np.isfinite(out["loss"].float().item()):
        raise AssertionError(f"[train-softmax] bf16: launches {made}, expected {want}; "
                             f"loss {out['loss'].float().item()}")
    log(f"[train-softmax] bf16 compute, batch {SOFTMAX_BATCH}: 2 steps, launches {made}, "
        f"second_step_ms={btimes[1]!r}, loss={out['loss'].float().item()!r}")
    return launches


WIDE_LAYERS = (512, 256)  # [train-softmax-wide]'s towers: D = 256 at the loss
HOST_CHECKS = 3  # eager steps of [train-softmax-wide] held against the host's


def phase_train_softmax_wide(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-softmax-wide]`: `[train-softmax]`'s configuration (the
    flagship tables, f32, batch 8,192, logQ, accidental-hit masking, the
    kernels on, user-sorted, block kernels in f32) with towers WIDE_LAYERS,
    so the loss sees D = 256 and #9, #10 and #11 take their depth slices.
    Through `create_train_state` -> `make_train_step` -> `make_multi_step`:
    HOST_CHECKS eager steps counted (#9, #10 and #11 once a step, the p
    kernel once (one panel of 8,192 rows), #1 and #4 twice; the wide towers
    miss #8's and tower_fwd's gates, as in the reference) and each held
    against the host's plain step from the same
    state (`check_against_host`); the K = 16 graph against eager steps
    (`phase_train_graph`); and eager steps of the plain chunked route
    (`softmax_kernel="off"`) beside the kernels' in the same call."""
    tag = "[train-softmax-wide]"
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=WIDE_LAYERS)
    _, tcfg = softmax_flagship()
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    pool = [map_leaves(feat(cols), lambda t: t.to(dev))
            for cols in ds.batches(SOFTMAX_BATCH, GRAPH_POOL, "train")]
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)

    def packed_step(t):
        return make_packed_train_step(step_lib.make_train_step(cfg, t, dense_opt), cfg,
                                      pack_label=True)

    train_step = packed_step(tcfg)
    # --- the main path, counted ---------------------------------------------------
    reset_launches()
    state, out, times = timed_steps(train_step, state, pool, 0, HOST_CHECKS)
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    for name, n in launches.items():
        if n != SOFTMAX_WIDE_F32.get(name, 0) * HOST_CHECKS:
            raise AssertionError(f"{tag} {name}: {n} launches in {HOST_CHECKS} steps, expected "
                                 f"{SOFTMAX_WIDE_F32.get(name, 0)} a step")
    if not np.isfinite(out["loss"].item()):
        raise AssertionError(f"{tag} loss is not finite: {out['loss'].item()}")
    log(f"{tag} towers {WIDE_LAYERS}, D={WIDE_LAYERS[-1]} at the loss, f32, batch "
        f"{SOFTMAX_BATCH}: {HOST_CHECKS} eager steps, step_ms={times!r}, loss="
        f"{out['loss'].item()!r}, launches per step "
        f"{ {k: v // HOST_CHECKS for k, v in launches.items() if v} }")
    margins = []
    for i in range(HOST_CHECKS):  # each step from the state the one before left
        pb = pool[HOST_CHECKS + i]
        margins.append(check_against_host(f"{tag} step {HOST_CHECKS + i}", state, cfg, tcfg,
                                          dense_opt, train_step, pb))
        state, _ = train_step(state, pb)
    log(f"{tag} the largest margin of the {HOST_CHECKS} host checks: "
        f"{max(max(m.values()) for m in margins)!r}")
    graph = phase_train_graph(dev, f"sampled softmax + logQ, towers {WIDE_LAYERS}, f32", cfg,
                              tcfg, pool, SOFTMAX_WIDE_F32, profile, tag=tag)
    launches = {k: v + graph[k] for k, v in launches.items()}
    # the plain chunked route in the same call, for the record
    state, _, on_times = timed_steps(train_step, state, pool, 0, 5)
    off_step = packed_step(dataclasses.replace(tcfg, softmax_kernel="off"))
    before = read_launches()
    state, _, _ = timed_steps(off_step, state, pool, 0, 1)
    state, out, off_times = timed_steps(off_step, state, pool, 1, 5)
    made = {k: v - before[k] for k, v in read_launches().items() if k.startswith("softmax")}
    if set(made.values()) != {0} or not np.isfinite(out["loss"].item()):
        raise AssertionError(f"{tag} softmax_kernel=off: launches {made}, loss "
                             f"{out['loss'].item()}")
    log(f"{tag} eager median_step_ms kernels={statistics.median(on_times)!r} "
        f"softmax_kernel=off (chunked plain route)={statistics.median(off_times)!r} (n=5 each, "
        f"in turns after the graph); {card_line()}")
    trained_p_kernel(tag, train_step, state, pool)
    return launches


# [train-wide-table]: (D, table dtype, batch) - tables past the half-warp walk's 512
# columns and at D % 4 != 0, which the span walk's general route and #5's wide and
# one-int8-a-lane paths take
WIDE_TABLE_DIM = 1024
WIDE_TABLE_CASES = ((WIDE_TABLE_DIM, "float32", 65_536), (WIDE_TABLE_DIM, "int8", 65_536),
                    (30, "float32", 8192))
WIDE_TABLE_STEPS = 3  # counted eager steps of each case, then as many host checks
BCE_WIDE_F32 = {"pooled_gather": 2, "rowwise_adagrad": 2}  # f32 compute: no tower kernels
BCE_WIDE_INT8 = {"quantized_pooled_gather": 2, "quantized_rowwise_adagrad": 2}


def phase_train_wide_table(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-wide-table]`: the flagship tables (NUM_USERS x NUM_ITEMS) at
    widths the JAX package trains and the half-warp walk does not take: D =
    1,024 with f32 and with int8 tables at batch 65,536, D = 30 (D % 4 != 0)
    with f32 tables at 8,192; BCE, f32 compute, sorted by user id, the block
    kernels in f32. Through `create_train_state` -> `make_train_step`:
    WIDE_TABLE_STEPS eager steps counted (#1 and #4, or #5 and #6 for int8
    tables, twice a step; nothing else), each then held against the host's
    plain step from the same state (`check_against_host`), the rows fed by a
    sample whose ReLU gate opens on one side only (`gate_flip_rows`: at most
    1 in 1,000 samples) counted and exempt from the update's bound. Then the D =
    1,024 int8 model through `Scorer` and `RetrievalService`
    (`phase_serve_trained`: #5 at every lookup)."""
    tag = "[train-wide-table]"
    launches = {name: 0 for name in KERNELS}
    int8_model = None
    pools = {}  # (D, batch) -> the packed batches, shared by the f32 and int8 cases
    for d, table_dtype, batch in WIDE_TABLE_CASES:
        label = f"{tag} D={d} {table_dtype} tables, batch {batch}"
        cfg = dataclasses.replace(
            cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=d,
                                           layer_sizes=LAYERS), table_dtype=table_dtype)
        tcfg = cfg_lib.TrainConfig(batch_size=batch, sorted_feature="user_id",
                                   block_sorted_kernel="float32", loss="bce")
        if (d, batch) not in pools:  # the packing does not depend on the tables' storage
            feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
            ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
            pools[d, batch] = [map_leaves(feat(cols), lambda t: t.to(dev))
                               for cols in ds.batches(batch, WIDE_TABLE_STEPS, "train")]
        pool = pools[d, batch]
        state, dense_opt = step_lib.create_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, tcfg)
        train_step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                            pack_label=True)
        # --- the main path, counted -----------------------------------------------
        reset_launches()
        state, out, times = timed_steps(train_step, state, pool, 0, WIDE_TABLE_STEPS)
        made = read_launches()
        # --- checks, not counted --------------------------------------------------
        want = BCE_WIDE_INT8 if table_dtype == "int8" else BCE_WIDE_F32
        for name, n in made.items():
            if n != want.get(name, 0) * WIDE_TABLE_STEPS:
                raise AssertionError(f"{label} {name}: {n} launches in {WIDE_TABLE_STEPS} steps, "
                                     f"expected {want.get(name, 0)} a step")
            launches[name] += n
        if not np.isfinite(out["loss"].item()):
            raise AssertionError(f"{label}: loss {out['loss'].item()} is not finite")
        tables = table_bytes(state.model)
        log(f"{label}: {WIDE_TABLE_STEPS} eager steps, step_ms={times!r}, loss="
            f"{out['loss'].item()!r}, launches per step "
            f"{ {k: v // WIDE_TABLE_STEPS for k, v in made.items() if v} }, table bytes {tables}")
        margins = []
        for i in range(WIDE_TABLE_STEPS):  # each step from the state the one before left
            pb = pool[i]
            exempt, samples = gate_flip_rows(state, pb)
            rows = sum(int(m.sum()) for m in exempt.values())
            if samples > batch // 1000:  # f32 order flips a few; a coarser product thousands
                raise AssertionError(f"{label}: {samples} samples whose ReLU gates open on one "
                                     "side only (at most 1 in 1,000 allowed)")
            log(f"{label} step {WIDE_TABLE_STEPS + i}: {samples} samples with a ReLU gate open "
                f"on one side only, their {rows} table rows exempt from the update's bound")
            margins.append(check_against_host(f"{label} step {WIDE_TABLE_STEPS + i}", state, cfg,
                                              tcfg, dense_opt, train_step, pb, exempt=exempt))
            state, _ = train_step(state, pb)
        log(f"{label}: the largest margin of the {WIDE_TABLE_STEPS} host checks "
            f"{max(max(m.values()) for m in margins)!r}; {card_line()}")
        if (d, table_dtype) == (WIDE_TABLE_DIM, "int8"):
            int8_model = (state, cfg)
        del state, pool
    served = phase_serve_trained(dev, *int8_model, profile, f"{tag} serve D=1024 int8")
    return {name: n + served.get(name, 0) for name, n in launches.items()}


TRAINED_STEPS = 100  # eager steps before the p kernel's inputs are kept


def trained_p_kernel(tag: str, train_step, state, pool: list) -> None:
    """The wide backward's p kernel on a trained state's inputs (not
    counted): TRAINED_STEPS more steps over the pool (a model's p
    concentrate as it trains), then one whose p kernel's arguments are kept;
    the p of weight
    (exp(s - lse) >= 2^-10) and the ties among them that the kernel sums
    again (`csrc/softmax_lse.cu`: their cost grows as a model's p
    concentrate), the panel against the plain one (`p_close`), and its ms
    beside its bound."""
    seen, p_kernel = [], sk.softmax_lse_p

    def keep(*args, **kwargs):
        if not seen:
            seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return p_kernel(*args, **kwargs)

    for i in range(TRAINED_STEPS):
        state, _ = train_step(state, pool[i % len(pool)])
    sk.softmax_lse_p = keep
    try:
        train_step(state, pool[0])
    finally:
        sk.softmax_lse_p = p_kernel
    torch.cuda.synchronize()
    q, c, adj, row_ids, col_ids, off, inv_t, lse, g, lo, hi = seen[0]
    (bq, dp), bk = q.shape, c.shape[0]
    cols = torch.arange(bk, device=q.device)
    ex = torch.exp(sk._scores(q.float(), c.float(), adj, row_ids, col_ids, cols[off:off + bq],
                              cols, inv_t) - lse[:, None])
    p_f32 = ex * g[:, None]
    weighty = ex >= 2.0 ** -10
    ties = int((weighty & (((p_f32.view(torch.int32) & 0xFFFF) - 0x8000).abs() <= 0x2000)).sum())
    del p_f32
    args = (q, c, adj, row_ids, col_ids, off, inv_t, lse, g)
    work = torch.empty((bq, bk), dtype=torch.bfloat16, device=q.device)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=q.device)
    ms = median_ms(lambda: p_kernel(*args, lo, hi, out=work), flush, 10)
    err = p_close(work, sk.p_panel_reference(*args, lo, hi), ex, g, f"{tag} trained p")
    b = bound((bq + bk) * (dp * 2 + 12) + bq * bk * 2, 2 * bq * bk * dp, PEAK_BF16, bq * bk)
    log(f"{tag} the p kernel on the inputs of a step after {TRAINED_STEPS} more "
        f"[{bq} x {bk}], D={dp}: "
        f"{int(weighty.sum())} p of weight in {int(weighty.any(1).sum())} rows (at most "
        f"{int(weighty.sum(1).max())} a row), {ties} of them near a bf16 tie (summed again); "
        f"max_abs_err {err!r} against the plain p; kernel_ms={ms!r} bound_ms={b['bound_ms']!r} "
        f"by {b['bound_by']} (n=10); {card_line()}")
    # #9 on the same trained inputs: the lse the step's forward takes
    fwd = args[:7]
    lse_k = sk.softmax_lse_fwd(*fwd)
    lse_p = sk.lse_forward_reference(*fwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse_k, lse_p, rtol=2e-5, atol=1e-5)
    fwd_ms = median_ms(lambda: sk.softmax_lse_fwd(*fwd), flush, 10)
    b9 = bound((bq + bk) * (dp * 2 + 12) + bq * 4, 2 * bq * bk * dp, PEAK_BF16, bq * bk)
    log(f"{tag} #9 on the same trained inputs [{bq} x {bk}], D={dp}: max_abs_err "
        f"{(lse_k - lse_p).abs().max().item()!r} against the plain lse; kernel_ms={fwd_ms!r} "
        f"bound_ms={b9['bound_ms']!r} by {b9['bound_by']} (n=10); {card_line()}")


def phase_train_devsort(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-devsort]`: the flagship BCE graph's configuration (f32
    tables, bf16 compute, batch 262,144, block kernels in bf16) with no host
    sort (`sorted_feature=None`), so with `device_sorted_gather=True` both
    features take the device-sorted gather: the 105.6 MB user table and the
    25.4 MB item table, each a sort, #1 at one slot and the inverse permute.
    Beside it, from one state on the same batches, the same configuration
    with the flag off (the plain pooled gather): 3 eager steps of each,
    counted, whose states must agree bit for bit (both gathers emit the same
    bf16 rows) or within `compare_states`' bars, printed; the K = 16 graph of
    each (`phase_train_graph`, their replayed ms a step); the device ms of
    each route's gather and of the sort and the permute alone (CUDA events
    on a captured replay, `graph_ms`). Then an int8 user table (#5): 3
    eager steps against the flag off."""
    tag = "[train-devsort]"
    bce, bce_tcfg = flagship_bce()
    off_tcfg = dataclasses.replace(bce_tcfg, sorted_feature=None)
    on_tcfg = dataclasses.replace(off_tcfg, device_sorted_gather=True)
    feat = PackedFeaturizer(bce, pack_label=True)  # no host sort
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    pool = [map_leaves(feat(cols), lambda t: t.to(dev))
            for cols in ds.batches(TRAIN_BATCH, GRAPH_POOL, "train")]
    batch = unpack_batch(pool[0], bce, pack_label=True)
    if step_lib.device_sorted_features(bce, on_tcfg, batch) != ("user_id", "product_id"):
        raise AssertionError(f"{tag} the route takes "
                             f"{step_lib.device_sorted_features(bce, on_tcfg, batch)}")
    launches = {}

    def eager_pair(cfg, want, label):
        """3 eager steps with the flag on (counted) and off from one state."""
        base, dense_opt = step_lib.create_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, on_tcfg)
        states = {}
        for flag, t in (("on", on_tcfg), ("off", off_tcfg)):
            step = make_packed_train_step(step_lib.make_train_step(cfg, t, dense_opt), cfg,
                                          pack_label=True)
            before = read_launches()
            state, out, times = timed_steps(step, base.copy(), pool, 0, 3)
            made = {k: v - before[k] for k, v in read_launches().items()}
            if any(n != want.get(k, 0) * 3 for k, n in made.items()):
                raise AssertionError(f"{tag} {label} flag {flag}: launches {made}, expected "
                                     f"{want} a step")
            if flag == "on":
                for k, n in made.items():
                    launches[k] = launches.get(k, 0) + n
            states[flag] = (state, out["loss"], times)
        same = compare_states(f"{tag} {label}", states["off"][0], states["on"][0])
        log(f"{tag} {label}, 3 eager steps from one state: device-sorted gather against the "
            f"plain gather: {same}; last loss bitwise equal "
            f"{bitwise_equal(states['on'][1], states['off'][1])}; step_ms on="
            f"{states['on'][2]!r} off={states['off'][2]!r}")

    eager_pair(bce, BCE_F32, "f32 tables")
    for flag, t in (("on", on_tcfg), ("off", off_tcfg)):
        made = phase_train_graph(dev, f"BCE, f32 tables, no host sort, device_sorted_gather={flag}",
                                 bce, t, pool, BCE_F32, profile, tag=tag)
        if flag == "on":
            for k, n in made.items():
                launches[k] = launches.get(k, 0) + n
    # the device ms of each route's gather, and of the sort and the permute alone
    state, _ = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0), bce,
                                           on_tcfg)
    for fname, tname in (("user_id", "t_user_id"), ("product_id", "t_product_id")):
        table, f = state.model.tables[tname], batch.features[fname]
        ids = torch.where(f.mask[:, 0] > 0, f.ids[:, 0].to(torch.int32), table.shape[0])
        sids, perm = torch.sort(ids, stable=True)
        rows = device_sorted_lookup(table, ids, matmul_dtype="bfloat16", out_dtype=torch.bfloat16)
        ms = {"route": graph_ms(lambda: device_sorted_lookup(
                  table, ids, matmul_dtype="bfloat16", out_dtype=torch.bfloat16)),
              "sort": graph_ms(lambda: torch.sort(ids, stable=True)),
              "permute": graph_ms(lambda: torch.empty_like(rows).index_copy_(0, perm, rows)),
              "plain gather": graph_ms(lambda: pooled_lookup(table, f.ids, f.mask, "sum",
                                                             torch.bfloat16))}
        mb = table.numel() * table.element_size() / 1e6
        log(f"{tag} {tname} ({mb!r} MB, {TRAIN_BATCH} ids unsorted) device ms (CUDA events, a "
            f"captured replay, n={REPS}): {ms!r}")
    del state
    # an int8 user table: #5 on the route
    int8 = dataclasses.replace(bce, tables=(dataclasses.replace(bce.tables[0], dtype="int8"),
                                            *bce.tables[1:]))
    eager_pair(int8, {"quantized_pooled_gather": 1, "pooled_gather": 1,
                      "quantized_rowwise_adagrad": 1, "rowwise_adagrad": 1, "tower_bwd": 2,
                      "tower_fwd": 2}, "int8 user table")
    log(f"{tag} {card_line()}")
    return launches


def learn_softmax_drive():
    """The sampled-softmax learnability drive (the reference's
    `tests/test_quality.py`): the (32, 16) linear-head model on the learnable
    synthetic set, batch 512, 5 epochs of 50 batches. Returns (model config,
    train config, data set, `run(state, dense_opt, logger=None)` through
    `train_val_test` with the per-epoch retrieval eval and the best epoch
    kept by recall@10 against the generator's ground-truth top-10)."""
    mcfg = cfg_lib.two_tower_model_config(120, 60, embedding_dim=16, layer_sizes=(32, 16))
    mcfg = dataclasses.replace(
        mcfg, query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg_lib.TrainConfig(epochs=5, loss="sampled_softmax", softmax_kernel="on",
                               sparse_learning_rate=0.1, learning_rate=3e-3,
                               limit_val_batches=2, limit_test_batches=2)
    ds = SyntheticClickstream(120, 60, seed=4, noise=0.05, latent_dim=4)
    users = np.arange(1, 121)
    truth = ds.ground_truth_topk(users, k=10)
    positives = {int(u): truth[i].tolist() for i, u in enumerate(users)}

    def run(state, dense_opt, logger=None):
        return train_val_test(
            state, step_lib.make_train_step(mcfg, tcfg, dense_opt),
            step_lib.make_eval_step(mcfg, tcfg), mcfg, tcfg,
            Featurizer(mcfg, device="cpu"),  # host batches: the loop's pipeline moves them
            train_batches_factory=lambda ep: ds.batches(512, 50, split=f"t{ep}"),
            val_batches_factory=lambda: ds.batches(512, 2, split="val"),
            test_batches_factory=lambda: ds.batches(512, 2, split="test"), logger=logger,
            retrieval_eval_fn=make_retrieval_eval_fn(mcfg, positives, k=20, ks=(10,),
                                                     max_users=120),
            select_best="val_recall_at_10")
    return mcfg, tcfg, ds, run


def phase_learn_softmax(dev: torch.device) -> dict[str, int]:
    """The sampled softmax learns to retrieve, on the card (`learn_softmax_drive`,
    weights drawn by a card generator)."""
    mcfg, tcfg, ds, run = learn_softmax_drive()
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   mcfg, tcfg)
    # --- the path, counted ---------------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    state, res = run(state, dense_opt)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    if not res["val_recall_at_10"] > 0.35:
        raise AssertionError(f"[learn-softmax] recall@10 {res['val_recall_at_10']} <= 0.35")
    if "best_epoch" not in res:
        raise AssertionError("[learn-softmax] no best_epoch in the results")
    steps = tcfg.epochs * 50
    for name in ("softmax_lse_fwd", "softmax_lse_dq", "softmax_lse_dc"):
        if launches[name] != steps:
            raise AssertionError(f"[learn-softmax] {name}: {launches[name]} launches in {steps} "
                                 "steps")
    if state.step != (int(res["best_epoch"]) + 1) * 50:
        raise AssertionError(f"[learn-softmax] returned state at step {state.step}, best epoch "
                             f"{res['best_epoch']}")
    log(f"[learn-softmax] baseline_val_recall_at_10={res['baseline_val_recall_at_10']!r} "
        f"val_recall_at_10={res['val_recall_at_10']!r} best_epoch={res['best_epoch']!r} "
        f"val_auroc={res['val_auroc']!r} train_loss={res['train_loss']!r} "
        f"examples_per_s={res['examples_per_sec']!r} ({seconds!r} s in all), launches={launches}")
    return launches


class RecallLog:
    """A `train_val_test` logger that keeps each epoch's val recall@10."""

    def __init__(self):
        self.recalls = []

    def log_metrics(self, metrics, step=None):
        if "val_recall_at_10" in metrics:
            self.recalls.append(metrics["val_recall_at_10"])


def unrounded_lse_backward(q16, c16, adj, row_ids, col_ids, row_offset, inv_t, lse, g,
                           need_dq=True, need_dc=True):
    """`lse_backward_reference` with p kept in f32 (not rounded to bf16): a
    probe of the equal-weights check, in one block of rows (B = 512)."""
    qf, cf = q16.float(), c16.float()
    cols = torch.arange(cf.shape[0], device=qf.device)
    s = sk._scores(qf, cf, adj, row_ids, col_ids, cols[:qf.shape[0]] + row_offset, cols, inv_t)
    p = torch.exp(s - lse[:, None]) * g[:, None]
    return ((p @ cf) * inv_t if need_dq else None), ((p.T @ qf) * inv_t if need_dc else None)


@contextlib.contextmanager
def routed_lse_backward(fn, seen: dict):
    """Route the fused loss's backward through `fn` (a function with
    `lse_backward_reference`'s signature) on the card and on the host, or
    keep kernels #10 / #11 on the card and the plain version on the host
    (`fn=None`); keep the last dq and dc it returned, on the host, in `seen`."""
    dq_k, dc_k, plain = sk.softmax_lse_dq, sk.softmax_lse_dc, sk.lse_backward_reference

    def on_card(which, kernel):
        def call(*args):
            out = (kernel(*args) if fn is None else
                   fn(*args, need_dq=which == "dq", need_dc=which == "dc")[which == "dc"])
            seen[which] = out.detach().cpu().clone()
            return out
        return call

    def on_host(*args):
        dq, dc = (fn or plain)(*args)
        seen["dq"], seen["dc"] = dq.clone(), dc.clone()
        return dq, dc

    sk.softmax_lse_dq, sk.softmax_lse_dc = on_card("dq", dq_k), on_card("dc", dc_k)
    sk.lse_backward_reference = on_host
    try:
        yield
    finally:
        sk.softmax_lse_dq, sk.softmax_lse_dc, sk.lse_backward_reference = dq_k, dc_k, plain


def phase_learn_softmax_equal_weights(dev: torch.device) -> None:
    """The drive of `[learn-softmax]` from ONE set of weights on the card and
    on the host CPU (where every wrapper takes its plain version): the state
    drawn by a CPU generator, copied to the card. First one packed step from
    copies of it: each table's update and accumulator within 2^-7 x max of
    the host's (`check_against_host`'s tolerance), the loss, logits and each
    tower parameter's gradient (Adam's first moment) printed as their
    distance over that tolerance. The same step is repeated with the fused
    loss's backward routed through the plain version on the card tensors,
    and with p kept in f32 on both sides (`unrounded_lse_backward`), and the
    backward's dq and dc are compared with the host's in each: this places
    the towers' distance in the kernels, in the plain arithmetic on the card
    or in the bf16 rounding of p. Then the whole drive on both, recall@10
    per epoch side by side. Not counted: it checks whether the card's recall
    differs from the host's on equal weights."""
    mcfg, tcfg, ds, run = learn_softmax_drive()
    host, dense_opt = step_lib.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    card = host.copy(device=dev)
    feat = PackedFeaturizer(mcfg, pack_label=True)
    pb = feat(next(iter(ds.batches(512, 1, split="t0"))))
    rel = 2.0 ** -7
    names = ([f"query_tower.{n}" for n, _ in host.model.query_tower.named_parameters()]
             + [f"candidate_tower.{n}" for n, _ in host.model.candidate_tower.named_parameters()])

    def over(got, want):  # max |got - want| over rel x max |want|
        return ((got.cpu().float() - want.float()).abs().max()
                / (rel * want.float().abs().max())).item()

    def one_step(state, fn):
        step = make_packed_train_step(step_lib.make_train_step(mcfg, tcfg, dense_opt), mcfg,
                                      pack_label=True)
        start = {n: t.detach().cpu().clone() for n, t in state.model.tables.items()}
        seen = {}
        with routed_lse_backward(fn, seen):
            state, out = step(state, map_leaves(pb, lambda t: t.to(state.device)))
        firsts = [state.dense_opt_state.state[p]["exp_avg"].detach().cpu()
                  for p in step_lib.tower_parameters(state.model)]
        return state, out, start, seen, firsts

    runs = {(tag, route): one_step(state.copy(), fn)
            for route, fn in (("kernels", None), ("plain", sk.lse_backward_reference),
                              ("f32 p", unrounded_lse_backward))
            for tag, state in (("card", card), ("cpu", host))
            if not (tag == "cpu" and route == "plain")}  # the host's "kernels" run is plain
    card_s, cout, start, _, _ = runs["card", "kernels"]
    host_s, hout, _, _, _ = runs["cpu", "kernels"]
    ratios = {"loss": over(cout["loss"].reshape(1), hout["loss"].reshape(1)),
              "logits": over(cout["logits"], hout["logits"])}
    for n in start:
        ratios[n] = over(card_s.model.tables[n].detach() - start[n].to(dev),
                         host_s.model.tables[n].detach() - start[n])
        ratios[f"{n} acc"] = over(card_s.adagrad_acc[n], host_s.adagrad_acc[n])
        if max(ratios[n], ratios[f"{n} acc"]) > 1:
            raise AssertionError(f"[learn-softmax] equal weights: table {n} after one step is "
                                 f"{ratios[n]!r} x 2^-7 x max from the host's")
    ratios["tower grads"] = max(over(a, b) for a, b in zip(runs["card", "kernels"][4],
                                                            runs["cpu", "kernels"][4]))
    log(f"[learn-softmax] equal weights, one step card against host CPU: max abs diff over "
        f"2^-7 x max|host| (tables held to <= 1): {ratios!r}")
    for route, host_route in (("kernels", "kernels"), ("plain", "kernels"), ("f32 p", "f32 p")):
        got, want = runs["card", route], runs["cpu", host_route]
        grads = {n: round(over(a, b), 4) for n, a, b in zip(names, got[4], want[4])}
        maxes = {n: f"{b.abs().max().item():.3g}" for n, b in zip(names, want[4])}
        log(f"[learn-softmax] equal weights, backward on the card through {route} against the "
            f"host's {'plain version' if host_route == 'kernels' else route}: dq "
            f"{over(got[3]['dq'], want[3]['dq'])!r}, dc {over(got[3]['dc'], want[3]['dc'])!r}; "
            f"per tower gradient {grads!r}; max|host| per tower gradient {maxes!r}")
    results = {}
    for tag, state in (("card", card), ("cpu", host)):
        logger = RecallLog()
        _, res = run(state, dense_opt, logger)
        results[tag] = (logger.recalls, res)
    (card_recalls, card_res), (cpu_recalls, cpu_res) = results["card"], results["cpu"]
    log(f"[learn-softmax] equal weights (CPU generator, seed 0): val recall@10 per epoch on the "
        f"card {card_recalls!r}, on the host CPU {cpu_recalls!r}; baseline "
        f"{card_res['baseline_val_recall_at_10']!r} / {cpu_res['baseline_val_recall_at_10']!r}, "
        f"best epoch {card_res['best_epoch']!r} / {cpu_res['best_epoch']!r}")


def phase_learn(dev: torch.device, table_dtype: str | None = None) -> dict[str, int]:
    """The verify drive on the card: the learnable synthetic set through
    `train_val_test`, with f32 tables (`[learn]`), int8 tables
    (`[learn-int8]`) or bf16 tables (`[learn-bf16tab]`). Dim 32 is off the
    tower kernel's gate, so this path runs the tables' gather and row-wise
    Adagrad kernels only."""
    tag = {None: "[learn]", "int8": "[learn-int8]", "bfloat16": "[learn-bf16tab]"}[table_dtype]
    used = (("quantized_pooled_gather", "quantized_rowwise_adagrad") if table_dtype == "int8"
            else ("pooled_gather", "rowwise_adagrad"))
    mcfg = cfg_lib.two_tower_model_config(2000, 500, embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg, table_dtype=table_dtype, query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg_lib.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                               limit_val_batches=4, limit_test_batches=4)
    ds = SyntheticClickstream(2000, 500, seed=11, noise=0.05, latent_dim=4)
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   mcfg, tcfg)
    # --- the path, counted ---------------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    state, res = train_val_test(
        state, step_lib.make_train_step(mcfg, tcfg, dense_opt),
        step_lib.make_eval_step(mcfg, tcfg), mcfg, tcfg,
        Featurizer(mcfg, device="cpu"),  # host batches: the loop's pipeline moves them
        train_batches_factory=lambda ep: ds.batches(1024, 120, split=f"t{ep}"),
        val_batches_factory=lambda: ds.batches(1024, 4, split="val"),
        test_batches_factory=lambda: ds.batches(1024, 4, split="test"))
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    if not 0.45 <= res["baseline_val_auroc"] <= 0.55:
        raise AssertionError(f"{tag} baseline val AUROC {res['baseline_val_auroc']} "
                             "outside 0.45-0.55")
    if res["val_auroc"] < 0.70:
        raise AssertionError(f"{tag} final val AUROC {res['val_auroc']} < 0.70")
    if {k for k, v in launches.items() if v} != set(used):
        raise AssertionError(f"{tag} the path did not go through its kernels alone: {launches}")
    log(f"{tag} baseline_val_auroc={res['baseline_val_auroc']!r} "
        f"val_auroc={res['val_auroc']!r} test_auroc={res['test_auroc']!r} "
        f"train_loss={res['train_loss']!r} examples_per_s={res['examples_per_sec']!r} "
        f"({seconds!r} s in all), launches={ {k: v for k, v in launches.items() if v} }")
    return launches


def post(url: str, payload: dict) -> tuple[dict, float]:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def timed_requests(url: str, payload: dict, label: str, launches_each: int) -> dict:
    """REQ_REPS identical requests; their median latency, and a check that
    together they launched the pooled-gather kernel exactly
    `launches_each * REQ_REPS` times."""
    before = pooled_gather.launches
    outs, lat = [], []
    for _ in range(REQ_REPS):
        out, ms = post(url, payload)
        outs.append(out)
        lat.append(ms)
    launched = pooled_gather.launches - before
    if launched != launches_each * REQ_REPS:
        raise AssertionError(f"{label}: {launched} pooled-gather launches over {REQ_REPS} "
                             f"requests, expected {launches_each} each")
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError(f"{label}: repeated requests disagree")
    log(f"[serve] {label}: median_ms={statistics.median(lat)!r} first_ms={lat[0]!r} "
        f"(n={REQ_REPS}), pooled_gather launches={launched}")
    return outs[0]


def timed_direct(fn, label: str) -> None:
    """Median wall time of a direct call (no HTTP, no JSON), for comparison."""
    lat = []
    for _ in range(REQ_REPS):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"[direct] {label}: median_ms={statistics.median(lat)!r} (n={REQ_REPS})")


# the port's kernels in a trace: those of csrc/ (anonymous namespaces, and the span walk's)
PORT_KERNEL_MARKS = ("(anonymous namespace)::", "sorted_runs::")


def profile_direct(fn, label: str, gathers_per_call: int, calls: int = 10,
                   marker: str = "pooled_gather") -> dict[str, list]:
    """Where a direct call's time goes on the card: `torch.profiler` traces
    the device alone over `calls` calls, after 3 traced warm-up calls that it
    discards (tracing starts late, so without them the first calls' events
    go missing) and whose device work is finished before the window opens.
    The trace must hold `gathers_per_call` launches per call of the gather
    kernel whose name contains `marker`, which shows it is complete; the profiler still drops
    an event now and then in calls of many launches, so an incomplete trace
    is thrown away and the calls traced again, up to `TRACE_TRIES` times.
    Busy time is the union of the device events' intervals (kernels, copies,
    memsets), so nothing is counted twice; the idle share is 1 - busy / wall,
    where wall is the host's clock over the same calls. Returns, by each
    device item's full name (kernels that share a template differ only in
    its arguments), [device ms, launches] per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    warmup = 3
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1)) as prof:
            for step in range(warmup + calls):
                fn()
                if step == warmup - 1:  # no warm-up work may run into the window
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                if step == warmup + calls - 1:
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / calls
                prof.step()
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        gathers = sum(marker in name for _, _, name in spans)
        if gathers == gathers_per_call * calls:
            break
        held = collections.Counter(name for _, _, name in spans).most_common(3)
        log(f"[profile] {label}: trace {attempt} holds {gathers} {marker} launches, "
            f"expected {gathers_per_call * calls}: thrown away (its most frequent device "
            f"items: {held})")
    else:
        raise AssertionError(f"{label}: no complete trace in {TRACE_TRIES} tries")
    busy, (lo, hi) = 0.0, spans[0][:2]
    by_name: dict[str, list] = {}
    for start, end, name in spans:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
        item = by_name.setdefault(name, [0.0, 0])
        item[0] += (end - start) / 1e3 / calls
        item[1] += 1
    busy = (busy + hi - lo) / 1e3 / calls
    log(f"[profile] {label}: wall_ms={wall!r} device_busy_ms={busy!r} "
        f"idle_share={1 - busy / wall!r} device_items={len(spans) / calls!r} "
        f"(per call, {calls} calls)")
    port = [(ms, n) for name, (ms, n) in by_name.items()
            if any(mark in name for mark in PORT_KERNEL_MARKS)]
    log(f"[profile] {label}: the port's kernels {sum(m for m, _ in port)!r} ms in "
        f"{sum(n for _, n in port) / calls!r} launches, other device items (PyTorch's kernels, "
        f"copies, memsets) {sum(m for m, _ in by_name.values()) - sum(m for m, _ in port)!r} ms "
        f"(per call, by item; overlapping items count twice)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {ms!r} ms in {n / calls!r} launches: {name[:160]}")
    return {name: [ms, n / calls] for name, (ms, n) in by_name.items()}


@torch.no_grad()
def phase_serve(dev: torch.device, profile: bool) -> int:
    """The main path first, counted alone: the services are built, the server
    starts and every request is sent, and nothing else runs on the card in
    between. Its answers are checked after, against direct calls, the plain
    lookup and a brute-force top-k; those launches are not counted."""
    rng = np.random.default_rng(1)
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    requests = []
    for n in (1, 100, BAGS):
        users = rng.integers(0, NUM_USERS, n)
        users[::10] = 0  # dropped ids pool to zero
        requests.append({"user_id": users, "product_id": rng.integers(0, NUM_ITEMS, n)})
    split = {"columns": ["user_id", "product_id"],
             "data": [[int(u), int(i)] for u, i in zip(rng.integers(1, NUM_USERS, 64),
                                                       rng.integers(1, NUM_ITEMS, 64))]}
    retrieve_users = [rng.integers(1, NUM_USERS, n) for n in (16, 1000)]

    # --- the main path, counted ------------------------------------------------
    pooled_gather.launches = 0
    scorer = Scorer(model)
    svc = RetrievalService(model)  # exports the corpus once, EXPORT_BATCH ids per launch
    export_launches = pooled_gather.launches
    if export_launches != -(-NUM_ITEMS // EXPORT_BATCH):
        raise AssertionError(f"corpus export made {export_launches} pooled-gather launches")
    if svc.corpus_size != NUM_ITEMS - 1:
        raise AssertionError(f"corpus {svc.corpus_size} != {NUM_ITEMS - 1}")
    server = ModelServer(scorer, host="127.0.0.1", port=0, retrieval=svc).start()
    try:
        invocations = [  # two lookups per request, one per tower
            timed_requests(server.url + "/invocations",
                           {"inputs": {k: v.tolist() for k, v in inputs.items()}},
                           f"/invocations {len(inputs['user_id'])} rows", 2)["predictions"]
            for inputs in requests]
        split_preds = timed_requests(server.url + "/invocations", {"dataframe_split": split},
                                     "/invocations dataframe_split 64 rows", 2)["predictions"]
        retrievals = [  # one user-embedding lookup per EXPORT_BATCH users
            timed_requests(server.url + "/retrieve", {"user_id": users.tolist(), "k": 100},
                           f"/retrieve {len(users)} users k=100",
                           -(-len(users) // EXPORT_BATCH))
            for users in retrieve_users]
    finally:
        server.stop()
    launches = pooled_gather.launches
    log(f"[serve] pooled_gather launches on the main path: {launches} (corpus export "
        f"{export_launches}, the rest from the HTTP requests)")

    # --- checks, not counted -----------------------------------------------------
    for inputs, preds in zip(requests, invocations):
        n = len(inputs["user_id"])
        preds = np.asarray(preds, np.float32)
        if preds.shape != (n,) or not np.isfinite(preds).all():
            raise AssertionError(f"{n} rows: bad predictions shape/values")
        if not ((preds >= 0) & (preds <= 1)).all():
            raise AssertionError(f"{n} rows: probabilities outside [0, 1]")
        np.testing.assert_array_equal(preds, scorer.predict(inputs))
        timed_direct(lambda: scorer.predict(inputs), f"Scorer.predict {n} rows")
        if n == 100:  # the same rows through the plain lookup on the card
            batch = Featurizer(cfg, device=dev)({**inputs, "label": np.zeros(n)})
            pooled = {fc.name: pooled_gather_reference(
                model.tables[fc.table], batch.features[fc.name].ids,
                batch.features[fc.name].mask) for fc in cfg.features}
            q, c = towers_forward(model, pooled, None)
            plain = torch.sigmoid((q * c).sum(1)).cpu().numpy()
            np.testing.assert_allclose(preds, plain, rtol=1e-5, atol=1e-7)
    cols = np.asarray(split["data"])
    np.testing.assert_array_equal(
        np.asarray(split_preds, np.float32),
        scorer.predict({"user_id": cols[:, 0], "product_id": cols[:, 1]}))

    for users, out in zip(retrieve_users, retrievals):
        items = np.asarray(out["items"])
        scores = np.asarray(out["scores"], np.float32)
        if items.shape != (len(users), 100) or not np.isfinite(scores).all():
            raise AssertionError("/retrieve: bad shape or values")
        if not ((items >= 1) & (items < NUM_ITEMS)).all():
            raise AssertionError("/retrieve: item ids outside [1, N)")
        q = export_feature_embeddings(model, "user_id", ids=users)
        full = q @ svc.corpus.T  # brute force on the card
        want = torch.topk(full, 100, dim=1).values.cpu().numpy()
        np.testing.assert_allclose(scores, want, rtol=1e-5, atol=0)
        got = torch.gather(full, 1, torch.from_numpy(items - 1).to(dev)).cpu().numpy()
        np.testing.assert_allclose(scores, got, rtol=1e-5, atol=0)
        timed_direct(lambda: svc.retrieve(users, k=100),
                     f"RetrievalService.retrieve {len(users)} users k=100")

    if profile:
        for inputs in requests[::2]:
            label = f"Scorer.predict {len(inputs['user_id'])} rows"
            log_gather_ms(f"[direct] {label}:", profile_direct(lambda: scorer.predict(inputs),
                                                               label, 2), "pooled_gather")
        for users in retrieve_users:
            label = f"RetrievalService.retrieve {len(users)} users k=100"
            log_gather_ms(f"[direct] {label}:", profile_direct(
                lambda: svc.retrieve(users, k=100), label, 1), "pooled_gather")
    return launches


@torch.no_grad()
def phase_serve_trained(dev: torch.device, state, cfg, profile: bool, tag: str = "[serve-int8]",
                        gather_name: str = "quantized_pooled_gather") -> dict[str, int]:
    """A trained flagship whose tables are not f32 (the state `[train-int8]`
    or `[train-bf16tab]` ended with, not its export) through `Scorer` and
    `RetrievalService`, every lookup through the kernel `gather_name`; the
    calls are the main path and are counted alone, the answers are checked
    after. Then its export, loaded back as an f32 model, must predict the
    same. Under --profile, the gather's device ms a call."""
    gather = KERNELS[gather_name][0]
    rng = np.random.default_rng(8)
    model = state.model
    requests = []
    for n in (1, 100, BAGS):
        users = rng.integers(0, NUM_USERS, n)
        users[::10] = 0  # dropped ids pool to zero
        requests.append({"user_id": users, "product_id": rng.integers(0, NUM_ITEMS, n)})
    retrieve_users = [rng.integers(1, NUM_USERS, n) for n in (16, 1000)]

    def counted(fn, label, expect):
        before = gather.launches
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        made = gather.launches - before
        if made != expect:
            raise AssertionError(f"{tag} {label}: {made} {gather_name} launches, expected "
                                 f"{expect}")
        log(f"{tag} {label}: {ms!r} ms (first call), {gather_name} "
            f"launches={made}")
        return out

    # --- the main path, counted ------------------------------------------------
    reset_launches()
    scorer = Scorer(model)
    svc = counted(lambda: RetrievalService(model), "corpus export", -(-NUM_ITEMS // EXPORT_BATCH))
    preds = [counted(lambda: scorer.predict(inputs), f"Scorer.predict {len(inputs['user_id'])} "
                     "rows", 2) for inputs in requests]
    retrievals = [counted(lambda: svc.retrieve(users, k=100),
                          f"RetrievalService.retrieve {len(users)} users k=100", 1)
                  for users in retrieve_users]
    launches = read_launches()
    # --- checks, not counted -----------------------------------------------------
    fused = tower_fwd_launches(cfg, [len(r["user_id"]) for r in requests])
    if {k: v for k, v in launches.items() if v and k != gather_name} != (
            {"tower_fwd": fused} if fused else {}):
        raise AssertionError(f"{tag} launches {launches}: only {gather_name} may run, and "
                             f"tower_fwd {fused} times in the bf16 predicts")
    deq = {name: table_f32(t) for name, t in model.tables.items()}
    compute = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    for inputs, got in zip(requests, preds):
        n = len(inputs["user_id"])
        if got.shape != (n,) or not np.isfinite(got).all():
            raise AssertionError(f"{tag} {n} rows: bad predictions shape/values")
        batch = Featurizer(cfg, device=dev)({**inputs, "label": np.zeros(n)})
        pooled = {fc.name: pooled_gather_reference(
            deq[fc.table], batch.features[fc.name].ids, batch.features[fc.name].mask, compute)
            for fc in cfg.features}
        q, c = towers_forward(model, pooled, None)
        plain = torch.sigmoid((q * c).sum(1)).float().cpu().numpy()
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    for users, (items, scores) in zip(retrieve_users, retrievals):
        if items.shape != (len(users), 100) or not np.isfinite(scores).all():
            raise AssertionError(f"{tag} retrieve: bad shape or values")
        q = export_feature_embeddings(model, "user_id", ids=users)
        full = q.float() @ svc.corpus.float().T  # brute force on the card
        want = torch.topk(full, 100, dim=1).values.cpu().numpy()
        np.testing.assert_allclose(scores, want, rtol=1e-5, atol=0)
        at = torch.gather(full, 1, torch.from_numpy(items - 1).to(dev)).cpu().numpy()
        np.testing.assert_allclose(scores, at, rtol=1e-5, atol=0)
    log(f"{tag} predictions within 1e-5 of a plain forward over the tables widened to f32; "
        "top-k scores equal a brute-force top-k's within rtol 1e-5")
    if profile:
        marker = "quantized_gather" if gather_name == "quantized_pooled_gather" else "pooled_gather"
        for inputs in requests:
            label = f"{tag[1:-1]} Scorer.predict {len(inputs['user_id'])} rows"
            log_gather_ms(f"{tag} Scorer.predict {len(inputs['user_id'])} rows:", profile_direct(
                lambda: scorer.predict(inputs), label, 2, marker=marker), marker)
        for users in retrieve_users:
            label = f"{tag[1:-1]} RetrievalService.retrieve {len(users)} users k=100"
            log_gather_ms(f"{tag} RetrievalService.retrieve {len(users)} users k=100:",
                          profile_direct(lambda: svc.retrieve(users, k=100), label, 1,
                                         marker=marker), marker)

    with tempfile.TemporaryDirectory() as path:
        export_model(path, cfg, state)
        loaded = load_scorer(path)
    if loaded.model.cfg.table_dtype is not None or any(
            t.dtype != torch.float32 for t in loaded.model.tables.values()):
        raise AssertionError(f"{tag} the export must be an f32 model naming no table dtype")
    worst = max(float(np.abs(loaded.predict(inputs) - got).max()) for inputs, got in zip(requests, preds))
    if not worst <= 1e-6:
        raise AssertionError(f"{tag} export -> load_scorer predicts {worst} away")
    log(f"{tag} export_model -> load_scorer (f32 tables): predictions within {worst!r} of the "
        f"trained model's (1e-6 allowed)")
    return launches


PIPELINE_K = 32  # cli.train's default --macro-batches: steps a CUDA graph
def pipeline_fast(wire_cache: str) -> list[str]:
    """What the pipeline's --fast passes cli.train, with its wire cache in
    `wire_cache`."""
    return ["--sorted-feature", "user_id", "--block-sorted-kernel", "bfloat16",
            "--compute-dtype", "bfloat16", "--wire-cache", wire_cache]

BCE_RECALL_FLOOR = 0.35  # recall@100 of the smoke BCE run (the JAX pipeline's smoke: 0.374)


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def eval_sizes(rows: int, batch: int = 8192) -> list[int]:
    """The batch sizes of one eval pass over `rows` rows (the last ragged)."""
    return [min(batch, rows - i) for i in range(0, rows, batch)]


def expected_train_launches(train_out: dict, per_step: dict[str, int], eval_batches: list[int],
                            exports: int, gather: str = "pooled_gather",
                            ) -> tuple[dict[str, int], dict[str, int]]:
    """(launches the wrappers count, launches the card runs) of a cli.train
    run on the packed path: Python launches a step's kernels in the
    multi-step's warm-up and capture (WARMUP_STEPS + K steps a capture) and
    in each eager tail step; a replay runs the K captured steps without
    Python. Each eval batch (`eval_batches`: their sizes) gathers from both
    tables (`gather`: #1, or #5 for int8 tables), and so does each retrieval
    export chunk; under bf16 compute (tower_fwd in `per_step`) an eval batch
    of a multiple of 512 rows runs each tower through tower_fwd (the
    retrieval exports run the towers unfused)."""
    steps = sum(e["train_steps"] for e in train_out["epochs"])
    replayed = train_out["replays"] * PIPELINE_K
    python_steps = train_out["captures"] * (step_lib.WARMUP_STEPS + PIPELINE_K) + steps - replayed
    card_steps = train_out["captures"] * step_lib.WARMUP_STEPS + steps
    extra = {gather: 2 * len(eval_batches) + exports}
    if "tower_fwd" in per_step:
        extra["tower_fwd"] = 2 * sum(1 for n in eval_batches if n % 512 == 0)
    counted = {name: n * python_steps + extra.get(name, 0) for name, n in per_step.items()}
    on_card = {name: n * card_steps + extra.get(name, 0) for name, n in per_step.items()}
    return counted, on_card


def phase_pipeline(dev: torch.device, work: str) -> tuple[dict[str, dict[str, int]], dict]:
    """`[pipeline]` the Instacart pipeline through its entry points, in the
    work directory `work`: `cli.instacart_pipeline.main` on the --smoke
    replica (8,000 users, 4,000 products, seed 0), --packed --fast (the
    compact wire through a wire cache built in the run), the flagship widths
    (dim 128, towers [128, 64]), BCE, 3 epochs of batch 8,192, on the card;
    then one epoch of the sampled softmax on the same shards through
    `cli.train` (reusing the cache) and `cli.evaluate_retrieval`. Each run's
    launches are checked against its steps x a step's launches (+ the eval
    batches' and the retrieval exports'); BCE recall@100 over every test
    user must reach BCE_RECALL_FLOOR; the host stages' seconds and the
    cache's build seconds and bytes are printed beside the card's name and
    power limit. Returns the two runs' launches and the pipeline's result
    (the later phases train on its shards)."""
    from two_tower_recommender_model_tpu_torch.cli import (
        evaluate_retrieval as eval_cli,
        instacart_pipeline,
        train as train_cli,
    )

    # --- the path, counted -------------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    out = instacart_pipeline.main(["--work", work, "--smoke", "--packed", "--fast",
                                   "--seed", "0", "--epochs", "3", "--batch-size", "8192",
                                   "--loss", "bce"])
    seconds = time.perf_counter() - t0
    bce_launches = read_launches()
    shards, meta = os.path.join(work, "shards"), out["prepare"]["meta"]
    reset_launches()
    t1 = time.perf_counter()
    softmax = train_cli.main([
        "--data-dir", shards, "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]), "--epochs", "1", "--batch-size", "8192",
        "--loss", "sampled_softmax", "--sparse-learning-rate", "0.1", "--seed", "0",
        "--runs-root", os.path.join(work, "runs"),
        "--export-dir", os.path.join(work, "model-softmax"),
        *pipeline_fast(os.path.join(work, "wirecache"))])  # the BCE run's cache, reused
    softmax_train_s = time.perf_counter() - t1
    softmax_retrieval = eval_cli.main(["--model-dir", os.path.join(work, "model-softmax"),
                                       "--data-dir", shards, "--k", "100",
                                       "--max-users", "10000"])
    softmax_launches = read_launches()
    # a table the half-warp walk does not take: D = 1,024, f32 compute, one epoch
    reset_launches()
    t2 = time.perf_counter()
    wide = train_cli.main([
        "--data-dir", shards, "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]), "--epochs", "1", "--batch-size", "8192",
        "--loss", "bce", "--embedding-dim", str(WIDE_TABLE_DIM), "--seed", "0",
        "--runs-root", os.path.join(work, "runs"), "--sorted-feature", "user_id",
        "--block-sorted-kernel", "float32", "--compute-dtype", "float32",
        "--wire-cache", os.path.join(work, "wirecache")])
    wide_train_s = time.perf_counter() - t2
    wide_launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    rows = out["prepare"]["rows"]
    eval_batches = {split: eval_sizes(rows[split]) for split in ("val", "test")}
    retrieval = out["retrieval"]
    exports = (-(-int(retrieval["num_users"]) // EXPORT_BATCH)
               + -(-meta["num_items"] // EXPORT_BATCH))
    checks = []
    for tag, train_out, launches, per_step, epochs, ret in (
            ("[pipeline]", out["train"], bce_launches, BCE_F32, 3, retrieval),
            ("[pipeline-softmax]", softmax, softmax_launches,
             SOFTMAX_BF16, 1, softmax_retrieval)):
        # baseline + each epoch's validation, and the test eval
        n_eval = (1 + epochs) * eval_batches["val"] + eval_batches["test"]
        counted, on_card = expected_train_launches(train_out, per_step, n_eval, exports)
        made = {k: v for k, v in launches.items() if v}
        if made != counted:
            raise AssertionError(f"{tag} launches {made} != {counted} (steps "
                                 f"{[e['train_steps'] for e in train_out['epochs']]}, captures "
                                 f"{train_out['captures']}, replays {train_out['replays']})")
        if train_out["captures"] != 1 or train_out["replays"] < epochs:
            raise AssertionError(f"{tag} captures {train_out['captures']}, replays "
                                 f"{train_out['replays']}: the epochs did not replay a graph")
        (gen,) = train_out["wire_cache"]
        if train_out["wire_format"] != "compact" or gen["built"] != (tag == "[pipeline]") or any(
                e["train_steps"] != gen["num_batches"] for e in train_out["epochs"]):
            raise AssertionError(f"{tag} wire {train_out['wire_format']}, cache {gen}, steps "
                                 f"{[e['train_steps'] for e in train_out['epochs']]}")
        checks.append((tag, train_out, made, on_card, ret))
    # the D = 1,024 run: #1 and #4 as a step's and the evals' expectation, nothing else
    wide_want, wide_on_card = expected_train_launches(
        wide, BCE_WIDE_F32, 2 * eval_batches["val"] + eval_batches["test"], 0)
    wide_made = {k: v for k, v in wide_launches.items() if v}
    if wide_made != wide_want or wide["captures"] != 1 or not np.isfinite(
            wide["metrics"]["test_auroc"]):
        raise AssertionError(f"[pipeline-wide] launches {wide_made} != {wide_want}, captures "
                             f"{wide['captures']}, metrics {wide['metrics']}")
    bce = out["retrieval"]
    if not bce["recall_at_100"] >= BCE_RECALL_FLOOR:
        raise AssertionError(f"[pipeline] BCE recall@100 {bce['recall_at_100']} < "
                             f"{BCE_RECALL_FLOOR}")
    card = card_line()
    st = out["seconds"]
    log(f"[pipeline] {card}: replica {st['fetch']!r} s ({out['fetch']['orders']} orders, "
        f"{out['fetch']['prior_rows']} prior rows), prepare {st['prepare']!r} s (rows {rows}), "
        f"train {st['train']!r} s, eval {st['retrieval']!r} s, pipeline {seconds!r} s in all; "
        f"softmax epoch train {softmax_train_s!r} s; the wire cache (compact wire, user slot "
        f"delta-encoded): {out['train']['wire_cache'][0]!r}, built in the train stage, reused "
        f"by the softmax run")
    for tag, train_out, made, on_card, ret in checks:
        m = train_out["metrics"]
        epochs = train_out["epochs"]
        log(f"{tag} {card}: epochs s {[e['epoch_time_s'] for e in epochs]!r} examples/s "
            f"{[e['examples_per_sec'] for e in epochs]!r} steps "
            f"{[e['train_steps'] for e in epochs]} captures={train_out['captures']} "
            f"replays={train_out['replays']}; baseline_val_auroc={m['baseline_val_auroc']!r} "
            f"val_auroc={m['val_auroc']!r} test_auroc={m['test_auroc']!r}; over "
            f"{int(ret['num_users'])} test users at k=100: recall@10={ret['recall_at_10']!r} "
            f"recall@100={ret['recall_at_100']!r} ndcg@100={ret['ndcg_at_100']!r}; launches "
            f"counted {made} (= the steps' and evals' expectation), run on the card {on_card}")
    m = wide["metrics"]
    log(f"[pipeline-wide] {card}: cli.train --embedding-dim {WIDE_TABLE_DIM} (f32 compute, "
        f"the wire cache reused): train {wide_train_s!r} s, epoch examples/s "
        f"{[e['examples_per_sec'] for e in wide['epochs']]!r}, steps "
        f"{[e['train_steps'] for e in wide['epochs']]} captures={wide['captures']} "
        f"replays={wide['replays']}; baseline_val_auroc={m['baseline_val_auroc']!r} "
        f"val_auroc={m['val_auroc']!r} test_auroc={m['test_auroc']!r}; launches counted "
        f"{wide_made} (= the steps' and evals' expectation), run on the card {wide_on_card}")
    return {"pipeline": bce_launches, "pipeline-softmax": softmax_launches,
            "pipeline-wide": wide_launches}, out


RESUME_EPOCHS, RESUME_CRASH_EPOCH = 3, 1  # the first attempt crashes after epoch 1's checkpoint
REGISTRY_NAME = "instacart_two_tower"
PROFILE_K = 3  # steps a graph in [profile-trace]


def smoke_model_config(meta: dict, table_dtype: str) -> cfg_lib.ModelConfig:
    """The model cli.train builds for the smoke shards with --fast's flags."""
    cfg = cfg_lib.two_tower_model_config(meta["num_users"], meta["num_items"], embedding_dim=DIM,
                                         layer_sizes=LAYERS, compute_dtype="bfloat16")
    return cfg if table_dtype == "float32" else dataclasses.replace(cfg, table_dtype=table_dtype)


def restored_state(dev: torch.device, cfg, ckpt_dir: str):
    """The state of the latest checkpoint in `ckpt_dir`, on the card."""
    template, _ = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(1), cfg,
                                              cfg_lib.TrainConfig())
    return Checkpointer(ckpt_dir).restore(template)[0]


def last_checkpoint(ckpt_dir: str) -> dict:
    ckpt = Checkpointer(ckpt_dir)
    return torch.load(os.path.join(ckpt.step_dir(ckpt.latest_step()), STATE_FILE),
                      map_location="cpu", weights_only=True)


def phase_resume(dev: torch.device, work: str, pipeline: dict, table_dtype: str):
    """`[resume]` cli.train with checkpoints on the pipeline's smoke shards,
    uninterrupted, then crashed after epoch RESUME_CRASH_EPOCH's checkpoint
    (an OSError) and restarted with --resume by `resilient_fit`: the two
    runs' last checkpoints (the whole training state) bit for bit equal.
    Each run is counted alone; the restarted run's launches are the
    uninterrupted run's plus one more capture (the restart captures its own
    graph) and one more baseline validation. Returns both runs' launches and
    the restarted run's directories."""
    from two_tower_recommender_model_tpu_torch.cli import train as train_cli

    tag = "[resume]" if table_dtype == "float32" else f"[resume-{table_dtype}]"
    per_step = BCE_F32 if table_dtype == "float32" else BCE_INT8
    gather = "pooled_gather" if table_dtype == "float32" else "quantized_pooled_gather"
    shards, meta = os.path.join(work, "shards"), pipeline["prepare"]["meta"]

    def argv(run: str, *extra) -> list[str]:
        return ["--data-dir", shards, "--num-users", str(meta["num_users"]),
                "--num-items", str(meta["num_items"]), "--epochs", str(RESUME_EPOCHS),
                "--batch-size", "8192", "--loss", "bce", "--sparse-learning-rate", "0.1",
                "--seed", "0", "--table-dtype", table_dtype,
                "--runs-root", os.path.join(work, "runs"),
                "--checkpoint-dir", os.path.join(work, f"ckpt-{table_dtype}-{run}"),
                "--export-dir", os.path.join(work, f"model-{table_dtype}-{run}"),
                *pipeline_fast(os.path.join(work, f"wirecache-{table_dtype}-{run}")), *extra]

    class CrashAfterCheckpoint(Checkpointer):
        def save(self, step, state, loader_state=None, extra=None, wait=False):
            super().save(step, state, loader_state, extra, wait)
            if extra["completed_epoch"] == RESUME_CRASH_EPOCH:
                raise OSError(f"injected crash after epoch {RESUME_CRASH_EPOCH}'s checkpoint")

    def attempt(restart: int) -> dict:
        if restart:
            return train_cli.main(argv("crashed", "--resume"))
        train_cli.Checkpointer = CrashAfterCheckpoint
        try:
            return train_cli.main(argv("crashed"))
        finally:
            train_cli.Checkpointer = Checkpointer

    # --- the path, counted: each run alone ---------------------------------------------
    t0 = time.perf_counter()
    reset_launches()
    whole = train_cli.main(argv("whole"))
    whole_launches = read_launches()
    t1 = time.perf_counter()
    reset_launches()
    crashed = resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    crashed_launches = read_launches()
    t2 = time.perf_counter()
    # --- checks, not counted ------------------------------------------------------
    got = last_checkpoint(os.path.join(work, f"ckpt-{table_dtype}-crashed"))
    want = last_checkpoint(os.path.join(work, f"ckpt-{table_dtype}-whole"))
    if got["tensors"].keys() != want["tensors"].keys() or got["step"] != want["step"]:
        raise AssertionError(f"{tag} the last checkpoints hold different tensors or steps: "
                             f"{got['step']} != {want['step']}")
    differ = {k: (got["tensors"][k].float() - t.float()).abs().max().item()
              for k, t in want["tensors"].items() if not bitwise_equal(got["tensors"][k], t)}
    if differ:
        worst = max(differ, key=differ.get)
        raise AssertionError(f"{tag} the resumed run is not bit for bit the uninterrupted run: "
                             f"{len(differ)} tensors differ, the largest by {differ[worst]!r} in "
                             f"{worst}")
    steps = whole["metrics"]["train_steps"]
    if (crashed["restarts"], crashed["resumed_from"], whole["resumed_from"]) != (
            1, (RESUME_CRASH_EPOCH + 1) * steps, None) or "OSError" not in crashed["failures"][0]:
        raise AssertionError(f"{tag} restarts {crashed['restarts']}, resumed from "
                             f"{crashed['resumed_from']}, failures {crashed['failures']}")
    if crashed["metrics"]["test_auroc"] != whole["metrics"]["test_auroc"]:
        raise AssertionError(f"{tag} test AUROC {crashed['metrics']['test_auroc']} != "
                             f"{whole['metrics']['test_auroc']}")
    rows = pipeline["prepare"]["rows"]
    val, test = (eval_sizes(rows[split]) for split in ("val", "test"))
    counted, _ = expected_train_launches(whole, per_step, (1 + RESUME_EPOCHS) * val + test, 0,
                                         gather)
    made = {k: v for k, v in whole_launches.items() if v}
    # the restart's own capture and baseline validation
    baseline, _ = expected_train_launches({"epochs": [], "captures": 0, "replays": 0}, per_step,
                                          val, 0, gather)
    restart = {k: n * crashed["captures"] * (step_lib.WARMUP_STEPS + PIPELINE_K) + baseline[k]
               for k, n in per_step.items()}
    made_crashed = {k: v for k, v in crashed_launches.items() if v}
    want_crashed = {k: counted[k] + restart[k] for k in counted}
    if made != counted or made_crashed != want_crashed:
        raise AssertionError(f"{tag} launches {made} / {made_crashed} != {counted} / "
                             f"{want_crashed}")
    if (whole["captures"], crashed["captures"]) != (1, 1):
        raise AssertionError(f"{tag} captures {whole['captures']}, {crashed['captures']}")
    if not whole["wire_cache"][0]["built"] or crashed["wire_cache"][0]["built"]:
        raise AssertionError(f"{tag} the restart must reuse the cache its first attempt built: "
                             f"{whole['wire_cache']}, {crashed['wire_cache']}")
    saves = whole["checkpoints"]
    log(f"{tag} {card_line()}: uninterrupted {RESUME_EPOCHS} epochs ({steps} steps each) and "
        f"crashed after epoch {RESUME_CRASH_EPOCH} + resumed: the last checkpoints bit for bit "
        f"equal ({len(want['tensors'])} tensors, step {want['step']}); "
        f"restarts={crashed['restarts']} resumed_from={crashed['resumed_from']}; checkpoint "
        f"bytes {saves[-1]['bytes']}, save s {[c['seconds'] for c in saves]!r}, restore s "
        f"{crashed['restore_seconds']!r}; resumed epoch s "
        f"{[e['epoch_time_s'] for e in crashed['epochs']]!r} examples/s "
        f"{[e['examples_per_sec'] for e in crashed['epochs']]!r} (uninterrupted epochs s "
        f"{[e['epoch_time_s'] for e in whole['epochs']]!r}); launches counted {made} and "
        f"{made_crashed} (= the steps' and evals' expectation, the restart's capture and "
        f"baseline eval included); runs {t1 - t0!r} s and {t2 - t1!r} s")
    return whole_launches, crashed_launches, {
        "cfg": smoke_model_config(meta, table_dtype), "out": crashed,
        "ckpt": os.path.join(work, f"ckpt-{table_dtype}-crashed"),
        "export": os.path.join(work, f"model-{table_dtype}-crashed")}


def phase_registry(dev: torch.device, work: str, pipeline: dict, runs: dict):
    """`[registry]` the resumed runs registered from their `ExperimentLogger`
    runs and promoted to Production in turn (f32, then int8: the f32
    version becomes Archived); the registry serves Production on the card
    bit for bit as `load_scorer` serves the run's own export, and through a
    `ModelServer`. Counted: building the registry's scorer and three
    requests. Returns the launches, the scorer and the Production model's
    directory."""
    meta = pipeline["prepare"]["meta"]
    t0 = time.perf_counter()
    reg = ModelRegistry(os.path.join(work, "registry"))
    versions = {}
    for table_dtype, run in runs.items():
        state = restored_state(dev, run["cfg"], run["ckpt"])
        logger = ExperimentLogger(os.path.dirname(run["out"]["run_dir"]),
                                  run_id=os.path.basename(run["out"]["run_dir"]))
        v = register_from_run(reg, REGISTRY_NAME, logger, run["cfg"], state,
                              description=f"{table_dtype} tables, resumed after a crash")
        reg.set_stage(REGISTRY_NAME, v, "Production")
        versions[table_dtype] = v
        del state
        entry = reg.get_version(REGISTRY_NAME, v)
        if entry["run_id"] != logger.run_id or "test_auroc" not in entry["metrics"]:
            raise AssertionError(f"[registry] v{v} carries {entry}")
        got_cfg, got = load_model(reg.model_dir(REGISTRY_NAME, v))
        want_cfg, want = load_model(run["export"])
        if got_cfg != want_cfg or not all(
                np.array_equal(a, b) for a, b in zip(param_leaves(got), param_leaves(want))):
            raise AssertionError(f"[registry] v{v} differs from the run's own export")
    stages = {e["version"]: e["stage"] for e in reg.versions(REGISTRY_NAME)}
    if stages != {versions["float32"]: "Archived", versions["int8"]: "Production"}:
        raise AssertionError(f"[registry] stages {stages}")
    rng = np.random.default_rng(3)
    requests = [{"user_id": rng.integers(0, meta["num_users"], n),
                 "product_id": rng.integers(0, meta["num_items"], n)} for n in (1, 100, BAGS)]
    # --- the path, counted: the registry's scorer on the card, served over HTTP --------
    reset_launches()
    scorer = load_scorer_from_registry(reg.root, REGISTRY_NAME)
    server = ModelServer(scorer, host="127.0.0.1", port=0).start()
    try:
        served = [post(server.url + "/invocations",
                       {"inputs": {k: v.tolist() for k, v in r.items()}})[0]["predictions"]
                  for r in requests]
    finally:
        server.stop()
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    fused = tower_fwd_launches(scorer.model.cfg, [len(r["user_id"]) for r in requests])
    if {k: v for k, v in launches.items() if v} != {"pooled_gather": 2 * len(requests),
                                                      **({"tower_fwd": fused} if fused else {})}:
        raise AssertionError(f"[registry] launches {launches}")
    if scorer.model.device.type != "cuda":
        raise AssertionError("[registry] the registry's scorer is not on the card")
    direct = load_scorer(runs["int8"]["export"])
    for r, preds in zip(requests, served):
        got = scorer.predict(r)
        if not np.array_equal(got, direct.predict(r)):
            raise AssertionError(f"[registry] {len(preds)} rows: the registry's scorer and "
                                 "load_scorer of the run's export disagree")
        np.testing.assert_array_equal(np.asarray(preds, np.float32), got)
    log(f"[registry] {card_line()}: v{versions['float32']} (f32 tables) Archived, "
        f"v{versions['int8']} (int8 tables) Production, each equal to its run's export; "
        f"load_scorer_from_registry(Production) on the card bit for bit load_scorer of the "
        f"export on {[len(r['user_id']) for r in requests]} rows; /invocations answered; "
        f"launches counted { {k: v for k, v in launches.items() if v} }; "
        f"{time.perf_counter() - t0!r} s")
    return launches, scorer, reg.model_dir(REGISTRY_NAME, "Production")


def param_leaves(params: dict) -> list[np.ndarray]:
    """The arrays of a `load_model` params tree, in a fixed order."""
    out = [params["tables"][k] for k in sorted(params["tables"])]
    for tower in ("query_tower", "candidate_tower"):
        for layer in sorted(params[tower]):
            out += [params[tower][layer][p] for p in ("kernel", "bias")]
    return out


def phase_batch_predict(work: str, scorer: Scorer) -> dict[str, int]:
    """`[batch-predict]` the registry's scorer over the smoke test split with
    raw columns (`cli.prepare_instacart` without --packed on the pipeline's
    CSVs, set-up not counted), 8,192 rows a batch: the output's rows, its
    columns, and each batch's predictions bit for bit `Scorer.predict` of
    the same rows."""
    from two_tower_recommender_model_tpu_torch.cli import prepare_instacart

    raw = os.path.join(work, "shards-raw")
    t_prepare = time.perf_counter()
    with contextlib.redirect_stdout(None):
        prepare_instacart.main(["--csv-dir", os.path.join(work, "csv"), "--out", raw,
                                "--seed", "0"])
    t_prepare = time.perf_counter() - t_prepare
    src, out_dir = os.path.join(raw, "test"), os.path.join(work, "scored")
    # --- the path, counted -------------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    index = batch_predict(scorer, src, out_dir, batch_size=8192)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    rows = ShardedDataset(src).total_rows
    batches = -(-rows // 8192)
    if index["total_rows"] != rows:
        raise AssertionError(f"[batch-predict] {index['total_rows']} rows out of {rows}")
    fused = tower_fwd_launches(scorer.model.cfg,
                               [min(8192, rows - i * 8192) for i in range(batches)])
    if {k: v for k, v in launches.items() if v} != {"pooled_gather": 2 * batches,
                                                      **({"tower_fwd": fused} if fused else {})}:
        raise AssertionError(f"[batch-predict] launches {launches} for {batches} batches")
    scored = ShardedDataset(out_dir)
    got = {k: np.concatenate([scored.read_shard(i)[k] for i in range(scored.num_shards)])
           for k in scored.schema()}
    start = 0
    for cols in StreamLoader(src, 8192, shuffle=False, drop_last=False):
        n = len(cols["user_id"])
        if set(got) != set(cols) | {"prediction"}:
            raise AssertionError(f"[batch-predict] columns {sorted(got)}")
        for k, v in cols.items():
            np.testing.assert_array_equal(got[k][start:start + n], v)
        if not np.array_equal(got["prediction"][start:start + n], scorer.predict(cols)):
            raise AssertionError(f"[batch-predict] rows {start}-{start + n}: predictions differ "
                                 "from Scorer.predict")
        start += n
    log(f"[batch-predict] {card_line()}: {rows} test rows in {batches} batches of 8,192, "
        f"{len(index['shards'])} output shards, each batch's predictions bit for bit "
        f"Scorer.predict's; {seconds!r} s, rows_per_s={rows / seconds!r}; launches counted "
        f"{ {k: v for k, v in launches.items() if v} }; the raw split's prepare (set-up) "
        f"{t_prepare!r} s")
    return launches


def phase_per_user_table(work: str, model_dir: str) -> None:
    """`[per-user-table]` cli.evaluate_retrieval --per-user-table in a child
    process (pandas is loaded there, not here): one CSV row per evaluated
    user, and the mean of its recall_at_100 column equals the run's
    recall@100 to 1e-6."""
    table, metrics_path = os.path.join(work, "per_user.csv"), os.path.join(work, "per_user.json")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "two_tower_recommender_model_tpu_torch.cli.evaluate_retrieval",
         "--model-dir", model_dir, "--data-dir", os.path.join(work, "shards"), "--k", "100",
         "--max-users", "10000", "--per-user-table", table, "--json-out", metrics_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"[per-user-table] the child failed:\n{child.stderr[-4000:]}")
    with open(metrics_path) as f:
        metrics = json.load(f)
    with open(table, newline="") as f:
        rows = list(csv.DictReader(f))
    recall = statistics.fmean(float(r["recall_at_100"]) for r in rows)
    if len(rows) != metrics["num_users"] or abs(recall - metrics["recall_at_100"]) > 1e-6:
        raise AssertionError(f"[per-user-table] {len(rows)} rows for {metrics['num_users']} "
                             f"users, mean recall@100 {recall} != {metrics['recall_at_100']}")
    log(f"[per-user-table] {card_line()}: {len(rows)} rows (one per evaluated user), mean "
        f"recall_at_100 {recall!r} against the run's {metrics['recall_at_100']!r}; child "
        f"process {seconds!r} s")


def phase_profile_trace(dev: torch.device, work: str, pipeline: dict, run: dict) -> dict:
    """`[profile-trace]` the f32 resumed state, PROFILE_K packed steps on
    the smoke shards captured into a graph (counted: the warm-up and
    capture), then `profile_trace` around one replay: the trace must name
    the gather (#1) and row-wise Adagrad (#4) kernels. `device_memory_stats`
    and a `StepTimer` over 5 more replays."""
    t0 = time.perf_counter()
    cfg = run["cfg"]
    tcfg = cfg_lib.TrainConfig(batch_size=8192, sparse_learning_rate=0.1,
                               sorted_feature="user_id", block_sorted_kernel="bfloat16")
    state = restored_state(dev, cfg, run["ckpt"])
    dense_opt = opt_lib.dense_optimizer(tcfg.learning_rate)
    core = step_lib.make_train_step(cfg, tcfg, dense_opt)
    loader = StreamLoader(os.path.join(work, "shards", "train"), 8192, seed=0)
    feat = PrepackedFeaturizer.for_dataset(loader.dataset, cfg, sort_feature="user_id")
    batches = iter(loader)
    stacked = device_put_batch(step_lib.stack_batches(
        [feat(next(batches)) for _ in range(PROFILE_K)]), dev)
    batches.close()
    multi = step_lib.make_multi_step(
        lambda s, pb: core(s, unpack_batch(pb, cfg, pack_label=feat.pack_label)))
    # --- the path, counted: warm-up and capture; then a traced replay --------------------
    reset_launches()
    state, _ = multi(state, stacked)
    launches = read_launches()
    for attempt in range(1, TRACE_TRIES + 1):  # a trace can miss launches: retried, as --profile
        trace_dir = os.path.join(work, f"trace-{attempt}")
        with profile_trace(trace_dir):
            state, _ = multi(state, stacked)
            torch.cuda.synchronize()
        (trace_file,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file)) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        named = {"#1": sorted(n for n in names if "pooled_gather" in n),
                 "#4": sorted(n for n in names if is_rowwise_adagrad(n))}
        if all(named.values()):
            break
        log(f"[profile-trace] trace {attempt} lacks {[k for k, v in named.items() if not v]}: "
            "thrown away")
    else:
        raise AssertionError(f"[profile-trace] no trace named #1 and #4 in {TRACE_TRIES} tries")
    timer = StepTimer(window=5)
    for _ in range(5):
        state, _ = multi(state, stacked)
        torch.cuda.synchronize()
        timer.update(PROFILE_K * 8192)
    # --- checks, not counted ------------------------------------------------------
    want = {k: n * (step_lib.WARMUP_STEPS + PROFILE_K) for k, n in BCE_F32.items()}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"[profile-trace] launches {launches} != {want}")
    kernels = sum(e.get("cat", "").lower() == "kernel" for e in events)
    log(f"[profile-trace] {card_line()}: a replay of {PROFILE_K} steps traced (try {attempt}) "
        f"into {os.path.getsize(os.path.join(trace_dir, trace_file))} bytes, {kernels} kernel "
        f"events, #1 as {named['#1'][0][:70]!r}, #4 as {named['#4'][0][:70]!r}; "
        f"device_memory_stats {device_memory_stats()}; StepTimer {timer.summary()}; launches "
        f"counted {want} (warm-up and capture); {time.perf_counter() - t0!r} s")
    return launches


# --- the bf16 buffer, the ranker, multi-seed, sweeps, parquet and text features -----------

BF16 = torch.bfloat16
MESH_STEPS = 3  # eager sharded steps of [mesh]
SHARD_WORLD = 4  # the ranks whose shard-local work [shard-kernels] runs in turn


def mesh_plan(cfg):
    """The flagship's plan at 2, 4 and 8 devices (user table row-sharded,
    item table table-wise in the bucket of its dim and dtype, the same at
    each), forced onto one rank."""
    plans = {n: plan_sharding(cfg, n) for n in (2, 4, 8)}
    force = {name: spec.strategy for name, spec in plans[2].specs.items()}
    bucket = "__tw_bucket_d128_int8__" if cfg.table_dtype == "int8" else "__tw_bucket_d128__"
    if force != {"t_user_id": "row_sharded", "t_product_id": "table_wise"} or any(
            {k: v.strategy for k, v in p.specs.items()} != force or set(p.buckets) != {bucket}
            for p in plans.values()):
        raise AssertionError(f"[mesh] the planner's flagship plans changed: "
                             f"{ {n: p.describe() for n, p in plans.items()} }")
    return plan_sharding(cfg, 1, force=force)


def numpy_start(cfg, seed: int = 0) -> dict:
    """A fresh training state as numpy arrays in `train_state_from_numpy`'s
    layout: tables U(-sqrt(1/N), sqrt(1/N)) (an int8 table's rows
    quantized), towers U(-1/sqrt(in), ...), zero accumulators and Adam
    moments."""
    rng = np.random.default_rng(seed)
    start = {"step": 0, "tables": {}, "adagrad_acc": {}, "item_counts": None}
    for t in cfg.tables:
        bound = (1.0 / t.num_embeddings) ** 0.5
        rows = rng.uniform(-bound, bound, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        if cfg.table_dtype_of(t.name) == "int8":
            values, scales = quantize_rows(torch.from_numpy(rows))
            rows = {"values": values.numpy(), "scales": scales.numpy()}
        start["tables"][t.name] = rows
        start["adagrad_acc"][t.name] = np.zeros(t.num_embeddings, np.float32)
    moments = {}
    for key in ("query_tower", "candidate_tower"):
        sizes = [DIM, *getattr(cfg, key).layer_sizes]
        start[key], moments[key] = {}, {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            start[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-a ** -0.5, a ** -0.5, (a, b)).astype(np.float32),
                "bias": rng.uniform(-a ** -0.5, a ** -0.5, b).astype(np.float32)}
            moments[key][f"layer_{i}"] = {"kernel": np.zeros((a, b), np.float32),
                                          "bias": np.zeros(b, np.float32)}
    start["adam"] = {"count": 0, "mu": moments, "nu": moments}
    return start


def sharded_step(cfg, tcfg, dense_opt, mesh, plan):
    """The sharded train step over packed batches."""
    return make_packed_train_step(make_sharded_train_step(cfg, tcfg, dense_opt, mesh, plan), cfg,
                                  pack_label=True)


def one_device_step(cfg, tcfg, dense_opt):
    return make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                  pack_label=True)


def counted_steps(tag: str, step, state, pool: list, per_step: dict[str, int]):
    """MESH_STEPS steps of the main path, counted: each must launch every
    kernel as often as `per_step` says. Returns (state, last out, per-step
    ms, launches)."""
    reset_launches()
    state, out, times = timed_steps(step, state, pool, 0, MESH_STEPS)
    launches = read_launches()
    for name, n in launches.items():
        if n != per_step.get(name, 0) * MESH_STEPS:
            raise AssertionError(f"{tag} {name}: {n} launches in {MESH_STEPS} steps, expected "
                                 f"{per_step.get(name, 0)} a step")
    return state, out, times, launches


def held_states(tag: str, got, want, rtol: float = 1e-4, atol: float = 1e-6,
                table_atol: float | None = None) -> str:
    """`got` against `want`, tensor by tensor (`state_tensors`): int8 values
    within one step, the rest within rtol / atol (the tables' rows within
    `table_atol` where given). Returns how many were bit for bit and the
    largest differences."""
    a, b = state_tensors(got), state_tensors(want)
    if a.keys() != b.keys():
        raise AssertionError(f"{tag} the states hold different tensors")
    diffs, bitwise = {}, 0
    tables = set(got.model.tables)
    for name in b:
        g, w = a[name].float(), b[name].float()
        diffs[name] = (g - w).abs().max().item() if g.numel() else 0.0
        bitwise += bitwise_equal(a[name], b[name])
        if a[name].dtype == torch.int8:
            if diffs[name] > 1:
                raise AssertionError(f"{tag} {name}: int8 values {diffs[name]} steps apart")
        elif name in tables and table_atol is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=table_atol,
                                       msg=lambda m: f"{tag} {name}: {m}")
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{tag} {name}: {m}")
    return (f"{bitwise} of {len(b)} state tensors bit for bit, largest abs diffs "
            f"{ {n: d for n, d in diffs.items() if d} }")


def check_loss(tag: str, got: dict, want: dict, rtol: float = 1e-5) -> str:
    g, w = got["loss"].float().item(), want["loss"].float().item()
    if not np.isfinite(g) or abs(g - w) > rtol * abs(w):
        raise AssertionError(f"{tag} loss {g!r} against {w!r} (rtol {rtol})")
    return f"loss {g!r} / {w!r}"


def graph_against_eager(tag: str, cfg, tcfg, dense_opt, mesh, plan, base, pool: list, step,
                        per_step: dict[str, int]):
    """K = GRAPH_K sharded steps as one CUDA graph (`make_sharded_multi_step`,
    the collectives captured; its warm-up and capture counted) against the
    same steps run eagerly by `step`: bit for bit, the losses too. Returns
    (launches, multi, graphed state, the comparison's text)."""
    k = GRAPH_K
    eager, graphed = shard_train_state(base, plan, mesh), shard_train_state(base, plan, mesh)
    multi = make_sharded_multi_step(cfg, tcfg, dense_opt, mesh, plan, pack_label=True)
    macro = [pool[i % len(pool)] for i in range(k)]
    losses, overflow = [], 0
    for pb in macro:
        eager, out = step(eager, pb)
        losses.append(out["loss"].float())
        overflow += int(out.get("exchange_overflow", 0))
    reset_launches()
    graphed, out_g = multi(graphed, stack_on_card(macro))
    torch.cuda.synchronize()
    captured = read_launches()
    for name, n in captured.items():
        if n != per_step.get(name, 0) * (k + step_lib.WARMUP_STEPS):
            raise AssertionError(f"{tag} {name}: {n} launches for the macro's warm-up and "
                                 f"capture, expected {per_step.get(name, 0)} a step")
    same = compare_states(f"{tag} the sharded macro after {k} steps", eager, graphed)
    if not same.startswith("bit for bit") or not bitwise_equal(out_g["loss"].float(),
                                                               torch.stack(losses)):
        raise AssertionError(f"{tag} the captured sharded macro is not the eager steps bit "
                             f"for bit: {same}")
    if ("exchange_overflow" in out_g) != ("exchange_overflow" in out) or \
            int(out_g.get("exchange_overflow", 0)) != overflow:
        raise AssertionError(f"{tag} the macro's overflow {out_g.get('exchange_overflow')} "
                             f"against the eager steps' {overflow}")
    return captured, multi, graphed, same


def one_device_graph(cfg, tcfg, dense_opt, base, pool: list):
    """The one-device step's K = GRAPH_K graph from a copy of `base`,
    captured: (multi, state)."""
    multi = step_lib.make_multi_step(one_device_step(cfg, tcfg, dense_opt))
    state = base.copy()
    multi(state, stack_on_card([pool[i % len(pool)] for i in range(GRAPH_K)]))
    return multi, state


def replayed_ms(graphs: dict, pool: list) -> dict[str, float]:
    """Median replayed ms a step of each captured graph ({label: (multi,
    state)}) over GRAPH_MACROS macros of distinct payloads, interleaved."""
    times = {label: [] for label in graphs}
    for j in range(1, 1 + GRAPH_MACROS):
        stacked = stack_on_card([pool[(j + i) % len(pool)] for i in range(GRAPH_K)])
        for label, (fn, st) in graphs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(st, stacked)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
    return {label: statistics.median(t) for label, t in times.items()}


def ms_note(ms: dict[str, float]) -> str:
    return ", ".join(f"{label}={v!r}" for label, v in ms.items())


def phase_meshes(dev: torch.device, pool: list) -> dict[str, dict[str, int]]:
    """`[mesh]`, `[mesh-int8]`, `[mesh-a2a]`, `[mesh-column]`,
    `[serve-mesh]`, `[mesh-softmax]` and `[mesh-compact]` on one one-rank
    NCCL group (NCCL refuses two ranks on one card). Returns each phase's
    launches."""
    launch.initialize_distributed(dev, world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        log(f"[mesh] one-rank {mesh.backend} group on {mesh.device}")
        return {"mesh": phase_mesh(mesh, pool), "mesh-int8": phase_mesh_int8(mesh, pool),
                "mesh-a2a": phase_mesh_a2a(mesh, pool),
                "mesh-column": phase_mesh_column(mesh, pool),
                "serve-mesh": phase_serve_mesh(mesh), "mesh-softmax": phase_mesh_softmax(mesh),
                "mesh-compact": phase_mesh_compact(mesh, pool)}
    finally:
        torch.distributed.destroy_process_group()


def phase_mesh(mesh, pool: list) -> dict[str, int]:
    """`[mesh]`: the sharded step at the flagship widths (bf16 compute, BCE,
    batch 262,144 sorted by user), its plan the planner's at 2-8 devices
    (user table row-sharded through the sorted path, item table table-wise
    in a bucket through the device sort). MESH_STEPS eager sharded steps are
    the main path, counted: #1, #4, #8 and tower_fwd twice a step. Against
    the one-device step from the same numpy start (`numpy_start`): losses,
    tables, accumulators, towers and Adam's moments at the reference's bars
    (rtol 1e-5 the loss, rtol 1e-4 / atol 1e-6 the rest), the largest
    differences printed. Then a K = 16 macro of sharded steps as one CUDA
    graph bit for bit the same steps run eagerly, and the replayed ms a step
    beside the one-device graph's, in this call."""
    tag = "[mesh]"
    cfg, tcfg = flagship_bce()
    plan = mesh_plan(cfg)
    log(f"{tag} the flagship plan at 2-8 devices, forced on 1:\n{plan.describe()}")
    base, dense_opt = step_lib.train_state_from_numpy(numpy_start(cfg), cfg, tcfg, mesh.device)
    step = sharded_step(cfg, tcfg, dense_opt, mesh, plan)
    sh, sh_out, sh_times, launches = counted_steps(tag, step, shard_train_state(base, plan, mesh),
                                                   pool, BCE_F32)
    one, one_out, one_times = timed_steps(one_device_step(cfg, tcfg, dense_opt), base.copy(),
                                          pool, 0, MESH_STEPS)
    note = held_states(tag, unshard_train_state(sh, plan, cfg, mesh, dst=0), one)
    log(f"{tag} {MESH_STEPS} sharded steps against the one-device steps from one numpy start: "
        f"{check_loss(tag, sh_out, one_out)}; {note}; launches per step "
        f"{ {n: v // MESH_STEPS for n, v in launches.items() if v} }; eager median_step_ms "
        f"sharded={statistics.median(sh_times)!r} one-device={statistics.median(one_times)!r}")
    del sh, one
    captured, multi, graphed, same = graph_against_eager(tag, cfg, tcfg, dense_opt, mesh, plan,
                                                         base, pool, step, BCE_F32)
    for name in captured:
        launches[name] += captured[name]
    ms = replayed_ms({"sharded": (multi, graphed),
                      "one-device": one_device_graph(cfg, tcfg, dense_opt, base, pool)}, pool)
    log(f"{tag} K={GRAPH_K} sharded steps as one CUDA graph (NCCL collectives captured): "
        f"{same}, {GRAPH_K} losses bitwise equal, captures={multi.captures} "
        f"replays={multi.replays}; replayed_ms_per_step {ms_note(ms)} (ratio "
        f"{ms['sharded'] / ms['one-device']!r}, n={GRAPH_MACROS} macros each, interleaved), "
        f"examples_per_s sharded={TRAIN_BATCH / ms['sharded'] * 1e3!r}; {card_line()}")
    return launches


def phase_mesh_int8(mesh, pool: list) -> dict[str, int]:
    """`[mesh-int8]`: `[mesh]` with int8 tables under the planner's int8
    plan at 2-8 devices forced on one (user row-sharded through the sorted
    path, items in `__tw_bucket_d128_int8__`): MESH_STEPS counted sharded
    steps (#5, #6, #8, tower_fwd twice a step) against the one-device int8
    steps (predicted bit for bit; held at int8 values within one step, the
    rest at `[mesh]`'s bars), the K = 16 graph bit for bit the eager steps,
    its replayed ms beside the one-device int8 graph's."""
    tag = "[mesh-int8]"
    cfg, tcfg = flagship_bce()
    cfg = dataclasses.replace(cfg, table_dtype="int8")
    plan = mesh_plan(cfg)
    base, dense_opt = step_lib.train_state_from_numpy(numpy_start(cfg), cfg, tcfg, mesh.device)
    step = sharded_step(cfg, tcfg, dense_opt, mesh, plan)
    sh, sh_out, _, launches = counted_steps(tag, step, shard_train_state(base, plan, mesh), pool,
                                            BCE_INT8)
    one, one_out, _ = timed_steps(one_device_step(cfg, tcfg, dense_opt), base.copy(), pool, 0,
                                  MESH_STEPS)
    whole = unshard_train_state(sh, plan, cfg, mesh, dst=0)
    if not all(isinstance(t, QuantizedTable) for t in whole.model.tables.values()):
        raise AssertionError(f"{tag} the gathered tables are not int8")
    log(f"{tag} plan {sorted(plan.buckets)}; {MESH_STEPS} sharded steps against the one-device "
        f"int8 steps: {check_loss(tag, sh_out, one_out)}; {held_states(tag, whole, one)}; "
        f"launches per step { {n: v // MESH_STEPS for n, v in launches.items() if v} }")
    del sh, one, whole
    captured, multi, graphed, same = graph_against_eager(tag, cfg, tcfg, dense_opt, mesh, plan,
                                                         base, pool, step, BCE_INT8)
    for name in captured:
        launches[name] += captured[name]
    ms = replayed_ms({"sharded int8": (multi, graphed),
                      "one-device int8": one_device_graph(cfg, tcfg, dense_opt, base, pool)},
                     pool)
    log(f"{tag} K={GRAPH_K} graph: {same}; replayed_ms_per_step {ms_note(ms)} (ratio "
        f"{ms['sharded int8'] / ms['one-device int8']!r}); {card_line()}")
    return launches


# the all-to-all step's launches: the sorted user table's #1 and #4, the item owner's #1 and
# #4, the item pool from the answers (#1), the item sender's pre-aggregation #3, the towers'
BCE_A2A = {**BCE_F32, "pooled_gather": 3, "block_sorted_aggregate": 1}
A2A_OVERFLOW_FACTOR = 0.05  # a bucket of 13,112 distinct ids on one rank: most items overflow


def phase_mesh_a2a(mesh, pool: list) -> dict[str, int]:
    """`[mesh-a2a]`: `[mesh]`'s config with `sharded_exchange="alltoall"`,
    capacity 1.25, the item table forced row-sharded (it takes the exchange;
    the user table stays on its sorted path). MESH_STEPS counted steps (#1
    three times a step: the user rows, the owner's rows and the pool from
    the answers; #4, #8, tower_fwd twice, #3 once), no id dropped. Against the
    dense exchange on the same plan: in the bf16 block mode one step from
    one start (the forward and the towers bit for bit; the owner's update
    takes each item's pre-aggregated sum rounded to bf16, as the reference's
    casts `recv_g`, so the item rows' change within 2^-7 x its largest, the
    accumulators within rtol 2^-6); with the block kernels in f32 MESH_STEPS
    steps at the reference's bars (tables atol 1e-5, loss rtol 1e-5), bit
    for bit predicted. The bf16 wire at the reference's bars (rtol 2e-2
    loss, rtol 2e-2 / atol 2e-3 tables). The K = 16 graph with
    `all_to_all_single` captured bit for bit the eager steps, its replayed
    ms beside the dense sharded graph's and the one-device graph's. At
    capacity 0.05 a step's count is nonzero and `train_one_epoch_packed`
    raises the reference's error."""
    tag = "[mesh-a2a]"
    cfg, dense_cfg = flagship_bce()
    plan = plan_sharding(cfg, 1, force={"t_user_id": "row_sharded",
                                        "t_product_id": "row_sharded"})
    tcfg = dataclasses.replace(dense_cfg, sharded_exchange="alltoall",
                               exchange_capacity_factor=1.25)
    routed = alltoall_tables(cfg, tcfg, plan, "t_user_id")
    if routed != {"t_product_id"}:
        raise AssertionError(f"{tag} the exchange takes {routed}, expected the item table")
    base, dense_opt = step_lib.train_state_from_numpy(numpy_start(cfg), cfg, tcfg, mesh.device)
    step = sharded_step(cfg, tcfg, dense_opt, mesh, plan)
    sh, out, times, launches = counted_steps(tag, step, shard_train_state(base, plan, mesh), pool,
                                             BCE_A2A)
    if int(out["exchange_overflow"]) != 0:
        raise AssertionError(f"{tag} {int(out['exchange_overflow'])} ids overflowed")
    # the bf16 block mode: one step each way from one start
    dense_step = sharded_step(cfg, dense_cfg, dense_opt, mesh, plan)
    start = shard_train_state(base, plan, mesh)
    a, a_out = step(shard_train_state(base, plan, mesh), pool[0])
    d, d_out = dense_step(shard_train_state(base, plan, mesh), pool[0])
    if not bitwise_equal(a_out["loss"], d_out["loss"]):
        raise AssertionError(f"{tag} the forward is not the dense exchange's bit for bit")
    at, dt, st = state_tensors(a), state_tensors(d), state_tensors(start)
    differ = {}
    for name in dt:
        if bitwise_equal(at[name], dt[name]):
            continue
        if not name.startswith("t_product_id"):
            raise AssertionError(f"{tag} {name} differs from the dense exchange's")
        diff = (at[name] - dt[name]).abs().max().item()
        differ[name] = diff
        if name.endswith(".acc"):
            torch.testing.assert_close(at[name], dt[name], rtol=2.0 ** -6, atol=1e-12)
        elif diff > 2.0 ** -7 * (dt[name] - st[name]).abs().max().item():
            raise AssertionError(f"{tag} {name} {diff} from the dense exchange's")
    log(f"{tag} one step from one start against the dense exchange (bf16 block mode): the loss "
        f"bit for bit, {len(dt) - len(differ)} of {len(dt)} state tensors bit for bit, the item "
        f"table's rows and accumulators (each item's pre-aggregated sum rounded to bf16 before "
        f"#4) within 2^-7 x the largest change / rtol 2^-6: max abs diffs {differ!r}")
    del a, d, start
    # the block kernels in f32: MESH_STEPS steps each way
    f32 = {"block_sorted_kernel": "float32"}
    a, a_out, _ = timed_steps(sharded_step(cfg, dataclasses.replace(tcfg, **f32), dense_opt, mesh,
                                           plan), shard_train_state(base, plan, mesh), pool, 0,
                              MESH_STEPS)
    d, d_out, _ = timed_steps(sharded_step(cfg, dataclasses.replace(dense_cfg, **f32), dense_opt,
                                           mesh, plan), shard_train_state(base, plan, mesh),
                              pool, 0, MESH_STEPS)
    log(f"{tag} block kernels in f32, {MESH_STEPS} steps against the dense exchange: "
        f"{check_loss(tag, a_out, d_out)}; {held_states(tag, a, d, table_atol=1e-5)}")
    del a, d
    # the bf16 wire against the f32 wire
    w, w_out, _ = timed_steps(sharded_step(cfg, dataclasses.replace(
        tcfg, exchange_wire_dtype="bfloat16"), dense_opt, mesh, plan),
        shard_train_state(base, plan, mesh), pool, 0, MESH_STEPS)
    a, b = state_tensors(w), state_tensors(sh)
    wire_diff = {}
    for name in ("t_user_id", "t_product_id"):
        torch.testing.assert_close(a[name], b[name], rtol=2e-2, atol=2e-3,
                                   msg=lambda m: f"{tag} bf16 wire {name}: {m}")
        wire_diff[name] = (a[name] - b[name]).abs().max().item()
    log(f"{tag} exchange_wire_dtype=bfloat16, {MESH_STEPS} steps against the f32 wire: "
        f"{check_loss(tag, w_out, out, rtol=2e-2)}; tables within rtol 2e-2 / atol 2e-3, max "
        f"abs diffs {wire_diff!r}")
    del w, sh
    # a capacity that overflows
    small = dataclasses.replace(tcfg, exchange_capacity_factor=A2A_OVERFLOW_FACTOR)
    _, o_out = sharded_step(cfg, small, dense_opt, mesh, plan)(
        shard_train_state(base, plan, mesh), pool[0])
    dropped = int(o_out["exchange_overflow"])
    if dropped <= 0:
        raise AssertionError(f"{tag} capacity {A2A_OVERFLOW_FACTOR}: no id overflowed")
    host = [map_leaves(pb, lambda t: t.cpu()) for pb in pool[:2]]
    try:
        train_one_epoch_packed(shard_train_state(base, plan, mesh),
                               make_sharded_multi_step(cfg, small, dense_opt, mesh, plan),
                               host, lambda pb: pb, macro=2, num_workers=1, train_cfg=small,
                               sharding=macro_batch_sharding(mesh))
        raise AssertionError(f"{tag} train_one_epoch_packed did not raise on the overflow")
    except RuntimeError as e:
        if "the alltoall exchange dropped" not in str(e):
            raise
        raised = str(e).split(" — ")[0]
    log(f"{tag} capacity factor {A2A_OVERFLOW_FACTOR}: a step's exchange_overflow={dropped} "
        f"(forward and backward); train_one_epoch_packed raised: {raised!r}")
    # K steps as one graph, all_to_all_single captured
    captured, multi, graphed, same = graph_against_eager(tag, cfg, tcfg, dense_opt, mesh, plan,
                                                         base, pool, step, BCE_A2A)
    for name in captured:
        launches[name] += captured[name]
    dense_multi = make_sharded_multi_step(cfg, dense_cfg, dense_opt, mesh, plan, pack_label=True)
    dense_graphed = shard_train_state(base, plan, mesh)
    dense_multi(dense_graphed, stack_on_card([pool[i % len(pool)] for i in range(GRAPH_K)]))
    ms = replayed_ms({"alltoall": (multi, graphed), "dense": (dense_multi, dense_graphed),
                      "one-device": one_device_graph(cfg, dense_cfg, dense_opt, base, pool)},
                     pool)
    log(f"{tag} K={GRAPH_K} graph (all_to_all_single captured): {same}; eager median_step_ms "
        f"{statistics.median(times)!r}; replayed_ms_per_step {ms_note(ms)} (ratio to dense "
        f"{ms['alltoall'] / ms['dense']!r}); {card_line()}")
    return launches


# the column-sharded item table's step: the user table's #1 and #4, the item slice's #1 and
# #3, the towers' kernels
BCE_COLUMN = {"pooled_gather": 2, "rowwise_adagrad": 1, "block_sorted_aggregate": 1,
              "tower_bwd": 2, "tower_fwd": 2}


def phase_mesh_column(mesh, pool: list) -> dict[str, int]:
    """`[mesh-column]`: `[mesh]`'s config with the item table forced
    column-sharded (f32): the pools of one batch bit for bit the one-device
    step's; MESH_STEPS counted steps (#1 twice, #4 once, #3 once, the towers'
    kernels twice a step) against the one-device steps, the tables within
    atol 1e-5 (the accumulator's sum of squares in another order than #4's
    mean); the K = 16 graph bit for bit the eager steps, its replayed ms
    beside the one-device graph's."""
    tag = "[mesh-column]"
    cfg, tcfg = flagship_bce()
    plan = plan_sharding(cfg, 1, force={"t_user_id": "row_sharded",
                                        "t_product_id": "column_sharded"})
    base, dense_opt = step_lib.train_state_from_numpy(numpy_start(cfg), cfg, tcfg, mesh.device)
    sh = shard_train_state(base, plan, mesh)
    batch = unpack_batch(pool[0], cfg, pack_label=True)
    _, sharded_pool = make_sharded_forward(cfg, mesh, plan, block_sorted_feature="user_id",
                                           block_sorted_dtype="bfloat16", train_cfg=tcfg)
    with torch.no_grad():
        got = sharded_pool(sh.model.tables, batch)[0]
        want = two_tower_pooled(base.model.tables, batch, cfg, block_sorted_feature="user_id",
                                block_sorted_dtype="bfloat16")
    for name in want:
        if not bitwise_equal(got[name], want[name]):
            raise AssertionError(f"{tag} the pool of {name} is not the one-device pool bit for bit")
    step = sharded_step(cfg, tcfg, dense_opt, mesh, plan)
    sh, sh_out, _, launches = counted_steps(tag, step, sh, pool, BCE_COLUMN)
    one, one_out, _ = timed_steps(one_device_step(cfg, tcfg, dense_opt), base.copy(), pool, 0,
                                  MESH_STEPS)
    note = held_states(tag, unshard_train_state(sh, plan, cfg, mesh, dst=0), one,
                       table_atol=1e-5)
    log(f"{tag} the pools of a batch bit for bit the one-device step's; {MESH_STEPS} steps "
        f"against the one-device steps: {check_loss(tag, sh_out, one_out)}; {note}; launches "
        f"per step { {n: v // MESH_STEPS for n, v in launches.items() if v} }")
    del sh, one
    captured, multi, graphed, same = graph_against_eager(tag, cfg, tcfg, dense_opt, mesh, plan,
                                                         base, pool, step, BCE_COLUMN)
    for name in captured:
        launches[name] += captured[name]
    ms = replayed_ms({"column": (multi, graphed),
                      "one-device": one_device_graph(cfg, tcfg, dense_opt, base, pool)}, pool)
    log(f"{tag} K={GRAPH_K} graph: {same}; replayed_ms_per_step {ms_note(ms)}; {card_line()}")
    return launches


SERVE_K = 100  # the retrieval depth of [serve-mesh], as [serve]'s


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Host arrays of one shape and dtype, equal bit for bit."""
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def phase_serve_mesh(mesh) -> dict[str, int]:
    """`[serve-mesh]`: `RetrievalService(mesh=)` at the flagship widths (the
    49,687-item corpus, k = 100), built and asked for 16 and 1,000 users:
    the main path, counted (#1 exports the corpus, 7 launches, and embeds
    each request's users, 1 launch). Its items and scores bit for bit the
    one-device service's. Then 4 ranks' shards of the corpus padded to 4 x
    12,422 rows by hand: each shard's candidates (`topk_shard_candidates`,
    the pad row masked by `valid`) merged (`topk_merge`), bit for bit the
    one-device top-k. The direct calls' ms beside the one-device service's,
    and each shard's and the merge's device ms."""
    tag, dev = "[serve-mesh]", mesh.device
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(3)
    users = {n: rng.integers(1, NUM_USERS, n) for n in (16, 1000)}
    # --- the main path, counted ---------------------------------------------------------------
    reset_launches()
    svc = RetrievalService(model, mesh=mesh)
    got = {n: svc.retrieve(u, k=SERVE_K) for n, u in users.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------------------
    want = {"pooled_gather": -(-NUM_ITEMS // EXPORT_BATCH) + len(users)}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    one = RetrievalService(model)
    for n, u in users.items():
        items, scores = one.retrieve(u, k=SERVE_K)
        if not (bits_equal(got[n][0], items) and bits_equal(got[n][1], scores)):
            raise AssertionError(f"{tag} {n} users: not the one-device service's answer bit "
                                 "for bit")
    corpus, n_rows = one.corpus, one.corpus_size
    rows = -(-n_rows // SHARD_WORLD)
    padded = torch.zeros((SHARD_WORLD * rows, corpus.shape[1]), device=dev)
    padded[:n_rows] = corpus
    q = export_feature_embeddings(model, "user_id", ids=users[1000])
    want_vals, want_idx = chunked_topk(q, corpus, k=SERVE_K)
    shards = [padded[r * rows:(r + 1) * rows] for r in range(SHARD_WORLD)]

    def candidates(r):
        return topk_shard_candidates(q, shards[r], SERVE_K, 4096, r, n_rows)

    parts = [candidates(r) for r in range(SHARD_WORLD)]
    stacked = (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))
    vals, idx = topk_merge(*stacked, SERVE_K)
    torch.cuda.synchronize()
    if not (bitwise_equal(idx, want_idx) and bitwise_equal(vals, want_vals)):
        raise AssertionError(f"{tag} the merge of {SERVE_K} candidates from {SHARD_WORLD} shards "
                             f"is not the one-device top-k bit for bit: "
                             f"{int((idx != want_idx).sum())} rows differ")
    if (stacked[1] >= n_rows).any() or torch.isinf(stacked[0]).any():
        raise AssertionError(f"{tag} a pad row or an empty slot reached the candidates")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    shard_ms = [median_ms(lambda r=r: candidates(r), flush, 10) for r in range(SHARD_WORLD)]
    merge_ms = median_ms(lambda: topk_merge(*stacked, SERVE_K), flush, 10)
    one_ms = median_ms(lambda: chunked_topk(q, corpus, k=SERVE_K), flush, 10)
    direct = {n: (wall_ms(lambda u=u: svc.retrieve(u, k=SERVE_K)),
                  wall_ms(lambda u=u: one.retrieve(u, k=SERVE_K))) for n, u in users.items()}
    log(f"{tag} {card_line()}: the mesh service over the {n_rows}-row corpus, k={SERVE_K}, "
        f"for 16 and 1,000 users: items and scores bit for bit the one-device service's; "
        f"launches {want}; {SHARD_WORLD} shards of {rows} rows by hand (1 pad row masked): the "
        f"merge bit for bit the one-device top-k for 1,000 users; device ms a shard's "
        f"candidates {shard_ms!r}, the merge {merge_ms!r}, the one-device top-k {one_ms!r} "
        f"(n=10); direct-call host ms (mesh, one-device): "
        + ", ".join(f"{n} users {a!r} / {b!r}" for n, (a, b) in direct.items()))
    return launches


def softmax_flagship():
    """`[train-softmax]`'s configuration: f32, batch 8,192 sorted by user,
    logQ, accidental-hit masking, the fused kernels on."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    tcfg = cfg_lib.TrainConfig(batch_size=SOFTMAX_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="float32", loss="sampled_softmax",
                               softmax_kernel="on")
    return cfg, tcfg


def phase_mesh_softmax(mesh) -> dict[str, int]:
    """`[mesh-softmax]`: the sharded step with the data-parallel sampled
    softmax in `[train-softmax]`'s configuration on the one-rank group (its
    stripe is the whole `[8,192, 8,192]` score matrix at row offset 0; the
    candidates all-gathered, their gradient reduce-scattered, the logQ
    counts of the gathered ids), the planner's flagship plan forced on one:
    MESH_STEPS eager sharded steps counted (#1 and #4 twice, #9, #10 and #11
    once a step) against the one-device softmax steps from one numpy start,
    the K = 16 graph with the collectives captured (the reduce-scatter in
    the backward too) bit for bit the eager steps, its replayed ms a step
    beside the one-device graph's."""
    tag = "[mesh-softmax]"
    cfg, tcfg = softmax_flagship()
    plan = mesh_plan(cfg)
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    pool = [map_leaves(feat(cols), lambda t: t.to(mesh.device))
            for cols in ds.batches(SOFTMAX_BATCH, GRAPH_POOL, split="train")]
    start = {**numpy_start(cfg), "item_counts": np.zeros(NUM_ITEMS, np.float32)}
    base, dense_opt = step_lib.train_state_from_numpy(start, cfg, tcfg, mesh.device)
    step = sharded_step(cfg, tcfg, dense_opt, mesh, plan)
    sh, sh_out, sh_times, launches = counted_steps(tag, step, shard_train_state(base, plan, mesh),
                                                   pool, SOFTMAX_F32)
    one, one_out, one_times = timed_steps(one_device_step(cfg, tcfg, dense_opt), base.copy(),
                                          pool, 0, MESH_STEPS)
    whole = unshard_train_state(sh, plan, cfg, mesh, dst=0)
    counted = whole.item_counts.sum().item()
    if counted != MESH_STEPS * SOFTMAX_BATCH:
        raise AssertionError(f"{tag} item_counts sums to {counted}")
    note = held_states(tag, whole, one)
    log(f"{tag} {MESH_STEPS} sharded softmax steps against the one-device steps from one numpy "
        f"start: {check_loss(tag, sh_out, one_out)} (bit for bit: "
        f"{bitwise_equal(sh_out['loss'], one_out['loss'])}); {note}; item_counts sum "
        f"{counted!r}; launches per step { {n: v // MESH_STEPS for n, v in launches.items() if v} }"
        f"; eager median_step_ms sharded={statistics.median(sh_times)!r} "
        f"one-device={statistics.median(one_times)!r}")
    del sh, one, whole
    captured, multi, graphed, same = graph_against_eager(tag, cfg, tcfg, dense_opt, mesh, plan,
                                                         base, pool, step, SOFTMAX_F32)
    for name in captured:
        launches[name] += captured[name]
    ms = replayed_ms({"sharded": (multi, graphed),
                      "one-device": one_device_graph(cfg, tcfg, dense_opt, base, pool)}, pool)
    log(f"{tag} K={GRAPH_K} sharded softmax steps as one CUDA graph (the all-gather, the "
        f"backward's reduce-scatter and the count's all-reduce captured): {same}, {GRAPH_K} "
        f"losses bitwise equal, captures={multi.captures} replays={multi.replays}; "
        f"replayed_ms_per_step {ms_note(ms)} (ratio {ms['sharded'] / ms['one-device']!r}, "
        f"n={GRAPH_MACROS} macros each, interleaved); {card_line()}")
    return launches


def phase_mesh_compact(mesh, pool: list) -> dict[str, int]:
    """`[mesh-compact]`: `[mesh]`'s configuration (the flagship BCE step,
    bf16 compute, batch 262,144 sorted by user) fed `CompactBatch` payloads
    (the user slot delta-encoded) placed by `compact_shardings`, through
    `make_sharded_compact_multi_step` (each rank decodes its slice, the delta
    slot's prefix all-gathered over data inside the graph): the main path,
    counted, is its first call (warm-up, capture, replay; #1, #4, #8 and
    tower_fwd twice a step). After 2 macros of K = 16 its end state bit for
    bit the packed sharded graph's and the one-device compact graph's
    (`[train-compact]`'s), the losses too; the replayed ms a step of the
    three beside each other."""
    tag, k, dev = "[mesh-compact]", GRAPH_K, mesh.device
    cfg, tcfg = flagship_bce()
    plan = mesh_plan(cfg)
    scheme = CompactScheme.from_model(cfg, pack_label=True, delta_feature="user_id")
    cbs = [map_leaves(compact_from_packed(map_leaves(pb, lambda t: t.cpu()), scheme),
                      lambda t: t.to(dev)) for pb in pool]
    placement = compact_shardings(mesh, scheme, TRAIN_BATCH)
    base, dense_opt = step_lib.train_state_from_numpy(numpy_start(cfg), cfg, tcfg, dev)
    one_core = step_lib.make_train_step(cfg, tcfg, dense_opt)
    multis = {
        "sharded compact": make_sharded_compact_multi_step(cfg, tcfg, dense_opt, mesh, plan,
                                                           scheme),
        "sharded packed": make_sharded_multi_step(cfg, tcfg, dense_opt, mesh, plan,
                                                  pack_label=True),
        "one-device compact": step_lib.make_multi_step(make_compact_train_step(one_core, cfg,
                                                                               scheme))}
    states = {"sharded compact": shard_train_state(base, plan, mesh),
              "sharded packed": shard_train_state(base, plan, mesh),
              "one-device compact": base.copy()}
    del base

    def payload(kind, j):
        if kind == "sharded packed":
            return stack_on_card([pool[(j + i) % len(pool)] for i in range(k)])
        stacked = stack_on_card([cbs[(j + i) % len(cbs)] for i in range(k)])
        return device_put_batch(stacked, sharding=placement) if kind.startswith("sharded") \
            else stacked

    # --- the main path, counted: the sharded compact graph's first call ------------------------
    first = payload("sharded compact", 0)
    torch.cuda.synchronize()
    reset_launches()
    states["sharded compact"], out = multis["sharded compact"](states["sharded compact"], first)
    torch.cuda.synchronize()
    launches = read_launches()
    # --- checks, not counted --------------------------------------------------------------------
    calls = k + step_lib.WARMUP_STEPS
    for kernel, n in launches.items():
        if n != BCE_F32.get(kernel, 0) * calls:
            raise AssertionError(f"{tag} {kernel}: {n} launches in {calls} steps, expected "
                                 f"{BCE_F32.get(kernel, 0)} a step")
    losses = {"sharded compact": [out["loss"]]}
    for kind in ("sharded packed", "one-device compact"):
        states[kind], o = multis[kind](states[kind], payload(kind, 0))
        losses[kind] = [o["loss"]]
    for kind in multis:
        states[kind], o = multis[kind](states[kind], payload(kind, 1))
        losses[kind].append(o["loss"])
    whole = unshard_train_state(states["sharded compact"], plan, cfg, mesh, dst=0)
    verdicts = {
        "sharded packed": compare_states(f"{tag} after {2 * k} steps", states["sharded packed"],
                                         states["sharded compact"]),
        "one-device compact": compare_states(f"{tag} after {2 * k} steps",
                                             states["one-device compact"], whole)}
    for kind, verdict in verdicts.items():
        same_losses = all(bitwise_equal(a, b) for a, b in zip(losses[kind],
                                                              losses["sharded compact"]))
        if not verdict.startswith("bit for bit") or not same_losses:
            raise AssertionError(f"{tag} the sharded compact graph is not the {kind} graph bit "
                                 f"for bit: {verdict}; losses equal {same_losses}")
    del whole
    times = {kind: [] for kind in multis}
    for j in range(2, 2 + GRAPH_MACROS):
        for kind in multis:
            p = payload(kind, j)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[kind], _ = multis[kind](states[kind], p)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3 / k)
    ms = {kind: statistics.median(t) for kind, t in times.items()}
    log(f"{tag} {card_line()}: batch {TRAIN_BATCH}, K={k}, the user slot delta-encoded "
        f"({scheme.wire_bytes_per_example} B an example): after {2 * k} steps the sharded "
        f"compact graph's end state against the sharded packed graph's "
        f"{verdicts['sharded packed']}, against the one-device compact graph's "
        f"{verdicts['one-device compact']}, the {2 * k} losses bitwise equal; launches captured "
        f"per step { {n: v // calls for n, v in launches.items() if v} }, captures="
        f"{multis['sharded compact'].captures}; replayed_ms_per_step {ms_note(ms)} "
        f"(n={GRAPH_MACROS} macros each, interleaved, payload copy included)")
    return launches


def phase_shard_softmax(dev: torch.device, d: int = 64) -> None:
    """`[shard-kernels]` the data-parallel softmax's stripes by hand: the
    `[train-softmax]` batch of 8,192 at D = `d` (64, the flagship's; 256,
    `[train-softmax-wide]`'s, the kernels' depth slices) cut in SHARD_WORLD
    stripes of 2,048 rows at row offsets 0, 2,048, 4,096 and 6,144, each
    against all 8,192 columns through #9, #10 and #11 (each launch counted),
    held against their plain versions at
    `[kernel]`'s bars (lse rtol 2e-5 / atol 1e-5; dq and dc within 1e-3 x
    max and cosine > 0.99999, the backward fed the plain lse), each
    stripe's lse bit for bit its rows of #9's on the whole batch;
    the stripes' dc summed against the whole batch's dc (#11 on the square)
    at the dc bar; the stripes' (num, den) summed against the whole batch's
    within rtol 1e-5. Each stripe's kernel ms beside its bound."""
    tag, bk = f"[shard-kernels] D={d}", SOFTMAX_BATCH
    bq = bk // SHARD_WORLD
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    before = read_launches()
    whole, g_whole = softmax_case(dev, np.random.default_rng(5), bk, bk, 0, None, d)
    lse_whole = sk.lse_forward_reference(*whole)
    lse_whole_kernel = sk.softmax_lse_fwd(*whole)
    dc_whole = sk.softmax_lse_dc(*whole, lse_whole, g_whole)
    labels = (g_whole > 0).float()
    q16, c16, adj, ids = whole[0], whole[1], whole[2], whole[3]
    parts_whole = sk.sampled_softmax_fused_parts(q16.float(), c16.float(), labels, ids, ids, adj)
    dc_sum = torch.zeros_like(dc_whole)
    num = den = 0.0
    small = (bq + bk) * (d * 2 + 12)
    striped = read_launches()
    for r in range(SHARD_WORLD):
        off = r * bq
        args, g = softmax_case(dev, np.random.default_rng(5), bq, bk, off, None, d)
        label = f"stripe {r} of {SHARD_WORLD} [{bq} x {bk}, row_offset={off}]"
        lse = sk.softmax_lse_fwd(*args)
        want_lse = sk.lse_forward_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=1e-5)
        if not bitwise_equal(lse, lse_whole_kernel[off:off + bq]):  # #9's chunks follow BK alone
            raise AssertionError(f"{tag} {label}: the stripe's lse differs from its rows of the "
                                 "whole batch's")
        dq, dc = sk.softmax_lse_dq(*args, want_lse, g), sk.softmax_lse_dc(*args, want_lse, g)
        want_dq, want_dc = sk.lse_backward_reference(*args, want_lse, g)
        errs = {"#9": (lse - want_lse).abs().max().item(),
                "#10": grad_close(dq, want_dq, f"{tag} {label} dq"),
                "#11": grad_close(dc, want_dc, f"{tag} {label} dc")}
        dc_sum += dc
        n_, d_ = sk.sampled_softmax_fused_parts(q16[off:off + bq].float(), c16.float(),
                                                labels[off:off + bq], ids[off:off + bq], ids,
                                                adj, row_offset=off)
        num, den = num + n_.item(), den + d_.item()
        calls = {"#9": (lambda: sk.softmax_lse_fwd(*args),
                        bound(small + bq * 4, 2 * bq * bk * d, PEAK_BF16, bq * bk)),
                 "#10": (lambda: sk.softmax_lse_dq(*args, want_lse, g),
                         bound(small + bq * d * 4, 4 * bq * bk * d, PEAK_BF16, bq * bk)),
                 "#11": (lambda: sk.softmax_lse_dc(*args, want_lse, g),
                         bound(small + bk * d * 4, 4 * bq * bk * d, PEAK_BF16, bq * bk))}
        if r == 0:  # the launches of one stripe, before its timing
            made = {k: v - striped[k] for k, v in read_launches().items() if v - striped[k]}
            # the forward twice: the check above and the stripe's (num, den)
            want = {"softmax_lse_fwd": 2, "softmax_lse_dq": 1, "softmax_lse_dc": 1}
            if d > 128:  # each of dq and dc: the p kernel, then its product
                want["softmax_lse_p"] = 2
            if made != want:
                raise AssertionError(f"{tag} stripe 0 launched {made}, expected {want}")
        log(f"{tag} softmax {label}: each kernel against its plain version, max_abs_err "
            f"{errs!r}; launches of stripe 0 {made!r}; kernel ms / bound ms " + ", ".join(
                f"{name} {median_ms(fn, flush, 10)!r} / {b['bound_ms']!r}"
                for name, (fn, b) in calls.items()))
    err = grad_close(dc_sum, dc_whole, f"{tag} the stripes' dc summed")
    got, want = torch.tensor([num, den]), torch.tensor([p.item() for p in parts_whole])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    made = {k: v - before[k] for k, v in read_launches().items() if v - before[k]}
    log(f"{tag} softmax: the {SHARD_WORLD} stripes' dc summed against the whole batch's #11 "
        f"dc: max_abs_err {err!r} (x max {err / dc_whole.abs().max().item()!r}); (num, den) "
        f"summed {got.tolist()!r} against the whole batch's {want.tolist()!r}; launches in all "
        f"(checks and timing) {made!r}; {card_line()}")


def card_table(gen: torch.Generator, n: int, d: int, dtype: str, dev: torch.device):
    """A table of U(-0.5, 0.5) rows on the card, f32 or quantized to int8."""
    rows = torch.rand((n, d), generator=gen, device=dev) - 0.5
    return QuantizedTable(*quantize_rows(rows)) if dtype == "int8" else rows


def table_like(t, rows: int):
    """Zero rows of `t`'s kind and width."""
    parts = [torch.zeros((rows,) + tuple(p.shape[1:]), dtype=p.dtype, device=p.device)
             for p in table_parts(t)]
    return QuantizedTable(*parts) if isinstance(t, QuantizedTable) else parts[0]


def table_slice(t, lo: int, hi: int):
    """A copy of rows [lo, hi) of `t`."""
    parts = [p[lo:hi].clone() for p in table_parts(t)]
    return QuantizedTable(*parts) if isinstance(t, QuantizedTable) else parts[0]


def tables_equal(a, b) -> bool:
    return all(bitwise_equal(x, y) for x, y in zip(table_parts(a), table_parts(b)))


def phase_shard_kernels(dev: torch.device, pool: list, table_dtype: str = "float32") -> None:
    """`[shard-kernels]`: each of SHARD_WORLD ranks' shard-local work run in
    turn on the card, on the gathered global batch of the flagship step
    (262,144 ids, sorted by user), f32 or int8 tables: the user table
    row-sharded (the sorted path: each shard's local ids non-decreasing,
    those below it negative and those above past its rows) and the item
    table as a table-wise bucket (the device-sort path). The partial pools
    (#1, #5 for int8) sum to the one-device gather bit for bit; each shard's
    update (#4, #6 for int8; bf16 gradients as the bf16 block mode passes
    them) equals the matching rows of the one-device update bit for bit, its
    untouched and padded rows unchanged. Each shard's pool and update ms
    beside the one-device calls': every shard walks all the gathered ids."""
    tag = "[shard-kernels]"
    int8 = table_dtype == "int8"
    gather_k, update_k = ("#5", "#6") if int8 else ("#1", "#4")
    cfg, tcfg = flagship_bce()
    cfg = dataclasses.replace(cfg, table_dtype=table_dtype)
    plan = plan_sharding(cfg, SHARD_WORLD, force={"t_user_id": "row_sharded",
                                                  "t_product_id": "table_wise"})
    batch = unpack_batch(pool[0], cfg, pack_label=True)
    rng = torch.Generator(device=dev).manual_seed(7)
    lr, eps = tcfg.sparse_learning_rate, tcfg.adagrad_eps
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for fc_name, tname in (("user_id", "t_user_id"), ("product_id", "t_product_id")):
        spec = plan[tname]
        feat = batch.features[fc_name]
        ids, w = feat.ids[:, 0].contiguous(), feat.mask[:, 0].contiguous()
        n, d = spec.num_embeddings, spec.embedding_dim
        full = card_table(rng, n, d, table_dtype, dev)
        acc = torch.rand(n, generator=rng, device=dev)
        grads = (torch.randn((ids.shape[0], d), generator=rng, device=dev) * 0.1).bfloat16()
        if spec.strategy == "row_sharded":
            rows, base, route = spec.padded_rows // SHARD_WORLD, 0, "sorted"
        else:
            rows = plan.buckets[spec.bucket].rows_per_device
            base, route = spec.owner * rows + spec.bucket_offset, "device sort"
        sentinel = SHARD_WORLD * rows
        keys = torch.where(w > 0, ids + base, sentinel).to(torch.int32)
        flat_ids = torch.where(w > 0, ids, n).to(torch.int32)
        # the one-device calls
        if route == "sorted":
            def one_pool():
                return block_sorted_lookup(full, ids, w, out_dtype=torch.float32)
        else:
            def one_pool():
                return partial_pool(full, ids[:, None], w[:, None], 0)
        want_pool = one_pool()
        upd_fn = step_lib.pick_table_update_fn(cfg, tcfg, "t_user_id" if route == "sorted"
                                               else None, tname, ids.shape[0], quantized=int8)
        want_t, want_a = table_slice(full, 0, n), acc.clone()
        upd_fn(want_t, want_a, flat_ids, grads, lr, eps)
        scratch_t, scratch_a = table_slice(full, 0, n), acc.clone()  # timed in place: the same ids
        one_ms = median_ms(lambda: upd_fn(scratch_t, scratch_a, flat_ids, grads, lr, eps), flush)
        one_pool_ms = median_ms(one_pool, flush)
        # the ranks' shards: the padded global array cut in SHARD_WORLD pieces
        padded_t = table_like(full, SHARD_WORLD * rows)
        padded_a = torch.zeros(SHARD_WORLD * rows, device=dev)
        for dst, src in zip(table_parts(padded_t), table_parts(full)):
            dst[base:base + n] = src
        padded_a[base:base + n] = acc
        got_pool = torch.zeros_like(want_pool)
        shard_ms, pool_ms = [], []
        for r in range(SHARD_WORLD):
            t = table_slice(padded_t, r * rows, (r + 1) * rows)
            a = padded_a[r * rows:(r + 1) * rows].clone()
            if route == "sorted":
                def shard_pool(t=t, r=r):
                    return sorted_partial_rows(t, keys, w, r, out_dtype=torch.float32)
                local = (keys - r * rows).to(torch.int32)
                negative = int((local < 0).sum())
                above = int((local >= rows).sum())
            else:
                def shard_pool(t=t, r=r):
                    return partial_pool(t, keys[:, None], w[:, None], r)
                local = shard_local_ids(keys, r, rows)
                negative, above = 0, int((local == rows).sum())
            got_pool += shard_pool()
            pool_ms.append(median_ms(shard_pool, flush))
            shard_fn = step_lib.pick_table_update_fn(
                cfg, tcfg, tname if route == "sorted" else None, tname, ids.shape[0],
                quantized=int8, table_dtype=table_dtype, num_rows=rows)
            shard_fn(t, a, local, grads, lr, eps)
            torch.cuda.synchronize()
            lo, hi = max(r * rows, base), min((r + 1) * rows, base + n)
            want_rows = table_like(full, rows)
            want_acc = torch.zeros(rows, device=dev)
            if hi > lo:
                for dst, src in zip(table_parts(want_rows), table_parts(want_t)):
                    dst[lo - r * rows:hi - r * rows] = src[lo - base:hi - base]
                want_acc[lo - r * rows:hi - r * rows] = want_a[lo - base:hi - base]
            if not (tables_equal(t, want_rows) and bitwise_equal(a, want_acc)):
                raise AssertionError(f"{tag} {table_dtype} {tname} shard {r}: not the one-device "
                                     f"update's rows bit for bit")
            scratch_t, scratch_a = table_slice(t, 0, rows), a.clone()
            shard_ms.append(median_ms(lambda: shard_fn(scratch_t, scratch_a, local, grads, lr,
                                                       eps), flush))
            log(f"{tag} {table_dtype} {tname} shard {r} of {SHARD_WORLD} ({route}, rows "
                f"[{r * rows}, {(r + 1) * rows}) of the padded {SHARD_WORLD * rows}): {negative} "
                f"local ids below the shard, {above} past it; the update bit for bit the "
                f"one-device update's rows (padded and untouched rows unchanged); {gather_k} "
                f"ms={pool_ms[-1]!r}, {update_k} ms={shard_ms[-1]!r}")
        if not bitwise_equal(got_pool, want_pool):
            raise AssertionError(f"{tag} {table_dtype} {tname}: the {SHARD_WORLD} partial pools "
                                 "do not sum to the one-device gather bit for bit")
        log(f"{tag} {table_dtype} {tname}: the {SHARD_WORLD} partial pools sum to the one-device "
            f"{gather_k} output bit for bit; {gather_k} ms a shard {pool_ms!r} against the "
            f"one-device call's {one_pool_ms!r}; {update_k} ms a shard {shard_ms!r} (sum "
            f"{sum(shard_ms)!r}) against the one-device call's {one_ms!r}, each over all "
            f"{ids.shape[0]} gathered ids; {card_line()}")


def phase_shard_exchange(dev: torch.device, pool: list) -> None:
    """`[shard-kernels]` the all-to-all exchange of the flagship item table
    row-sharded over SHARD_WORLD ranks, by hand: each sender's slice of the
    262,144 ids routed (`a2a_route`, capacity 1.25) and its gradients
    pre-aggregated (#3); the send buffers transposed as `all_to_all_single`
    transposes them; each owner's rows (#1 at one slot) and update (#4 after
    the device sort); each sender's pool from the answers (#1). The pool is
    bit for bit the dense exchange's (one
    slot), the tables within atol 1e-5 of the one-device update (f32
    gradients: the sums' association differs), the overflow the plain
    route's (on the host). Each sender's #3 and each owner's #1 and #4 ms
    beside the one-device #1 and #4."""
    tag = "[shard-kernels]"
    cfg, tcfg = flagship_bce()
    tcfg = dataclasses.replace(tcfg, block_sorted_kernel="float32")
    plan = plan_sharding(cfg, SHARD_WORLD, force={"t_user_id": "row_sharded",
                                                  "t_product_id": "row_sharded"})
    spec = plan["t_product_id"]
    rows, n, d = spec.padded_rows // SHARD_WORLD, spec.num_embeddings, spec.embedding_dim
    feat = unpack_batch(pool[0], cfg, pack_label=True).features["product_id"]
    ids, w = feat.ids[:, 0].contiguous(), feat.mask[:, 0].contiguous()
    b_loc = ids.shape[0] // SHARD_WORLD
    cap = a2a_cap(b_loc, SHARD_WORLD, 1.25, rows)
    rng = torch.Generator(device=dev).manual_seed(9)
    full = torch.rand((n, d), generator=rng, device=dev) - 0.5
    acc = torch.rand(n, generator=rng, device=dev)
    grads = torch.randn((ids.shape[0], d), generator=rng, device=dev) * 0.1
    lr, eps = tcfg.sparse_learning_rate, tcfg.adagrad_eps
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    upd_fn = step_lib.pick_table_update_fn(cfg, tcfg, None, "t_product_id", ids.shape[0],
                                           quantized=False)
    want_pool = pooled_gather(full, ids[:, None], w[:, None], out_dtype=torch.float32)
    want_t, want_a = full.clone(), acc.clone()
    upd_fn(want_t, want_a, torch.where(w > 0, ids, n).to(torch.int32), grads, lr, eps)
    padded_t = torch.zeros((SHARD_WORLD * rows, d), device=dev)
    padded_a = torch.zeros(SHARD_WORLD * rows, device=dev)
    padded_t[:n], padded_a[:n] = full, acc
    shards = [padded_t[r * rows:(r + 1) * rows].clone() for r in range(SHARD_WORLD)]
    accs = [padded_a[r * rows:(r + 1) * rows].clone() for r in range(SHARD_WORLD)]
    # each sender: route, send ids, pre-aggregate
    routes, send_ids, send_g, agg_ms, overflow, plain_overflow = [], [], [], [], 0, 0
    for s in range(SHARD_WORLD):
        sl = slice(s * b_loc, (s + 1) * b_loc)
        f_ids, f_w = ids[sl].to(torch.int32), w[sl]
        resp = a2a_responsible(f_ids, rows, SHARD_WORLD, 1, 0)
        slot, ok, ovf = a2a_route(f_ids, f_w, rows, SHARD_WORLD, cap, resp)
        plain = a2a_route(f_ids.cpu(), f_w.cpu(), rows, SHARD_WORLD, cap, resp.cpu())
        if not (torch.equal(slot.cpu(), plain[0]) and int(ovf) == int(plain[2])):
            raise AssertionError(f"{tag} sender {s}: the route differs from the plain route's")
        overflow, plain_overflow = overflow + int(ovf), plain_overflow + int(plain[2])
        routes.append((slot, ok, f_w))
        send_ids.append(a2a_send_ids(f_ids, slot, ok, SHARD_WORLD * cap, SHARD_WORLD * rows))
        g = grads[sl].contiguous()
        send_g.append(a2a_send_grads(slot, ok, g, SHARD_WORLD * cap))
        agg_ms.append(median_ms(lambda: a2a_send_grads(slot, ok, g, SHARD_WORLD * cap), flush))
    # each owner: its block of every sender's buffers, as all_to_all_single lays them out
    block = lambda bufs, o: torch.cat([b[o * cap:(o + 1) * cap] for b in bufs])  # noqa: E731
    answers, gather_ms, update_ms = [], [], []
    for o in range(SHARD_WORLD):
        recv_ids, recv_g = block(send_ids, o), block(send_g, o)
        answers.append(a2a_owner_rows(shards[o], recv_ids, o, torch.float32))
        gather_ms.append(median_ms(lambda: a2a_owner_rows(shards[o], recv_ids, o, torch.float32),
                                   flush))
        local = shard_local_ids(recv_ids, o, rows)
        scratch_t, scratch_a = shards[o].clone(), accs[o].clone()
        upd_fn(shards[o], accs[o], local, recv_g, lr, eps)
        update_ms.append(median_ms(lambda: upd_fn(scratch_t, scratch_a, local, recv_g, lr, eps),
                                   flush))
    got_pool = torch.cat([a2a_pool(block(answers, s), *routes[s], b_loc, 1)
                          for s in range(SHARD_WORLD)])
    if not bitwise_equal(got_pool, want_pool):
        raise AssertionError(f"{tag} the exchange's pool is not the dense exchange's bit for bit")
    got_t, got_a = torch.cat(shards)[:n], torch.cat(accs)[:n]
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=1e-5,
                               msg=lambda m: f"{tag} the exchange's update: {m}")
    torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=1e-6,
                               msg=lambda m: f"{tag} the exchange's accumulators: {m}")
    one_gather_ms = median_ms(lambda: pooled_gather(full, ids[:, None], w[:, None],
                                                    out_dtype=torch.float32), flush)
    scratch_t, scratch_a = full.clone(), acc.clone()
    flat = torch.where(w > 0, ids, n).to(torch.int32)
    one_update_ms = median_ms(lambda: upd_fn(scratch_t, scratch_a, flat, grads, lr, eps), flush)
    log(f"{tag} all-to-all exchange by hand, {SHARD_WORLD} ranks, item table {rows} rows a "
        f"shard, {b_loc} ids a sender, capacity {cap} a bucket: the pool bit for bit the dense "
        f"exchange's; the tables within atol 1e-5 of the one-device update (max abs diff "
        f"{(got_t - want_t).abs().max().item()!r}); overflow {overflow} (the plain route's "
        f"{plain_overflow}); #3 ms a sender {agg_ms!r}; #1 ms an owner {gather_ms!r} against "
        f"the one-device #1 {one_gather_ms!r}; #4 ms an owner {update_ms!r} against the "
        f"one-device #4 {one_update_ms!r}; {card_line()}")


def phase_shard_columns(dev: torch.device, pool: list) -> None:
    """`[shard-kernels]` the flagship item table column-sharded over
    SHARD_WORLD ranks (32 columns each), by hand: each shard's #1 pool of
    its columns, joined in column order, bit for bit the one-device pool;
    each shard's #3 sums and the epilogue on the rows' squared gradients
    summed over the shards (the all-reduce) within atol 1e-5 of the
    one-device #4 update, the shards' accumulators equal. Each shard's #1
    and #3 ms beside the one-device #1 and #4."""
    tag = "[shard-kernels]"
    cfg, tcfg = flagship_bce()
    tcfg = dataclasses.replace(tcfg, block_sorted_kernel="float32")
    feat = unpack_batch(pool[0], cfg, pack_label=True).features["product_id"]
    ids, w = feat.ids.contiguous(), feat.mask.contiguous()
    n, d = NUM_ITEMS, DIM
    cols = d // SHARD_WORLD
    rng = torch.Generator(device=dev).manual_seed(11)
    full = torch.rand((n, d), generator=rng, device=dev) - 0.5
    acc = torch.rand(n, generator=rng, device=dev)
    grads = torch.randn((ids.shape[0], d), generator=rng, device=dev) * 0.1
    lr, eps = tcfg.sparse_learning_rate, tcfg.adagrad_eps
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flat = torch.where(w[:, 0] > 0, ids[:, 0], n).to(torch.int32)
    want_pool = pooled_gather(full, ids, w, out_dtype=torch.float32)
    upd_fn = step_lib.pick_table_update_fn(cfg, tcfg, None, "t_product_id", ids.shape[0],
                                           quantized=False)
    want_t, want_a = full.clone(), acc.clone()
    upd_fn(want_t, want_a, flat, grads, lr, eps)
    shards = [full[:, c * cols:(c + 1) * cols].contiguous() for c in range(SHARD_WORLD)]
    parts, pool_ms, sums, sums_ms = [], [], [], []
    for c, shard in enumerate(shards):
        parts.append(pooled_gather(shard, ids, w, out_dtype=torch.float32))
        pool_ms.append(median_ms(lambda: pooled_gather(shard, ids, w, out_dtype=torch.float32),
                                  flush))
        g_cols = grads[:, c * cols:(c + 1) * cols].contiguous()
        sums.append(opt_lib.column_grad_sums(n, flat, g_cols))
        sums_ms.append(median_ms(lambda: opt_lib.column_grad_sums(n, flat, g_cols), flush))
    if not bitwise_equal(torch.cat(parts, dim=1), want_pool):
        raise AssertionError(f"{tag} the column shards' pools are not the one-device pool")
    g2 = sum(torch.sum(g * g, dim=1) for g, _ in sums)  # the all-reduce over the shards
    shard_accs = []
    for shard, (g, touched) in zip(shards, sums):
        a = acc.clone()
        opt_lib.column_adagrad_epilogue(shard, a, g, touched, g2, lr, eps, d)
        shard_accs.append(a)
    if not all(bitwise_equal(a, shard_accs[0]) for a in shard_accs):
        raise AssertionError(f"{tag} the column shards' accumulators differ")
    got_t = torch.cat(shards, dim=1)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=1e-5,
                               msg=lambda m: f"{tag} the column update: {m}")
    torch.testing.assert_close(shard_accs[0], want_a, rtol=1e-5, atol=1e-6,
                               msg=lambda m: f"{tag} the column accumulators: {m}")
    one_pool_ms = median_ms(lambda: pooled_gather(full, ids, w, out_dtype=torch.float32), flush)
    scratch_t, scratch_a = full.clone(), acc.clone()
    one_update_ms = median_ms(lambda: upd_fn(scratch_t, scratch_a, flat, grads, lr, eps), flush)
    log(f"{tag} item table column-sharded over {SHARD_WORLD} ranks ({cols} columns each): the "
        f"joined #1 pools bit for bit the one-device pool; the #3 + epilogue update within atol "
        f"1e-5 (max abs diff {(got_t - want_t).abs().max().item()!r}), the shards' "
        f"accumulators equal; #1 ms a shard {pool_ms!r} against the one-device "
        f"{one_pool_ms!r}; #3 ms a shard {sums_ms!r} against the one-device #4 "
        f"{one_update_ms!r}; {card_line()}")


PROBE_ACC = 2.0 ** 60  # the bf16 buffer's probe accumulator (see phase_bf16_buffer_kernels)
PLAIN_REPS = 3  # timed runs of the bf16 buffer's plain version: it loops over the longest run
RANKER_BATCH, RANKER_HIDDEN, RANKER_STEPS = 8192, (128, 64), 3
SEEDS, SEED_STEPS, SEED_BATCH = (0, 1, 2), 4, 8192
SWEEP_STEPS, SWEEP_BATCH = 4, 8192


def phase_bf16_buffer_kernels(dev: torch.device) -> None:
    """`[kernel]` #4 and #6 with the bf16 buffer (`buffer_dtype=bf16`, the
    reference's `scatter_buffer_dtype="bfloat16"`) at the `[train-bf16buf]`
    step's shapes: 262,144 sorted user ids with f32 gradients (the block
    kernels off: the step passes f32), and item ids drawn as rank^-1 through
    the device sort (a hot run of about 21,800 positions, which pass 2 walks
    whole). Each case twice:
    - the probe: every row 0 (int8: values and scales 0), accumulators 2^60,
      lr 1, eps 0, so mean(g^2) adds nothing to an accumulator (it lies
      below half an ulp of 2^60), sqrt(2^60) = 2^30 exactly, and a new row
      is -buffer x 2^-30 in any order of the mean: kernel and plain version
      must agree bit for bit on every output, two launches too;
    - ordinary rows and accumulators: untouched rows bitwise, the rest within
      rtol 1e-5 (int8: scales and accumulators, values within one step).
    Times: the bf16 mode, the f32 mode on the same inputs, and the plain
    version (PLAIN_REPS runs: it loops over the longest run), with the bound
    by bytes (f32 mode's formula)."""
    rng = np.random.default_rng(21)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    ids = rng.integers(0, NUM_USERS, TRAIN_BATCH)
    ids[rng.random(TRAIN_BATCH) < 0.05] = NUM_USERS
    uniform = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev)).values
    skewed, perm = skewed_item_ids(np.random.default_rng(7), TRAIN_BATCH, dev)
    grads = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, DIM)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    for case, n, ids_t, perm_t in (("user f32 sorted", NUM_USERS, uniform, None),
                                   (SKEWED.replace("bf16", "f32"), NUM_ITEMS, skewed, perm)):
        live = torch.zeros(n, dtype=torch.bool, device=dev)
        live[ids_t[ids_t < n].long()] = True
        touched, longest = int(live.sum()), longest_run(ids_t, n)
        for name in ("rowwise_adagrad", "quantized_rowwise_adagrad"):
            int8 = name == "quantized_rowwise_adagrad"
            kernel = quantized_rowwise_adagrad_fused if int8 else rowwise_adagrad
            plain = (quantized_rowwise_adagrad_fused_reference if int8
                     else rowwise_adagrad_reference)

            def table(probe: bool) -> list[torch.Tensor]:
                if int8:
                    if probe:
                        return [torch.zeros((n, DIM), dtype=torch.int8, device=dev),
                                torch.zeros(n, device=dev), torch.full((n,), PROBE_ACC, device=dev)]
                    qt = quantize_table(torch.rand((n, DIM), device=dev, generator=gen) - 0.5)
                    return [qt.values, qt.scales, torch.rand(n, device=dev, generator=gen)]
                if probe:
                    return [torch.zeros((n, DIM), device=dev), torch.full((n,), PROBE_ACC,
                                                                          device=dev)]
                return [torch.rand((n, DIM), device=dev, generator=gen) - 0.5,
                        torch.rand(n, device=dev, generator=gen)]

            def run(fn, parts, lr, eps, buffer=BF16):
                return fn(*parts, ids_t, grads, lr, eps, perm=perm_t, buffer_dtype=buffer)

            label = f"{name} bf16 buffer, {case}: {TRAIN_BATCH} ids into [{n}, {DIM}]"
            start = table(True)
            k1, k2, p = ([t.clone() for t in start] for _ in range(3))
            run(kernel, k1, 1.0, 0.0)
            run(kernel, k2, 1.0, 0.0)
            run(plain, p, 1.0, 0.0)
            torch.cuda.synchronize()
            for a, b, c in zip(k1, k2, p):
                if not bitwise_equal(a, b):
                    raise AssertionError(f"{label}: two launches on the probe differ")
                if not bitwise_equal(a, c):
                    raise AssertionError(f"{label}: the probe's outputs differ from the plain "
                                         f"version's (max abs diff "
                                         f"{(a.float() - c.float()).abs().max().item()!r})")
            f32_mode = [t.clone() for t in start]
            run(kernel, f32_mode, 1.0, 0.0, None)
            torch.cuda.synchronize()
            if bitwise_equal(f32_mode[0], k1[0]):
                raise AssertionError(f"{label}: the bf16 buffer gave the f32 sums' rows")
            del k2, p, f32_mode
            start = table(False)
            k1, p = [t.clone() for t in start], [t.clone() for t in start]
            run(kernel, k1, LR, EPS)
            run(plain, p, LR, EPS)
            torch.cuda.synchronize()
            for a, s in zip(k1, start):
                if not bitwise_equal(a[~live], s[~live]):
                    raise AssertionError(f"{label}: rows no live id names changed")
            if int8:
                if (k1[0].int() - p[0].int()).abs().max().item() > 1:
                    raise AssertionError(f"{label}: int8 values more than one step apart")
                for a, c in zip(k1[1:], p[1:]):
                    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
                err = max((a - c).abs().max().item() for a, c in zip(k1[1:], p[1:]))
            else:
                for a, c in zip(k1, p):
                    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
                err = max((a - c).abs().max().item() for a, c in zip(k1, p))
            ms = median_ms(lambda: run(kernel, k1, LR, EPS), flush)
            f32_ms = median_ms(lambda: run(kernel, k1, LR, EPS, None), flush)
            plain_ms = median_ms(lambda: run(plain, p, LR, EPS), flush, reps=PLAIN_REPS)
            row_bytes = DIM + 8 if int8 else (DIM + 1) * 4  # int8: values, scale and accumulator
            b = bound(TRAIN_BATCH * DIM * 4 + TRAIN_BATCH * (4 if perm_t is None else 8)
                      + touched * row_bytes * 2, 4 * TRAIN_BATCH * DIM, PEAK_F32)
            log(f"[kernel] {label}, {touched} rows touched, longest run {longest}: the probe "
                f"bit for bit the plain version (two launches too; not the f32 sums), ordinary "
                f"rows untouched bitwise and the rest within rtol 1e-5"
                f"{' (int8 values within one step)' if int8 else ''}; max_abs_err={err!r}, "
                f"kernel_ms={ms!r} (the f32 buffer on the same inputs {f32_ms!r}), "
                f"plain_ms={plain_ms!r} (n={PLAIN_REPS}), bound_ms={b['bound_ms']!r} by "
                f"{b['bound_by']}; no single PyTorch call computes it")


def phase_aggregate_perm_kernel(dev: torch.device) -> None:
    """`[kernel]` #3 with the device sort's permutation at the ranker's
    shapes: one feature's 8,192 slots (ids unsorted, a few dead), sorted
    stably on the card, f32 slot rows, into the user table [206,209, 128] and
    the item table [49,688, 128], f32. Bit for bit the CPU's `index_add_` in
    stable-sorted order (the runs are complete: a few positions each), two
    launches bit for bit; `zeros.index_add_` beside it."""
    rng = np.random.default_rng(23)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    for table, n in (("user", NUM_USERS), ("item", NUM_ITEMS)):
        ids = rng.integers(0, n, RANKER_BATCH)
        ids[rng.random(RANKER_BATCH) < 0.02] = n  # missing ids: the sentinel
        rows = torch.from_numpy(rng.normal(size=(RANKER_BATCH, DIM)).astype(np.float32)).to(dev)
        sids, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev), stable=True)
        perm = perm.to(torch.int32)
        got = block_sorted_aggregate(n, sids, rows, perm=perm)
        again = block_sorted_aggregate(n, sids, rows, perm=perm)
        want = block_sorted_aggregate_reference(n, sids.cpu(), rows.cpu(), perm.cpu())
        torch.cuda.synchronize()
        if not bitwise_equal(got, again):
            raise AssertionError(f"block_sorted_aggregate with perm, {table}: two launches differ")
        if not bitwise_equal(got.cpu(), want):
            raise AssertionError(f"block_sorted_aggregate with perm, {table}: not the CPU's "
                                 "ordered sum")
        live = torch.from_numpy(ids < n).to(dev)
        ids64 = torch.from_numpy(ids[ids < n]).to(dev)
        live_rows = rows[live]
        ms = median_ms(lambda: block_sorted_aggregate(n, sids, rows, perm=perm), flush)
        plain_ms = median_ms(
            lambda: block_sorted_aggregate_reference(n, sids, rows, perm=perm), flush)
        library_ms = median_ms(
            lambda: torch.zeros((n, DIM), device=dev).index_add_(0, ids64, live_rows), flush)
        b = bound(RANKER_BATCH * DIM * 4 + RANKER_BATCH * 8 + n * DIM * 4, RANKER_BATCH * DIM,
                  PEAK_F32)
        log(f"[kernel] block_sorted_aggregate with perm (the ranker's table gradient), {table} "
            f"table: {RANKER_BATCH} slots into f32 [{n}, {DIM}] (zeroed by the wrapper, timed "
            f"with it), longest run {longest_run(sids, n)}; bit for bit the CPU's ordered sum, "
            f"two launches bit for bit; kernel_ms={ms!r}, plain_ms={plain_ms!r}, "
            f"bound_ms={b['bound_ms']!r} by {b['bound_by']}, library_ms={library_ms!r} "
            "(zeros.index_add_ on int64 live ids, unsorted)")


def phase_aggregate_bf16_kernel(dev: torch.device) -> dict:
    """`[kernel]` #3's bf16 mode (`buffer_dtype=bf16`: a bf16 table's
    gradient, each id's rows summed in position order from bf16 zero with a
    rounding after every add) at `[ranker-bf16]`'s shapes: one feature's
    8,192 slots (unsorted, 2% dead) sorted stably on the card, f32 slot
    rows, into bf16 [206,209, 128] and [49,688, 128]; and 262,144 item ids
    drawn as rank^-1 (a run of ~21,800 positions, which pass 2 walks whole)
    into bf16 [49,688, 128]. Bit for bit the plain version on the card, two
    launches bit for bit; kernel, f32-mode and plain ms (the plain version
    PLAIN_REPS runs on the skewed ids: it loops over the longest run), the
    bound by bytes, and the library's one call: a bf16 `index_add_` on the
    live ids and the rows in sorted order, prepared for it (it rounds after
    every add too, in an order of its own; how far it lands from the plain
    version is printed). Returns the user-table case's stats, the ranker's
    main path."""
    rng = np.random.default_rng(29)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    cases = []
    for table, n in (("user", NUM_USERS), ("item", NUM_ITEMS)):
        ids = rng.integers(0, n, RANKER_BATCH)
        ids[rng.random(RANKER_BATCH) < 0.02] = n  # missing ids: the sentinel
        sids, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev), stable=True)
        cases.append((f"the ranker's {table} table", n, sids, perm.to(torch.int32), REPS))
    skewed, perm = skewed_item_ids(np.random.default_rng(7), TRAIN_BATCH, dev)
    cases.append(("item ids drawn as rank^-1", NUM_ITEMS, skewed, perm, PLAIN_REPS))
    out = None
    for label, n, sids, perm, plain_reps in cases:
        m = sids.shape[0]
        rows = torch.from_numpy(rng.normal(size=(m, DIM)).astype(np.float32)).to(dev)

        def run(fn):
            return fn(n, sids, rows, perm, buffer_dtype=BF16)

        got, again = run(block_sorted_aggregate), run(block_sorted_aggregate)
        want = run(block_sorted_aggregate_reference)
        torch.cuda.synchronize()
        label = f"block_sorted_aggregate bf16 mode, {label}: {m} slots with perm into bf16 [{n}, {DIM}]"
        if got.dtype != BF16 or not bitwise_equal(got, again):
            raise AssertionError(f"[kernel] {label}: two launches differ")
        if not bitwise_equal(got, want):
            raise AssertionError(f"[kernel] {label}: not the plain version's bits (max abs diff "
                                 f"{(got.float() - want.float()).abs().max().item()!r})")
        live = (sids >= 0) & (sids < n)
        ids64, rows16 = sids[live].long(), rows[perm.long()[live]].to(BF16)

        def aggregate_library():  # on ids and rows prepared for it (int64, bf16, live only)
            return torch.zeros((n, DIM), dtype=BF16, device=dev).index_add_(0, ids64, rows16)

        lib_out = aggregate_library()
        lib_share = (lib_out != want).float().mean().item()
        lib_diff = (lib_out.float() - want.float()).abs().max().item()
        del lib_out
        del again, want
        ms = median_ms(lambda: run(block_sorted_aggregate), flush)
        f32_ms = median_ms(lambda: block_sorted_aggregate(n, sids, rows, perm), flush)
        plain_ms = median_ms(lambda: run(block_sorted_aggregate_reference), flush, reps=plain_reps)
        library_ms = median_ms(aggregate_library, flush)
        # the rows and the ids and permutation read once, the bf16 output written once
        b = bound(m * DIM * 4 + m * 8 + n * DIM * 2, m * DIM, PEAK_F32)
        log(f"[kernel] {label} (zeroed by the wrapper, timed with it), longest run "
            f"{longest_run(sids, n)}: bit for bit the plain version, two launches bit for bit; "
            f"kernel_ms={ms!r} (the f32 mode on the same inputs {f32_ms!r}), plain_ms="
            f"{plain_ms!r} (n={plain_reps}), bound_ms={b['bound_ms']!r} by {b['bound_by']}, "
            f"library_ms={library_ms!r} (bf16 index_add_: rounds after every add, in its own "
            f"order; apart from the plain version on a share {lib_share!r} of elements, by at "
            f"most {lib_diff!r})")
        if out is None:
            out = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": library_ms}
    return out


def bf16_apart(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(the share of elements that differ, the largest difference in bf16
    ulps of `want`, 8 significant bits) of two tensors of bf16 values."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    apart = g != w
    if not apart.any():
        return 0.0, 0.0
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
    return apart.float().mean().item(), ((g - w).abs() / ulp)[apart].max().item()


BF16PARAM_MACROS = 2  # [train-bf16param]: macros of GRAPH_K steps through train_one_epoch_packed


def phase_train_bf16param(dev: torch.device, profile: bool) -> dict[str, int]:
    """`[train-bf16param]` the flagship at `param_dtype="bfloat16"`: bf16
    tables and towers (the towers' Adam `OptaxAdam`, optax's arithmetic in
    bf16, capturable), bf16 compute, batch 262,144 sorted by user id,
    `block_sorted_kernel="off"` (the reference's rule for bf16 tables), as
    `[train-bf16tab]`. The main path, counted: BF16PARAM_MACROS macros of
    GRAPH_K steps through `train_one_epoch_packed` (one capture: its
    warm-up and captured steps launch from Python; #1 and #4 twice a step,
    and under bf16 compute the bf16 towers take #8 and tower_fwd twice a
    step). Then: the state's tensors (tables, accumulators, towers, Adam's
    moments and counts) kept their addresses, the moments moved and count
    the steps (Adam updated in place under capture); eager steps over the
    same batches from a copy of the start end bit for bit where the replays
    do; one step from the trained state against the host CPU's within 2^-7
    x max (`check_against_host`, test_torch_train_step.py's bf16 bar, and
    one bf16 ulp of each stored table value on top: the updated values
    reach 0.03-0.06 in 32 steps, where an ulp, 2^-12, is 3x that bound of a
    step's update, with at most BF16_STORE_APART of a table's values apart;
    rows fed by a sample whose ReLU gate opens on one side only exempt,
    `gate_flip_rows`); the replayed ms a step over
    GRAPH_MACROS macros. (Not
    from a fresh state: there every row's accumulator is 0, the first update
    is the summed gradient over its own rms, and a user's two samples that
    cancel make that direction the summation order's; measured on the card,
    the f32-parameter and f32-table configuration misses 2^-7 x max by 12x
    there as the bf16 one does.)"""
    tag = "[train-bf16param]"
    cfg = dataclasses.replace(
        cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                       layer_sizes=LAYERS, compute_dtype="bfloat16"),
        param_dtype="bfloat16")
    tcfg = cfg_lib.TrainConfig(batch_size=TRAIN_BATCH, sorted_feature="user_id",
                               block_sorted_kernel="off", loss="bce")
    steps = BF16PARAM_MACROS * GRAPH_K
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=0)
    cols = list(ds.batches(TRAIN_BATCH, steps, split="bf16param"))
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    towers = step_lib.tower_parameters(state.model)
    if (type(state.dense_opt_state) is not opt_lib.OptaxAdam
            or {t.dtype for t in state.model.tables.values()} != {BF16}
            or {p.dtype for p in towers} != {BF16}):
        raise AssertionError(f"{tag} not bf16 tables and towers under OptaxAdam")
    step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                  pack_label=True)
    multi = step_lib.make_multi_step(step)
    eager = state.copy()
    addresses = {name: t.data_ptr() for name, t in state_tensors(state).items()}
    start = {name: t.clone() for name, t in state_tensors(state).items()}
    torch.cuda.synchronize()
    # --- the main path, counted ---------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    state, stats = train_one_epoch_packed(state, multi, iter(cols), feat, macro=GRAPH_K,
                                          train_cfg=tcfg)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted ------------------------------------------------------
    calls = GRAPH_K + step_lib.WARMUP_STEPS
    for kernel, n in launches.items():
        if n != BCE_F32.get(kernel, 0) * calls:
            raise AssertionError(f"{tag} {kernel}: {n} launches for {step_lib.WARMUP_STEPS} "
                                 f"warm-up and {GRAPH_K} captured steps, expected "
                                 f"{BCE_F32.get(kernel, 0)} a step")
    if ((multi.captures, multi.replays) != (1, BF16PARAM_MACROS) or state.step != steps
            or stats["train_steps"] != steps):
        raise AssertionError(f"{tag} captures {multi.captures}, replays {multi.replays}, step "
                             f"{state.step}, epoch {stats}")
    now = state_tensors(state)
    if {name: t.data_ptr() for name, t in now.items()} != addresses:
        raise AssertionError(f"{tag} a tensor of the state was replaced")
    opt_state = state.dense_opt_state.state
    for i, p in enumerate(towers):
        if (opt_state[p]["step"].item() != steps or opt_state[p]["exp_avg"].dtype != BF16
                or bitwise_equal(opt_state[p]["exp_avg"], start[f"tower{i}.exp_avg"])
                or bitwise_equal(p.detach(), start[f"tower{i}"])):
            raise AssertionError(f"{tag} tower {i}: Adam's state did not move in place")
    packed = [map_leaves(feat(c), lambda t: t.to(dev)) for c in cols]
    for pb in packed:
        eager, _ = step(eager, pb)
    same = compare_states(f"{tag} after {steps} steps", eager, state)
    if not same.startswith("bit for bit"):
        raise AssertionError(f"{tag} the replayed steps are not the eager steps': {same}")
    del eager
    exempt, samples = gate_flip_rows(state, packed[0])
    rows = sum(int(m.sum()) for m in exempt.values())
    if samples > TRAIN_BATCH // 1000:
        raise AssertionError(f"{tag} {samples} samples whose ReLU gates open on one side only "
                             "(at most 1 in 1,000 allowed)")
    log(f"{tag} after {steps} steps: {samples} samples with a ReLU gate open on one side only, "
        f"their {rows} table rows exempt from the update's bound")
    check_against_host(f"{tag} after {steps} steps:", state, dataclasses.replace(
        cfg, fused_tower_backward="on"), tcfg, dense_opt, step, packed[0], exempt=exempt,
        bf16_store=True)
    replay_ms = []
    for j in range(GRAPH_MACROS):
        stacked = stack_on_card([packed[(j + i) % steps] for i in range(GRAPH_K)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = multi(state, stacked)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
    graph_ms_ = statistics.median(replay_ms)
    log(f"{tag} {card_line()}: flagship bf16 tables {table_bytes(state.model)} bytes and bf16 "
        f"towers (OptaxAdam), bf16 compute, block_sorted_kernel=off, batch {TRAIN_BATCH}: "
        f"{BF16PARAM_MACROS} macros of {GRAPH_K} through train_one_epoch_packed in {seconds!r} "
        f"s (capture included; examples_per_s={stats['examples_per_sec']!r}), launches per "
        f"step { {k: v // calls for k, v in launches.items() if v} } over "
        f"{step_lib.WARMUP_STEPS} warm-up and {GRAPH_K} captured steps, captures=1 replays="
        f"{BF16PARAM_MACROS}; every state tensor kept its address, Adam's moments moved and "
        f"count {steps}; {steps} eager steps from the same start {same}; "
        f"replayed_ms_per_step={graph_ms_!r} (min {min(replay_ms)!r}, n={GRAPH_MACROS} macros "
        f"of distinct payloads), examples_per_s={TRAIN_BATCH / graph_ms_ * 1e3!r}")
    if profile:
        stacked = stack_on_card(packed[:GRAPH_K])
        profile_direct(lambda: multi(state, stacked), f"train-bf16param, replay of {GRAPH_K} "
                       "steps", 2 * GRAPH_K, calls=3)
    return launches


def buffer_modes(cfg, tcfg, pb, dev: torch.device) -> dict[int, object]:
    """{table rows: the buffer dtype} of the sorted table's update in one
    eager step from a fresh state (the device-sorted table's calls go
    through the optimizer module and are not seen)."""
    seen: dict[int, object] = {}
    real = (step_lib.rowwise_adagrad, step_lib.quantized_rowwise_adagrad_fused)

    def spy(fn):
        def call(*args, buffer_dtype=None, **kwargs):
            seen[args[0].shape[0]] = buffer_dtype
            return fn(*args, buffer_dtype=buffer_dtype, **kwargs)
        return call

    step_lib.rowwise_adagrad, step_lib.quantized_rowwise_adagrad_fused = map(spy, real)
    try:
        state, dense_opt = step_lib.create_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, tcfg)
        step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                      pack_label=True)
        step(state, pb)
        torch.cuda.synchronize()
    finally:
        step_lib.rowwise_adagrad, step_lib.quantized_rowwise_adagrad_fused = real
    return seen


def phase_train_bf16buf(dev: torch.device, profile: bool, pool: list) -> dict[str, dict]:
    """`[train-bf16buf]` the flagship BCE at 262,144 in bf16 compute, sorted
    by user id, `block_sorted_kernel="off"`, `scatter_buffer_dtype=
    "bfloat16"`: the user table (206,209 rows <= 8 x 262,144 slots) takes
    the bf16 buffer, the item table the device sort and f32 sums. With f32
    and with int8 tables: the routing seen in one step, then
    `phase_train_graph` (K = 16, eager against replayed, bit for bit) and
    the host check after eager steps; the f32-table config with the f32
    buffer through the same graph, its replayed ms beside."""
    cfg, tcfg = flagship_bce()
    tcfg = dataclasses.replace(tcfg, block_sorted_kernel="off", scatter_buffer_dtype="bfloat16")
    paths = {}
    for name, c, want, marker in (
            ("f32 tables", cfg, BCE_F32, "pooled_gather"),
            ("int8 tables", dataclasses.replace(cfg, table_dtype="int8"), BCE_INT8,
             "quantized_gather")):
        seen = buffer_modes(c, tcfg, pool[0], dev)
        if seen != {NUM_USERS: BF16}:
            raise AssertionError(f"[train-bf16buf] {name}: the sorted table's update took {seen}")
        paths[f"train-bf16buf {name}"] = phase_train_graph(
            dev, f"BCE, {name}, bf16 compute, bf16 buffer", c, tcfg, pool, want, profile,
            marker=marker, tag="[train-bf16buf]")
        host_check_after(f"[train-bf16buf] {name}:", dev, c, tcfg, pool)
    f32_buffer = dataclasses.replace(tcfg, scatter_buffer_dtype="float32")
    seen = buffer_modes(cfg, f32_buffer, pool[0], dev)
    if seen != {NUM_USERS: None}:
        raise AssertionError(f"[train-bf16buf] the f32 buffer's update took {seen}")
    paths["train-bf16buf f32 buffer"] = phase_train_graph(
        dev, "BCE, f32 tables, bf16 compute, f32 buffer (beside)", cfg, f32_buffer, pool,
        BCE_F32, profile, tag="[train-bf16buf]")
    return paths


def ranker_batches(cfg, dev: torch.device, n: int, split: str = "train") -> list:
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=5)
    feat = Featurizer(cfg, device=dev)
    return [feat(cols) for cols in ds.batches(RANKER_BATCH, n, split=split)]


def ranker_plain_lookup(table, ids, mask, pooling, compute_dtype):
    """`pooled_lookup` of the ranker's single-slot features through the
    gather's plain version."""
    w = mask.to(torch.float32)
    if pooling == "mean":
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return pooled_gather_reference(table, ids.to(torch.int32), w, compute_dtype)


@contextlib.contextmanager
def ranker_plain_route():
    """The ranker's kernels #1 and #3 swapped for their plain versions."""
    saved = concat_mlp.pooled_lookup, concat_mlp.block_sorted_aggregate
    concat_mlp.pooled_lookup = ranker_plain_lookup
    concat_mlp.block_sorted_aggregate = block_sorted_aggregate_reference
    try:
        yield
    finally:
        concat_mlp.pooled_lookup, concat_mlp.block_sorted_aggregate = saved


def phase_ranker(dev: torch.device) -> dict[str, int]:
    """`[ranker]` the concat-MLP ranker at flagship widths (206,209 x 49,688
    x 128, hidden (128, 64) -> 1, f32), batch 8,192, RANKER_STEPS Adam steps
    through `make_ranker_train_step` (counted: each step 2 launches of the
    gather #1 forward and 2 of the aggregate #3 for the tables' gradients).
    Then, not counted: the same steps through the plain versions on the card
    (the first step's logits and every Adam first moment within 1e-5 x max,
    the later losses within rtol 1e-4: Adam's first updates are about +-lr
    whatever a gradient's size, so a near-zero gradient that rounds
    differently moves a weight by up to 2 lr), and the first step on the host
    CPU against the card's (the same bounds)."""
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    batches = ranker_batches(cfg, dev, RANKER_STEPS)
    step, init = concat_mlp.make_ranker_train_step(cfg, learning_rate=1e-3)

    def fresh(device):
        state = init(torch.Generator(device=dev).manual_seed(0), RANKER_HIDDEN)
        if device != dev:
            params = state["params"].to(device)
            state = {**state, "params": params,
                     "opt": concat_mlp.dense_optimizer(1e-3).build(params.parameters())}
        return state

    def moments(state) -> dict[str, torch.Tensor]:
        opt = state["opt"]
        return {name: opt.state[p]["exp_avg"].detach().cpu().clone()
                for name, p in state["params"].named_parameters()}

    def run(state, bs, record_first=False):
        outs, first = [], None
        for i, b in enumerate(bs):
            state, out = step(state, b)
            outs.append(out)
            if i == 0 and record_first:
                first = moments(state)
        torch.cuda.synchronize()
        return state, outs, first

    state = fresh(dev)
    torch.cuda.synchronize()
    # --- the main path, counted -----------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    state, outs, _ = run(state, batches)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted -----------------------------------------------------------
    want = {"pooled_gather": 2 * RANKER_STEPS, "block_sorted_aggregate": 2 * RANKER_STEPS}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"[ranker] launches {launches}, expected {want}")
    losses = [o["loss"].item() for o in outs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[ranker] losses {losses}")
    _, kouts, kfirst = run(fresh(dev), batches, record_first=True)
    with ranker_plain_route():
        _, pouts, pfirst = run(fresh(dev), batches, record_first=True)
    host_batch = map_leaves(batches[0], lambda t: t.cpu())
    t_host = time.perf_counter()
    _, houts, hfirst = run(fresh(torch.device("cpu")), [host_batch], record_first=True)
    t_host = time.perf_counter() - t_host
    step_ms = []  # steps after the first calls' set-up, each ended by a synchronize
    for b in batches:
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    margins = {}
    for other, outs_o, first_o in (("plain", pouts, pfirst), ("host", houts, hfirst)):
        d = (kouts[0]["logits"].cpu() - outs_o[0]["logits"].cpu()).abs().max().item()
        margin = d / (1e-5 * outs_o[0]["logits"].abs().max().item())
        for name, m in first_o.items():
            diff = (kfirst[name] - m).abs().max().item()
            margin = max(margin, diff / (1e-5 * max(m.abs().max().item(), 1e-30)))
        for ko, oo in zip(kouts[1:], outs_o[1:]):
            margin = max(margin, abs(ko["loss"].item() - oo["loss"].item())
                         / (1e-4 * abs(oo["loss"].item())))
        if margin > 1:
            raise AssertionError(f"[ranker] against the {other} route: margin {margin!r}")
        margins[other] = margin
    log(f"[ranker] {card_line()}: the concat-MLP ranker, tables [{NUM_USERS}, {DIM}] + "
        f"[{NUM_ITEMS}, {DIM}] and MLP {2 * DIM} -> {RANKER_HIDDEN} -> 1 in f32, batch "
        f"{RANKER_BATCH}, {RANKER_STEPS} Adam steps in {seconds!r} s (the first calls' "
        f"set-up included; {RANKER_STEPS} more steps median_step_ms="
        f"{statistics.median(step_ms)!r}, eager), losses {losses}; launches counted "
        f"{ {k: v for k, v in launches.items() if v} }; against the plain route on the card and "
        f"the host CPU ({t_host!r} s a step): first-step logits and Adam moments within 1e-5 x "
        f"max, later losses within rtol 1e-4, margins {margins!r}")
    return launches


def phase_ranker_bf16(dev: torch.device) -> dict[str, int]:
    """`[ranker-bf16]` `[ranker]` at `param_dtype="bfloat16"`: the flagship
    widths (206,209 x 49,688 x 128, hidden (128, 64) -> 1) in bf16, f32
    compute, batch 8,192, RANKER_STEPS steps of one `OptaxAdam` over the
    tables and the MLP (counted: each step 2 launches of the gather #1 and 2
    of #3 in its bf16 mode for the tables' bf16 gradients). Then, not
    counted: one step from the fresh state through the plain versions on
    the card, whose tables must equal the kernels' bit for bit (the rest
    printed); the same step on the host CPU, where each parameter and Adam
    moment may differ from the card's on at most 0.1% of its elements, each
    within 2 bf16 ulps (the second moments 8), and the f32 logits within
    1e-5 x max: test_torch_ranker_bf16.py's bars against the JAX package
    (the MLP's f32 sums in another order round a bf16 gradient element the
    other way now and then); the eager step's ms."""
    tag = "[ranker-bf16]"
    cfg = dataclasses.replace(cfg_lib.two_tower_model_config(
        NUM_USERS, NUM_ITEMS, embedding_dim=DIM, layer_sizes=LAYERS), param_dtype="bfloat16")
    batches = ranker_batches(cfg, dev, RANKER_STEPS)
    step, init = concat_mlp.make_ranker_train_step(cfg, learning_rate=1e-3)

    def fresh(device):
        state = init(torch.Generator(device=dev).manual_seed(0), RANKER_HIDDEN)
        if device != dev:
            params = state["params"].to(device)
            state = {**state, "params": params,
                     "opt": concat_mlp.dense_optimizer(1e-3).build(params.parameters())}
        return state

    def after_one_step(state, batch) -> dict[str, torch.Tensor]:
        state, out = step(state, batch)
        got = {"logits": out["logits"].detach().float().cpu()}
        for name, p in state["params"].named_parameters():
            got[name] = p.detach().cpu().clone()
            for key in ("exp_avg", "exp_avg_sq"):
                got[f"{name}.{key}"] = state["opt"].state[p][key].cpu().clone()
        return got

    state = fresh(dev)
    if type(state["opt"]) is not opt_lib.OptaxAdam or {
            p.dtype for p in state["params"].parameters()} != {BF16}:
        raise AssertionError(f"{tag} not bf16 parameters under OptaxAdam")
    torch.cuda.synchronize()
    # --- the main path, counted -----------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    outs = []
    for b in batches:
        state, out = step(state, b)
        outs.append(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted -----------------------------------------------------------
    want = {"pooled_gather": 2 * RANKER_STEPS, "block_sorted_aggregate": 2 * RANKER_STEPS,
            "block_sorted_aggregate_bf16": 2 * RANKER_STEPS}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    losses = [o["loss"].item() for o in outs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    kernels = after_one_step(fresh(dev), batches[0])
    with ranker_plain_route():
        plain = after_one_step(fresh(dev), batches[0])
    tables = [f"tables.{t.name}" for t in cfg.tables]
    for name in tables:
        if not bitwise_equal(kernels[name], plain[name]):
            raise AssertionError(f"{tag} {name} after one step: the kernels' route is not the "
                                 "plain versions' bit for bit")
    plain_apart = {k: v for k, v in kernels.items() if not bitwise_equal(v, plain[k])}
    t_host = time.perf_counter()
    host = after_one_step(fresh(torch.device("cpu")), map_leaves(batches[0], lambda t: t.cpu()))
    t_host = time.perf_counter() - t_host
    torch.testing.assert_close(kernels["logits"], host["logits"], rtol=0,
                               atol=1e-5 * host["logits"].abs().max().item())
    worst = {}
    for name, want_t in host.items():
        if name == "logits":
            continue
        share, ulps = bf16_apart(kernels[name], want_t)
        worst[name] = (share, ulps)
        if share > 1e-3 or ulps > (8 if name.endswith("exp_avg_sq") else 2):
            raise AssertionError(f"{tag} {name} after one step against the host CPU: "
                                 f"{share!r} of the elements apart, up to {ulps!r} bf16 ulps")
    step_ms = []
    for b in batches:
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"{tag} {card_line()}: the concat-MLP ranker in bf16 (tables [{NUM_USERS}, {DIM}] + "
        f"[{NUM_ITEMS}, {DIM}], MLP {2 * DIM} -> {RANKER_HIDDEN} -> 1), f32 compute, OptaxAdam, "
        f"batch {RANKER_BATCH}, {RANKER_STEPS} steps in {seconds!r} s (the first calls' set-up "
        f"included; {RANKER_STEPS} more steps median_step_ms={statistics.median(step_ms)!r}, "
        f"eager), losses {losses}; launches counted "
        f"{ {k: v for k, v in launches.items() if v} }; after one step the tables bit for bit "
        f"the plain versions' on the card (other tensors apart: {sorted(plain_apart)}); "
        f"against the host CPU ({t_host!r} s a step) the largest share apart "
        f"{max(v[0] for v in worst.values())!r} and ulps {max(v[1] for v in worst.values())!r} "
        f"(bars 0.001 and 2, second moments 8)")
    return launches


def phase_native_reader(work: str) -> None:
    """`[native-reader]` the smoke replica's compressed shards (`shards-raw`,
    the raw-column split `[batch-predict]` prepared: a zlib stream a column)
    read through `ShardedDataset(use_native=True)` (the native C++ reader of
    `native/`, built with g++ at its first use in this run) and through
    `use_native=False` (numpy): every array of every shard bit for bit
    equal (dtype, shape and bytes). After an untimed pass (the page cache
    warm for both), one timed pass of each; the build's seconds."""
    from two_tower_recommender_model_tpu_torch.native import build as native_build

    raw = os.path.join(work, "shards-raw")
    splits = sorted(d for d in os.listdir(raw) if os.path.exists(os.path.join(raw, d, "index.json")))
    pairs = [(ShardedDataset(os.path.join(raw, d), use_native=True),
              ShardedDataset(os.path.join(raw, d), use_native=False)) for d in splits]
    shards = sum(nat.num_shards for nat, _ in pairs)
    if not pairs or any(nat.mmap or not nat.use_native for nat, _ in pairs):
        raise AssertionError(f"[native-reader] {raw}: {splits}: not compressed shards read "
                             "natively")
    seconds = {"native": 0.0, "numpy": 0.0}
    nbytes = arrays = 0
    for timed in (False, True):
        for nat, py in pairs:
            for i in range(nat.num_shards):
                t0 = time.perf_counter()
                a = nat.read_shard(i)
                t1 = time.perf_counter()
                b = py.read_shard(i)
                t2 = time.perf_counter()
                if timed:
                    seconds["native"] += t1 - t0
                    seconds["numpy"] += t2 - t1
                    continue
                if list(a) != list(b):
                    raise AssertionError(f"[native-reader] {nat.path} shard {i}: columns "
                                         f"{list(a)} != {list(b)}")
                for k in a:
                    if (a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                            or a[k].tobytes() != b[k].tobytes()):
                        raise AssertionError(f"[native-reader] {nat.path} shard {i} {k}: the "
                                             "native reader's array differs")
                    nbytes += a[k].nbytes
                    arrays += 1
    log(f"[native-reader] {card_line()} (the host's CPU: {os.cpu_count()} cores): the smoke "
        f"replica's compressed splits {splits}, {shards} shards, {arrays} arrays, {nbytes} "
        f"bytes: bit for bit the numpy reader's; read seconds (warm page cache) native="
        f"{seconds['native']!r} numpy={seconds['numpy']!r} (ratio "
        f"{seconds['numpy'] / max(seconds['native'], 1e-9)!r}); the library's g++ build "
        f"{native_build.build_seconds!r} s (0.0 when a library built before was loaded)")


def phase_multi_seed(dev: torch.device) -> dict[str, int]:
    """`[multi-seed]` `multi_seed_train` at flagship widths in bf16 compute
    (no sorted feature: every table through the device sort), seeds
    SEEDS, SEED_STEPS steps of SEED_BATCH and the eval of one batch (counted:
    each step's BCE launches a seed, 2 gathers and 2 tower_fwd a seed's
    eval); then, not counted, seed 1 alone through `create_train_state` and
    `make_train_step` on the same batches: its last loss and AUROC bit for
    bit the multi-seed run's."""
    from two_tower_recommender_model_tpu_torch.models.metrics import exact_auroc
    from two_tower_recommender_model_tpu_torch.tuning import multi_seed_train

    cfg, _ = flagship_bce()
    tcfg = cfg_lib.TrainConfig(batch_size=SEED_BATCH, block_sorted_kernel="bfloat16")
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=6)
    cols = list(ds.batches(SEED_BATCH, SEED_STEPS, split="train"))
    eval_cols = ds.sample(SEED_BATCH, "val")
    # --- the main path, counted -----------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    out = multi_seed_train(cfg, tcfg, SEEDS, cols, eval_cols, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # --- checks, not counted -----------------------------------------------------------
    want = {k: v * len(SEEDS) * SEED_STEPS for k, v in BCE_F32.items()}
    want["pooled_gather"] += 2 * len(SEEDS)
    want["tower_fwd"] += tower_fwd_launches(cfg, [SEED_BATCH]) * len(SEEDS)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"[multi-seed] launches {launches}, expected {want}")
    # different seeds, different models (the bf16 losses agree to their rounding)
    if not (np.isfinite(out["final_train_loss"]).all()
            and len(set(out["eval_auroc"].tolist())) == len(SEEDS)):
        raise AssertionError(f"[multi-seed] {out}")
    feat = Featurizer(cfg, device=dev)
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(1),
                                                   cfg, tcfg)
    step = step_lib.make_train_step(cfg, tcfg, dense_opt)
    for c in cols:
        state, o = step(state, feat(c))
    ev = feat(eval_cols)
    with torch.no_grad():
        q, c_ = two_tower_forward(state.model, ev)
        auroc = exact_auroc(torch.sum(q * c_, dim=1).float().cpu().numpy(),
                            ev.labels.cpu().numpy())
    i = SEEDS.index(1)
    if o["loss"].float().item() != out["final_train_loss"][i] or auroc != out["eval_auroc"][i]:
        raise AssertionError(f"[multi-seed] seed 1 alone: loss {o['loss'].item()!r}, AUROC "
                             f"{auroc!r}; in the multi-seed run {out['final_train_loss'][i]!r}, "
                             f"{out['eval_auroc'][i]!r}")
    log(f"[multi-seed] {card_line()}: seeds {list(SEEDS)} at flagship widths, bf16 compute, "
        f"{SEED_STEPS} steps of {SEED_BATCH} and one eval batch in {seconds!r} s; final train "
        f"losses {out['final_train_loss'].tolist()}, eval AUROC {out['eval_auroc'].tolist()}; "
        f"seed 1 alone bit for bit its multi-seed loss and AUROC; launches counted "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def sweep_trial(config: dict) -> dict:
    """A sweep trial in a spawned worker: the flagship (bf16 compute, no
    sorted feature) from a fresh state on the card, SWEEP_STEPS steps of
    SWEEP_BATCH at the config's rates, then the eval of two batches; the
    metrics with the worker's kernel launches, card and pid."""
    dev = torch.device("cuda", 0)
    cfg, _ = flagship_bce()
    tcfg = cfg_lib.TrainConfig(batch_size=SWEEP_BATCH, block_sorted_kernel="bfloat16",
                               learning_rate=config["lr"],
                               sparse_learning_rate=config["sparse_lr"])
    ds = SyntheticClickstream(NUM_USERS - 1, NUM_ITEMS - 1, seed=8)
    feat = Featurizer(cfg, device=dev)
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    step = step_lib.make_train_step(cfg, tcfg, dense_opt)
    reset_launches()
    for cols in ds.batches(SWEEP_BATCH, SWEEP_STEPS, split="train"):
        state, _ = step(state, feat(cols))
    metrics = evaluate(state, step_lib.make_eval_step(cfg, tcfg),
                       ds.batches(SWEEP_BATCH, 2, split="val"), Featurizer(cfg, device="cpu"))
    torch.cuda.synchronize()
    return {**metrics, "launches": read_launches(), "device": torch.cuda.get_device_name(0),
            "pid": os.getpid()}


def phase_sweep(dev: torch.device) -> dict[str, int]:
    """`[sweep]` `run_sweep` random (3 trials) and `run_adaptive_sweep` TPE
    (4 trials, 2 random first) over `sweep_trial`, each with max_workers=2:
    worker processes started by spawn, each trial on the card. Every trial
    must complete on this card in a process other than this one, with a
    finite val_loss and its BCE launches (a step's, SWEEP_STEPS times, plus
    2 gathers and 2 tower_fwd an eval batch); the launches the workers
    report are the path's."""
    from two_tower_recommender_model_tpu_torch.tuning import Choice, LogUniform, run_sweep
    from two_tower_recommender_model_tpu_torch.tuning.adaptive import run_adaptive_sweep

    space = {"lr": LogUniform(1e-4, 1e-2), "sparse_lr": LogUniform(1e-3, 2e-1),
             "batch": Choice((SWEEP_BATCH,))}
    cfg, _ = flagship_bce()
    per_trial = {k: v * SWEEP_STEPS for k, v in BCE_F32.items()}
    per_trial["pooled_gather"] += 2 * 2
    per_trial["tower_fwd"] += tower_fwd_launches(cfg, [SWEEP_BATCH] * 2)
    launches = {name: 0 for name in KERNELS}
    for search, n in (("random", 3), ("tpe", 4)):
        t0 = time.perf_counter()
        if search == "random":
            res = run_sweep(sweep_trial, space, num_trials=n, metric="val_loss", seed=0,
                            max_workers=2)
        else:
            res = run_adaptive_sweep(sweep_trial, space, num_trials=n, metric="val_loss",
                                     seed=0, max_workers=2, n_startup=2)
        seconds = time.perf_counter() - t0
        done = res.completed()
        if len(done) != n or any(t.error for t in res.trials):
            raise AssertionError(f"[sweep] {search}: {[t.error for t in res.trials]}")
        for t in done:
            made = {k: v for k, v in t.metrics["launches"].items() if v}
            if (t.metrics["device"] != torch.cuda.get_device_name(0) or made != per_trial
                    or t.metrics["pid"] == os.getpid()
                    or not np.isfinite(t.metrics["val_loss"])):
                raise AssertionError(f"[sweep] {search} trial {t.index}: {t.metrics}")
            for k, v in made.items():
                launches[k] += v
        pids = sorted({t.metrics["pid"] for t in done})
        log(f"[sweep] {card_line()}: {search}, {n} trials of the flagship ({SWEEP_STEPS} steps "
            f"of {SWEEP_BATCH}, bf16 compute) over 2 spawned workers (pids {pids}) in "
            f"{seconds!r} s; ranked val_loss "
            f"{[round(t.metrics['val_loss'], 6) for t in res.ranked()]}; best {res.best().config}; "
            f"each trial's launches {per_trial}")
    return launches


PARQUET_ROWS_PER_FILE = 50_000


def phase_parquet_text(work: str, model_dir: str) -> tuple[dict[str, int], dict[str, int]]:
    """`[batch-predict-parquet]` and `[text-features]` in a child process
    (`chip_smoke.py --child parquet-text`: pandas and pyarrow load there,
    not here); returns the launches each reported."""
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "parquet-text", "--work", work,
         "--model-dir", model_dir], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    for line in child.stdout.splitlines():
        if not line.startswith("CHILD "):
            log(line)
    if child.returncode != 0:
        raise AssertionError(f"[parquet-text] the child failed:\n{child.stderr[-4000:]}")
    result = json.loads([line for line in child.stdout.splitlines()
                         if line.startswith("CHILD ")][-1][len("CHILD "):])
    log(f"[parquet-text] child process {time.perf_counter() - t0!r} s")
    return result["batch-predict-parquet"], result["text-features"]


def child_parquet_text(work: str, model_dir: str) -> None:
    """The child of `phase_parquet_text`, on the card:
    - `[batch-predict-parquet]`: the smoke test split (raw columns, from
      `[batch-predict]`) written by `write_parquet_dataset`, then
      `batch_predict(input_format="parquet")` with the Production model
      (`model_dir`, its export),
      8,192 rows a batch (counted: 2 gathers a batch, tower_fwd as a bf16
      predict of its rows): the rows in order and each prediction bit for
      bit the TTRS route's (`[batch-predict]`'s output) on the same rows;
    - `[text-features]`: the text-side-features example at its default size
      (2,000 users, 500 items, 200 steps of 1,024; text vectors of 32 as the
      candidate tower's dense input) on the card (counted), recall@10 above
      2 x random (the example's bar: over initial draws it spans 0.05-0.13,
      in either package).
    Prints its launches as one `CHILD {json}` line."""
    from two_tower_recommender_model_tpu_torch.data.parquet import write_parquet_dataset
    from two_tower_recommender_model_tpu_torch.examples import text_side_features

    dev = torch.device("cuda", 0)
    scorer = load_scorer(model_dir, device=dev)  # the Production version's export
    src = ShardedDataset(os.path.join(work, "shards-raw", "test"))
    cols = {k: np.concatenate([src.read_shard(i)[k] for i in range(src.num_shards)])
            for k in src.schema()}
    rows = len(cols["user_id"])
    t0 = time.perf_counter()
    files = write_parquet_dataset(os.path.join(work, "parquet"), cols,
                                  rows_per_file=PARQUET_ROWS_PER_FILE)
    t_write = time.perf_counter() - t0
    out_dir = os.path.join(work, "scored-parquet")
    reset_launches()
    t0 = time.perf_counter()
    index = batch_predict(scorer, os.path.join(work, "parquet"), out_dir, batch_size=8192,
                          input_format="parquet")
    seconds = time.perf_counter() - t0
    parquet_launches = read_launches()
    sizes = [min(8192, rows - i) for i in range(0, rows, 8192)]
    want = {"pooled_gather": 2 * len(sizes)}
    fused = tower_fwd_launches(scorer.model.cfg, sizes)
    if fused:
        want["tower_fwd"] = fused
    if {k: v for k, v in parquet_launches.items() if v} != want or index["total_rows"] != rows:
        raise AssertionError(f"[batch-predict-parquet] launches {parquet_launches} for "
                             f"{len(sizes)} batches, {index['total_rows']} rows of {rows}")
    scored, ttrs = ShardedDataset(out_dir), ShardedDataset(os.path.join(work, "scored"))
    got = {k: np.concatenate([scored.read_shard(i)[k] for i in range(scored.num_shards)])
           for k in scored.schema()}
    ttrs_pred = np.concatenate([ttrs.read_shard(i)["prediction"] for i in range(ttrs.num_shards)])
    for k, v in cols.items():
        np.testing.assert_array_equal(got[k], v)
    if not np.array_equal(got["prediction"], ttrs_pred):
        raise AssertionError("[batch-predict-parquet] predictions differ from the TTRS route's")
    log(f"[batch-predict-parquet] {card_line()}: {rows} test rows written as {len(files)} parquet "
        f"files in {t_write!r} s, scored through input_format='parquet' in {len(sizes)} batches "
        f"in {seconds!r} s (rows_per_s={rows / seconds!r}); rows in order, predictions bit for "
        f"bit the TTRS route's; launches counted "
        f"{ {k: v for k, v in parquet_launches.items() if v} }")
    reset_launches()
    t0 = time.perf_counter()
    out = text_side_features.main(device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text_launches = read_launches()
    if not out["recall_at_10"] > 2 * 10 / 500 or not text_launches["pooled_gather"]:
        raise AssertionError(f"[text-features] {out}, launches {text_launches}")
    log(f"[text-features] {card_line()}: the text-side-features example (2,000 users, 500 "
        f"items, 200 steps of 1,024, text vectors of 32 in the candidate tower) in {seconds!r} "
        f"s: loss {out['loss']!r}, recall@10 {out['recall_at_10']!r} (random 0.02, the bar "
        f"0.04); launches counted { {k: v for k, v in text_launches.items() if v} }")
    print("CHILD " + json.dumps({"batch-predict-parquet": parquet_launches,
                                 "text-features": text_launches}), flush=True)


def timed_phase(fn):
    """`fn`, logging its wall seconds as `[time] <name>` when it returns or
    raises (a phase inside another is timed too): where the run's time
    goes."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log(f"[time] {fn.__name__}: {time.perf_counter() - t0!r} s")
    run.__name__ = run.__qualname__ = fn.__name__
    run.__doc__ = fn.__doc__
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = timed_phase(globals()[_name])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace the direct calls with torch.profiler and print "
                             "device busy time, idle share and the largest device items")
    parser.add_argument("--child", choices=["parquet-text"], help=argparse.SUPPRESS)
    parser.add_argument("--work", help=argparse.SUPPRESS)
    parser.add_argument("--model-dir", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.child == "parquet-text":  # a phase's child process (see phase_parquet_text)
        child_parquet_text(args.work, args.model_dir)
        return 0
    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        built = dict(zip(KERNELS, pool.map(lambda k: k[0].load(), KERNELS.values())))
    log(f"[build] {len(built)} kernels built and loaded in {time.perf_counter() - t0!r} s")
    for b in {b.path: b for b in built.values()}.values():  # one library per source
        log(f"[build] {b.path.name}: nvcc {b.build_seconds!r} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    stats = {"pooled_gather": phase_kernel(dev), "rowwise_adagrad": phase_adagrad_kernel(dev),
             "tower_bwd": phase_tower_kernel(dev), "relu_ties": phase_relu_ties_kernel(dev),
             "tower_fwd": phase_tower_fwd_kernel(dev, args.profile),
             **phase_softmax_kernel(dev),
             **phase_int8_kernels(dev), **phase_probe_kernels(dev)}
    stats["rowwise_adagrad"]["max_abs_err"] = max(
        stats["rowwise_adagrad"]["max_abs_err"],
        stats.pop("rowwise_adagrad on skewed ids")["max_abs_err"])
    phase_adagrad_bf16_table(dev)
    phase_wide_table_kernels(dev)
    phase_bf16_buffer_kernels(dev)
    phase_aggregate_perm_kernel(dev)
    stats["block_sorted_aggregate_bf16"] = phase_aggregate_bf16_kernel(dev)
    serve = phase_serve(dev, args.profile)
    batches = flagship_batches(dev)
    first = (batches[0][:POOL], batches[1])  # the earlier phases' pool
    paths = {"train": phase_train(dev, args.profile, first)[0], "learn": phase_learn(dev),
             "train-softmax": phase_train_softmax(dev, args.profile),
             "learn-softmax": phase_learn_softmax(dev)}
    phase_learn_softmax_equal_weights(dev)
    paths["train-int8"], int8_state, int8_cfg = phase_train(dev, args.profile, first, "int8")
    phase_train_big_int8(dev, first[0])
    paths["train-override"] = phase_train_override(dev, first[0])
    paths["serve-int8"] = phase_serve_trained(dev, int8_state, int8_cfg, args.profile)
    del int8_state
    paths["learn-int8"] = phase_learn(dev, "int8")
    paths["probe"] = phase_probe(dev)
    paths.update(phase_train_graphs(dev, args.profile, batches[0]))
    paths["train-softmax-wide"] = phase_train_softmax_wide(dev, args.profile)
    paths["train-wide-table"] = phase_train_wide_table(dev, args.profile)
    paths["train-devsort"] = phase_train_devsort(dev, args.profile)
    paths.update(phase_train_bf16buf(dev, args.profile, batches[0]))
    paths.update(phase_meshes(dev, batches[0]))
    for table_dtype in ("float32", "int8"):
        phase_shard_kernels(dev, batches[0], table_dtype)
    phase_shard_exchange(dev, batches[0])
    phase_shard_columns(dev, batches[0])
    for d in (64, 256):
        phase_shard_softmax(dev, d)
    paths["train-compact"] = phase_train_compact(dev, args.profile)
    paths["train-skew"] = phase_train_skew(dev, args.profile)
    paths["learn-packed"] = phase_learn_packed(dev)
    paths["train-bf16tab"], bf16_state, bf16_cfg = phase_train_bf16tab(dev, batches)
    paths["learn-bf16tab"] = phase_learn(dev, "bfloat16")
    paths["serve-bf16tab"] = phase_serve_trained(dev, bf16_state, bf16_cfg, args.profile,
                                                 "[serve-bf16tab]", "pooled_gather")
    del bf16_state
    paths["train-bf16param"] = phase_train_bf16param(dev, args.profile)
    work = tempfile.mkdtemp(prefix="ttrm_pipeline_")
    try:
        pipeline_paths, pipeline = phase_pipeline(dev, work)
        paths.update(pipeline_paths)
        runs = {}
        for table_dtype in ("float32", "int8"):
            tag = "resume" if table_dtype == "float32" else "resume-int8"
            paths[tag], paths[tag + "-restart"], runs[table_dtype] = phase_resume(
                dev, work, pipeline, table_dtype)
        paths["registry"], scorer, production = phase_registry(dev, work, pipeline, runs)
        paths["batch-predict"] = phase_batch_predict(work, scorer)
        phase_native_reader(work)
        phase_per_user_table(work, production)
        paths["batch-predict-parquet"], paths["text-features"] = phase_parquet_text(
            work, production)
        paths["profile-trace"] = phase_profile_trace(dev, work, pipeline, runs["float32"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths["ranker"] = phase_ranker(dev)
    paths["ranker-bf16"] = phase_ranker_bf16(dev)
    paths["multi-seed"] = phase_multi_seed(dev)
    paths["sweep"] = phase_sweep(dev)
    torch.cuda.synchronize()
    leaked = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu", "pandas", "pyarrow")]
    if leaked:
        raise AssertionError(f"JAX, the JAX package, pandas or pyarrow was imported: "
                             f"{leaked[:5]}")

    log(f"[time] the whole run (build included): {time.perf_counter() - t_run!r} s")
    launches = {name: sum(path.get(name, 0) for path in paths.values()) for name in KERNELS}
    launches["pooled_gather"] += serve
    log(f"launches on the main paths: serve pooled_gather={serve}, " + ", ".join(
        f"{path} { {k: v for k, v in made.items() if v} }" for path, made in paths.items()))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **stats[name]}
        for name, (_, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
