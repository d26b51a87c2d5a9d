#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) of FractalSort on one
NVIDIA GPU and check it: the in-memory sort, the llama3.2-1b serving
path (prefill through the flash-attention kernel, then the decode loop
with the fractal-sort scheduler), the query layer on TPC-H-shaped
tables, the out-of-core stream (external sort and streaming queries
of host data under a device byte budget), the distributed sort and the
device store on a one-rank NCCL group, the plan autotuner and the
paper's baseline sorts, the MoE path (qwen3-moe-30b-a3b serving, its
token dispatch on the fractal kernels), the remaining model families
(jamba's mamba + attention + MoE hybrid, xlstm's mLSTM and sLSTM,
whisper's encoder-decoder, internvl2's patch prefix, and every config at
smoke size), the train path (AdamW, the chunked loss, remat,
checkpoints, the restart runtime and the training driver), the LM's
sharding (the sharded train step, the MoE expert-parallel branch,
split-KV decode and the GPipe stages) on a one-rank mesh, and tensor
parallelism over `model` (the split dense layers, one rank of a 4-way
group on a fake process group, the dry-run of four production cells).

    python3 chip_smoke.py [--seed 0] [--log2n 27] [--lm-layers 16]
                          [--query-log2n 26] [--stream-log2n 24]
                          [--moe-layers 48] [--hybrid-layers 16]
                          [--train-moe-layers 2] [--profile]

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA source of ``src/repro_torch/kernels/csrc`` (timed),
   print each kernel's registers and fail on any spill (``-Xptxas -v``),
   and count the tensor-core ``HMMA`` instructions of every K5 instance in
   the built library's SASS (``cuobjdump -sass``; fails on 0);
3. every kernel (K1 histogram, K2 one-hot rank, K3 scatter rank, K4
   reconstruct, the payload carry) against its plain PyTorch version on the card, bit-exact
   (tolerance 0: integer outputs), at n in {1, 1000, 2**20 + 37} and
   n_bins in {16, 256, 2**16}; K2 and K3 also over n in {1, 1000, 4095,
   4096, 4097, 8191, 8192, 8193, 2**20 + 37} (both look-back tiles are
   8192 keys) x n_bins in {1, 2, 16, 256, 257, 300, 511, 4096, 2**16}
   (both sides of their switch between the look-back sweep and the
   two-level or table path, and the edges of K2's split of a digit into
   its high and low bytes: 2, 2, 2, 16 and 256 high bins) on uniform,
   zipf(1.2) and one-bin digits with -1 and n_bins pads and, above 256
   bins, keys in [n_bins, 256 * ceil(n_bins / 256)), from non-dense bin
   starts, K2 above 256 bins both with the digit's counts given and
   without, K3 also at 2**16 bins over n = 2**22 and on an unaligned
   stream; K1 over n in
   {1, 31, 4095, 4097, 2**20 + 37} x n_bins in {1, 2, 15, 16, 17, 32, 33,
   256, 2**14, 2**14 + 1, 20000, 3 * 2**14 + 3, 2**16 - 1, 2**16} (both
   sides of the switch to the cluster path, its slices full and short) on
   uniform, zipf(1.2) and one-bin digits, streams 0-3 elements off a
   16-byte boundary, with pads, with and without init; K1's one-sweep entry
   against per-digit plain histograms for the p = 32, 16, 7 and 8-bit
   plans at n in {1, 4097, 2**20 + 37}, aligned and not, with and without
   init; the payload carry (``fractal_scatter``) of int32 keys beside an
   int32, int64, int16, uint8, bfloat16 and a (n, 3) float32 payload at n
   in {1, 5, 1001, 2**20 + 37}, sources aligned and not, with the MSD
   pass's mask and without, bit for bit;
4. the main path at n = 2**log2n keys (default 2**27 = 512 MiB of uint32
   keys, the smallest data set of the paper's evaluation), generated from
   ``--seed``: ``fractal_sort`` at p = 32 and p = 16 on uniform and
   zipf-skewed keys, ``fractal_sort_pairs``, ``fractal_argsort``, the
   kernel entry points, the 8-bit scatter-engine plan, and the paper's
   16b+16b plan at n = 2**24 (also through the torch-op backend); every
   result bit-exact against ``torch.sort``/``torch.argsort(stable=True)``
   on int64, used here only as the check;
5. the kernels' launch counts over phase 4 (each must be > 0), and the
   kernels one warm p = 32 sort launches (by counter and by profiler;
   fails unless K1 is launched once, as the one sweep; where the profiler
   traces no device kernel in three tries, the counter alone decides);
6. per-kernel times at the main path's shapes beside their bounds, the
   plain versions and one PyTorch library call (each timed one call at a
   time between two CUDA events, the wrapper's host time included), a
   profiler check that one K2 call at 16 bins runs one kernel of its own
   (no count walk, no scan) and that one at 2**16 bins (the keys' high
   half, its counts given) runs the two-level path's four kernels and
   nothing else (each logged as not checked where the profiler traces no
   device kernel); the payload carry of a 16-bin pass's ranks for keys
   alone, keys with an int32 payload and keys under the t = 28 mask (its
   yardstick ``Tensor.index_put_`` with an int64 index made beforehand,
   which the port never calls); and the end-to-end sort time beside
   ``torch.sort``; K1's one sweep over the p = 32 plan's 8 digits; K2
   at 256 bins on a log line (the yardstick of K3 there); K2 at 16 bins
   on the key stream (the digit taken in the kernel, as a sort's passes
   run it, at shift 4 and 28) in the table beside its bound and plain
   version, and extraction plus K2 on the digit stream on a log line;
   the log lines of the redesigned K1, K2 and K3 also name their first
   versions' times, constants of earlier runs that no metric reads; with
   ``--profile``, the device time of one call of K1, its sweep and K3;

then, with the sort data freed and TF32 off for float32 matmuls:

7. K5 (flash attention) against its plain version (the naive fp32
   oracle) on the card at the reference's test shapes, at hd 8, 80, 96
   and 128, at Sq = 1 and Skv != Sq, with a q that is a strided slice of
   a wider tensor, causal and not, at the prefill shapes q, k, v
   (2, 2048, 32, 64) of llama3.2-1b and (2, 2048, 32, 128) of
   qwen3-moe-30b-a3b (phase 18's prefill, its kv heads repeated from
   GQA 32/4), and at phase 19's whisper shapes: (2, 1500, 12, 64), the
   encoder over 1500 frames, and q (2, 448, 12, 64) over 1500 keys, its
   cross-attention; tolerance fp32 2e-5 (1e-4 at the prefill and whisper
   shapes: 1500- and 2048-term sums in another order), bf16 2e-2;
8. prefill: llama3.2-1b at full width and depth (``--lm-layers`` cuts
   depth for a rehearsal), fp32 weights from ``--seed``, B = 2 prompts of
   S = 2048 tokens through ``make_prefill_step`` with the kernel switch on
   (16 K5 launches) against the plain blockwise attention, logits within
   atol = rtol = 1e-3;
9. serve: token-by-token decode against the prefill logits (1e-3), the
   scheduler's admission order on the card against the CPU's, then
   ``serve()`` on 8 requests with 4 slots at max_len 96 (every request
   answered; K1 and K2 launched by the scheduler's sorts);
10. K5 times at the prefill shape (fp32 and bf16) beside the bound, the
   plain version and ``scaled_dot_product_attention`` (timed as the
   yardstick only; the port never calls it), with the first version's
   time and fp32-FMA bound on the log line only; prefill ms and serve
   tokens/s;

then, with the model freed:

11. TPC-H-shaped ``orders`` (2**(query_log2n - 2) rows) and ``lineitem``
   (1-7 lines an order, about 2**query_log2n rows; default 2**26) built
   on the card, and six queries through ``repro_torch.query``: a
   Q1-shaped GROUP BY (return flag, line status) with sum, count, min
   and max; a Q3-shaped join of orders and lineitem, revenue column,
   GROUP BY order key and top-10 by (revenue desc, order date); ORDER BY
   (extended price desc, order key), a 3-word code; ORDER BY ship date at
   16-bit precision; DISTINCT ship date; and one ``sort_rowids_batched``
   of 64-bit codes in 2**20-row segments.  Each result is held against a
   plain-torch oracle computed here (stable ``torch.argsort`` of int64
   keys derived here, ``torch.unique`` with scatter reductions,
   ``torch.searchsorted`` match ranges): bit-exact for row ids, codes,
   counts, integer sums, min and max, float64 sums within
   ``QUERY_F64_RTOL``; each query's host syncs are counted (CUDA's sync
   debug mode), and the path fails unless K1 and K2 launched on it;
12. each query's time (CUDA events and host wall, median of 3 after one
   warm-up, the host's syncs included) beside the same query written in
   plain torch ops (the phase-11 oracle, a yardstick the port never
   calls); ``--profile`` adds the device time of one call of each query
   by kernel, and its idle share.

then, with the query data freed:

13. the external sort at the paper's smallest size: 2**log2n host keys
   (512 MiB at the default 27) under ``MemoryBudget`` of 1/8 of their
   bytes (64 MiB) on a ``RunStore`` in a temporary directory, source
   chunks of ``budget.rows(row_cost_bytes(1))`` rows: ``external_sort``
   of uniform and zipf(1.2) p = 32 keys and ``external_argsort`` of the
   uniform ones, traced (``repro_torch.obs.trace``), each bit-exact
   against ``torch.sort`` / ``torch.argsort(stable=True)`` of the keys as
   int64 on the card (the check only); fatal unless each run's
   ``budget.peak_bytes`` and the card's allocation rise
   (``max_memory_allocated`` after ``reset_peak_memory_stats``) stay
   within the budget; wall ms, partitions, recursion depth, bytes spilled
   and read back, both peaks and the seconds of the ``stream.histogram``,
   ``stream.distribute``, ``stream.partition_sort``, ``store.put`` and
   ``store.get`` spans, then the uniform sort untraced beside the
   in-memory ``fractal_sort`` and ``torch.sort`` of the same keys; an
   argsort of 2**24 keys with ``REPRO_STREAM_WORKERS`` 1 and 2 (equal
   outputs); K1 at 1024 bins with an ``init`` carry at chunk length and
   K2 at distribute's ``num_partitions + 1`` bins against their plain
   versions;
14. streaming queries: the first 2**stream_log2n rows of phase 11's
   ``lineitem`` (regenerated from the same seed) on the host as a
   ``StreamTable`` under a budget of 1/8 of their column bytes: ORDER BY
   ship date as ``IntCodec(16)`` with every column riding, the Q1-shaped
   GROUP BY, and top-10 by (extended price desc, order key), each
   bit-exact against the in-memory operator on the same rows on the card
   (float64 sums within ``QUERY_F64_RTOL``), fatal unless
   ``budget.peak_bytes`` stays within the budget; each query's ms beside
   the in-memory one.  Fails unless K1 and K2 launched on the stream path
   (phases 13-14), whose launches form the kernel table's "stream" column;

then, on a one-rank process group (NCCL; a file rendezvous, no network):

15. the distributed sort at n = 2**log2n keys from ``(--seed, 15)``:
   ``distributed_fractal_sort`` of uniform and zipf(1.2) keys at p = 32
   (two 16-bit passes) and p = 16, ``distributed_fractal_argsort`` of the
   uniform ones and ``make_distributed_sort_pairs`` with an int64
   payload, each bit-exact against ``torch.sort`` / a stable
   ``torch.argsort`` with no bucket overflow; fails unless K1 and K2
   launched on this path (and K3 where the engine rule sends a 16-bit
   field there); K1 at the pass's 2**16 bins on the uniform and zipf
   keys' high 16-bit field and on one bin, bit-exact and timed beside its
   plain version and ``torch.bincount`` (a yardstick the port never
   calls; the global-atomic version's times on the log line only), with a
   profiler check that it runs the cluster kernel alone (all three before
   the process group exists); K1 and
   K2 at its shapes (2**16 bins, with and without
   the counts; one destination) against their plain versions; K2's time
   at the pass's 2**16 bins with the counts given, as the pass calls it
   (beside its plain version, a stable ``torch.sort`` of the digit and
   the bare call; the table-walk version's time on the log line only),
   and at 2**25 keys beside K3; a profiler check that that K2 call runs
   only the two-level path's kernels (prep, two look-back levels,
   unstage: no table walk, no torch op; all four are required in phase
   6, where the profiler is not on a process group; logged as not
   checked where the profiler traces no device kernel); the sorts'
   times beside the in-memory ``fractal_sort`` and ``torch.sort``
   (``--profile``: the device time of one p = 32 sort of the uniform and
   of the zipf keys by kernel);
16. the device store: ``external_sort`` and ``external_argsort`` of
   phase 13's uniform host keys under the same 64 MiB budget with
   ``store=DeviceShardStore()``, sized by the store's row cost, and the
   ORDER BY ship date (``IntCodec(16)``) of phase 14's rows with
   ``placement=DeviceShardStore()``, bit-exact against ``torch.sort`` and
   the in-memory operator; fatal if the budget's peak or the card's
   allocation rise passes the budget, or unless K1 and K2 launched.
   Phases 15 and 16 form the kernel table's "distributed" and
   "device_store" launch columns;

then, with the sort data freed:

17. autotune and baselines.  The plan sweep (``autotune_plan(backend=
   "cuda")``, measured at min(n, 2**18) keys) at the reference's tune
   points (2**12, 16), (2**15, 32), (2**17, 32), (2**15, 9), (2**15,
   16) and at n = 2**log2n, p = 32 and 16, into a cache file of its
   own: each point's plan, engine, rank kernel (K2 or K3, by its launch
   counts) and µs, and the winner; fatal unless a second call at each
   point measures nothing (``autotune.hit`` +1).  Every grid plan at
   2**log2n keys, p = 32 and 16, bit-exact against ``torch.sort`` and
   timed, with its rank kernel at that size and the rank of the 2**18
   winner among them.  With ``REPRO_TORCH_AUTOTUNE_CACHE`` at the filled
   cache: an all-defaults p = 32 sort must launch what the pinned winner
   launches (and hit the cache), one ORDER BY of a 16-bit code over 2**15
   rows must consult the tuner once and hit, and one ``external_sort``
   of 2**24 host keys must consult it once for each (length, bits)
   bucket, each bit-exact.  The host's µs for the serve scheduler's
   all-defaults ``fractal_argsort`` with and without the consult.  Then
   ``lsd_radix_sort`` (radix 8 and 16), ``bitonic_sort``, ``torch_sort``
   and ``fractal_sort`` with the static and the tuned plan at 2**log2n
   keys, p = 32 and 16, bit-exact, with ms, the analytic bytes of their
   ``*_stats`` model, bytes per ms (none for ``torch_sort``: its
   merge-sort model is not what ``torch.sort`` runs on the card; any
   other above the card's memory rate is fatal) and the ratio of each
   one's effective bandwidth (useful bytes over time) to
   fractal_sort's.  Its launches form the kernel table's
   "autotune_baselines" column.  Phases 1-16 resolve their plans from
   an empty cache in a temporary directory, whatever the machine holds;

then, with the autotune data freed:

18. MoE on the card, data from ``(--seed, 18)``.  a. ``moe_dispatch``
   (K1's counts, K2's ranks, the inverse permutation) bit-exact against
   the argsort dispatch (``ref.moe_dispatch_ref``) at (T, E) in {(1,
   128), (32, 128), (64, 128), (4096, 128), (32768, 128), (2**14, 128),
   (2**16, 128), (2**16, 8)} and at phase 19's jamba shapes (4, 16), (8,
   16), (128, 16), (8192, 16) on uniform, zipf(1.2) and one-expert ids,
   one K1 and one K2 launch each; b. one full-width qwen3-moe layer (D
   2048, E 128, top-8, F 768, bf16) with a zero router sends every token
   to experts 0..7 at weight 1/8, aux 1; c. the same layer at T = 4096
   (C = 320) on K1/K2 bit-equal (out and aux) to itself on the argsort
   dispatch, one K1 and one K2 launch; e. decode against prefill (K5 on)
   at full width, 2 layers, fp32, capacity_factor = E (no drops), B = 2,
   S = 32, within 1e-3, two K1 and two K2 launches a step; d.
   qwen3-moe-30b-a3b at full width and depth (``--moe-layers`` cuts it
   for a rehearsal), random bf16 weights (the router fp32): one decode
   step of 4 slots launches K1 and K2 once a layer, a prefill of 2 x 2048
   tokens (K5 on) exactly once a layer each and gives finite logits, then
   ``serve()`` of 8 requests with 4 slots at max_len 96 answers every one
   with at least one K1 and one K2 launch a layer a decode step; f. the
   dispatch µs at the reference bench's shapes beside the argsort
   dispatch (a yardstick the port never calls), K1 and K2 at prefill's
   dispatch shape, the layer's ms beside its bound (its expert bytes or
   its bf16 flops), prefill ms, and serve ms a step beside the time to
   read every weight once.  The prefill and serve launches form the
   kernel table's "moe" column;

then, with the MoE model freed:

19. the remaining model families on the card, data and weights from
   ``(--seed, 19)``.  a. jamba-v0.1-52b, one period (8 layers) at full
   width in fp32 (D 4096, d_inner 8192, N 16, 16 experts top-2 of width
   14336, about 53 GB), capacity_factor = E, K5 on: 32 decode steps of B
   = 2 within 1e-3 of the prefill, the prefill launching K1 and K2 once
   per MoE layer and K5 once, each decode step K1 and K2 once per MoE
   layer; b. jamba at full width in bf16, 16 of its 32 layers (26.0 B
   parameters, 52.0 GB; ``--hybrid-layers`` cuts it further; a_log,
   d_skip and the router fp32), random weights: a prefill of 2 x 2048
   tokens launches K5 twice and K1 and K2 8 times each and gives finite
   logits, then ``serve()`` of 8 requests with 4 slots at max_len 96
   answers every one; prefill ms beside its bound (2 flops a
   multiply-add of the active weights, 6.06 B a token as
   ``active_params`` counts them, and the causal attention, on the bf16
   peak) and ms a decode step beside the time to read every weight once; c. xlstm-125m at full width and depth in
   fp32: a prefill of 2 x 2048, the chunked mLSTM within 2e-4 of its
   token loop on layer 0's input, 96 decode steps within 1e-3 of the
   prefill, ``serve()`` of 8 requests, prefill ms and the two sLSTM
   layers' token loop ms; d. whisper-small at full width and depth in
   fp32, stub frames (2, 1500, 768): ``encode_cross_kv`` (12 non-causal
   K5 launches), a prefill of 448 tokens with the frames (36 K5
   launches: encoder, causal self-attention, cross-attention at Sq 448,
   Skv 1500) within 1e-3 of the plain attention, 16 decode steps with
   the encoder's cross K/V within 1e-3 of the prefill; e. internvl2-76b
   at full width in bf16, 8 of its 80 layers (8.9 B parameters): a
   prefill of 256 stub patches + 2 x 2048 tokens launches K5 8 times and
   gives finite (2, 2048, V) logits, its ms beside its bound; f. every
   registered config at smoke size, K5 on: one prefill and one decode
   step, finite.  Each model's peak memory is logged.  The launches of
   19a-e form the kernel table's "families" column;

then, with the family models freed and the peak memory statistics reset:

20. the train path on the card, data and weights from ``(--seed, 20)``,
   TF32 off.  a. llama3.2-1b at full width and depth in fp32 (1.24 B
   parameters, 19.8 GB with gradients and both moments): 6
   ``make_train_step`` steps of ``SyntheticLM`` batches of 8 x 1024
   tokens through the ``Prefetcher``, remat on, fatal unless every loss
   and grad norm is finite and step 0's loss is within 1.0 of ln(vocab);
   each step's ms, tokens/s, the model-FLOPs share (6 N a token over the
   step time at the fp32 peak outside the tensor cores) and the peak
   memory; b. one train step of the llama3.2-1b, qwen3-moe-30b-a3b and
   xlstm-125m smoke configs on the card against the same step on the CPU
   from the same weights and batch, no warmup (lr 3e-4): loss and the
   clipped gradients (``mu / (1 - b1)``) within rtol 1e-4 + atol 1e-5,
   every parameter moved, and the updated parameters within the same
   tolerance but the elements whose gradient lies in (0, 10 eps) (at
   most 1 %; held within 2 lr, as the step divides them by about eps;
   phase 18a holds the MoE's (128, 8) dispatch); the card's state through
   ``checkpoint.save``, restored on the CPU and back onto the card,
   bit-exact; K5 refuses
   inputs that require grad; c. qwen3-moe-30b-a3b at full width,
   ``--train-moe-layers`` (2) layers, fp32 (1.87 B parameters): 3 train
   steps of 2 x 1024 tokens through ``moe_apply`` on the fractal
   dispatch, fatal unless losses and aux losses are finite and K1 and K2
   launched; d. ``length_bucketed_order`` of 2**24 lengths in [0, 2**17)
   bit-exact against a stable ``torch.argsort`` of the clipped keys, K1
   and K2 launched, timed beside that argsort; e. ``python -m
   repro_torch.launch.train`` (llama3.2-1b smoke, 25 steps, a checkpoint
   every 10, a failure induced at step 15) on the card in a temporary
   directory: its journal replays step 12 twice and ends at step 24; f.
   ``make_compressed_ddp_step`` on a one-rank NCCL group: every reduced
   gradient equals its int8 dequantization computed with plain torch ops,
   and the step's loss is finite.  The launches of 20a-d form the kernel
   table's "train" column.  No checkpoint of the full-width state is
   written (about 20 GB of disk);
21. the LM's sharding on a (1, 1) ``("data", "model")`` mesh over a
   one-rank NCCL group, data and weights from ``(--seed, 21)``: a.
   llama3.2-1b at full width and depth, fp32, remat, batch 8 x 1024: one
   ``make_train_step`` step (kept on the host, then freed), then
   ``shard_train_step`` (the model stored by spec, each block gathered
   where it runs) from the same weights and batch, held to it by 20b's
   gate (``step_agrees``: loss, clipped gradients and updated parameters
   at rtol 1e-4 / atol 1e-5), and two more sharded steps timed; b.
   qwen3-moe-30b-a3b at full width, ``--train-moe-layers`` (2) layers,
   fp32: one sharded step through ``moe_apply``'s mesh branch held to its
   unsharded step the same way, fatal unless K1 and K2 launched in it; c.
   llama3.2-1b split-KV decode (16 steps, B = 2) over the one-rank data
   group against the dense decode (1e-3); d. ``gpipe_apply`` at S = 1
   (llama's first MLP as the stage) against the stage applied to each
   microbatch; e. the bytes one rank holds of each of the ten configs'
   bf16 parameters on the 16 x 16 mesh, from ``param_specs`` (arithmetic,
   meta tensors).  Multi-rank runs need more than one card: they are the
   CPU tests' gloo groups.  The launches of 21a-b's sharded steps form the
   kernel table's "sharding" column.  The sharded step runs the
   tensor-parallel dense layers of phase 22;
22. tensor parallelism over `model`, data and weights from ``(--seed,
   22)``: a. on a (1, 1) mesh of one NCCL rank, llama3.2-1b's prefill (2 x
   2048, fp32, K5 on the local heads) through ``shard_prefill_step``,
   qwen3-moe-30b-a3b at ``--train-moe-layers`` layers (its prefill and
   one sharded train step, the dispatch on K1/K2) and llama's decode
   through the split layers, split-KV over `model` (16 steps, B = 2),
   then jamba-v0.1-52b's one period (8 layers, fp32) and xlstm-125m
   (full, fp32), prefill (2 x 2048) and 16 decode steps each through the
   split mamba, mLSTM and sLSTM and the vocab-split embedding and head,
   each held to the unsharded step (1e-3; the train step by 21's gate),
   fatal unless K5 launched once a layer and K1, K2 launched (jamba: K5
   once, K1 and K2 once a MoE layer on its prefill); b. rank 0 of a (1,
   4) mesh on a fake process group over the card: llama's, jamba's
   period's and xlstm's prefills as one card of a 4-way group computes
   them, timed only (its collectives move nothing), and K5 at llama's
   local shape (2, 2048, 8, 64) against its plain version (1e-4); c. the
   dry-run of four cells on
   a fake 16 x 16 group (``repro_torch.launch.dryrun``, four child
   processes on the host's CPU after a-b), their ``[dryrun]`` lines.
   22a's launches form the kernel table's "tensor_parallel" column.

Each phase draws its data from its own generator, seeded with
``(--seed, phase)``, so a check added to one phase changes no other
phase's inputs.

Every kernel, K1-K5, must have launched on a main path (phases 4, 8, 9,
11, 13-22).

The last line of output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import datetime
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
# H100 SXM dense peaks, NVIDIA data sheet: fp32 outside the tensor cores,
# TF32 and bf16 on the tensor cores
FP32_FMA_FLOPS, TF32_FLOPS, BF16_FLOPS = 67e12, 495e12, 989e12
# K5's route per dtype: (products a product, peak) -- fp32 runs 3xTF32
K5_ROUTE = {"float32": (3, TF32_FLOPS, "3xTF32 on the TF32 tensor cores"),
            "bfloat16": (1, BF16_FLOPS, "bf16 tensor cores")}
# the first versions' times on the H100, from earlier runs of this script
# (PERF.md); printed on the log lines beside this run's times, never in the
# kernel table
FIRST_VERSION_MS = {"fractal_histogram": 0.674, "fractal_rank_kernel": 1.122,
                    "fractal_rank_scatter_kernel": 4.778, "k5_float32": 1.565,
                    "k5_bfloat16": 1.580}
# K2 at 2**27 keys and 2**16 bins before its two-level path (count walk,
# scan and rank walk over a per-tile table), from an earlier run of this
# script (PERF.md); printed on phase 15's log line only
TABLE_WALK_MS = 23.505
# K1 at 2**27 keys and 2**16 bins before its cluster path (one device
# atomic a key), by digit, from an earlier run of this script (PERF.md);
# printed on phase 15's log line only
GLOBAL_ATOMIC_K1_MS = {"uniform": 1.976, "zipf": 91.555, "one_bin": 98.921}
# the kernel of one K1 call above 2**14 bins
K1_WIDE_KERNEL = "histogram_cluster_kernel"
# the kernels of one K2 call above 256 bins
K2_WIDE_KERNELS = ("wide_prep_kernel", "lookback_rank_kernel",
                   "wide_unstage_kernel")
PREFILL_BATCH, PREFILL_SEQ = 2, 2048  # prompts and tokens a prompt
# float64 sums of the query phases against the oracle's: they add in
# another order, and this tolerance absorbs only that
QUERY_F64_RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median time of one call of ``fn`` in ms (CUDA events around each
    call, so the host's time to enqueue it counts too)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_rng(seed: int, phase: int) -> np.random.Generator:
    """The generator of one phase's data."""
    return np.random.default_rng([seed, phase])


def profile_call(fn, top: int = 15) -> dict:
    """Device time of one warm call of ``fn`` by kernel name (the
    profiler's device-side events: kernels, memsets, copies), beside the
    call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue  # host-side op: its kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms), "top": rows[:top]}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def attention_bound_ms(B: int, Sq: int, Skv: int, H: int, hd: int,
                       causal: bool, dtype: torch.dtype) -> tuple:
    """The least time of one attention call on the card by K5's route: the
    larger of its QK^T and PV flops (4 * B * H * hd a visible (q, k) pair,
    three times over for 3xTF32) over the route's peak and its bytes (q, k,
    v read once, out written once) over the memory rate.  Returns (ms,
    "operations" or "bytes", the route, the fp32-FMA bound of the first
    version in ms: the same flops on the fp32 FMA pipes)."""
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * B * Sq + 2 * B * Skv) * H * hd * torch.finfo(dtype).bits // 8
    times, peak, route = K5_ROUTE[str(dtype).removeprefix("torch.")]
    op_ms = times * flops / peak * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes",
            route, max(flops / FP32_FMA_FLOPS * 1e3, byte_ms))


# torch.cuda._sleep's kernel: a traced call is bracketed by one on each side
TRACE_MARKER = "spin_kernel"


def kernel_names(fn, tries: int = 5, partial_ok: bool = False):
    """The device kernels one warm call of ``fn`` runs (torch.profiler), or
    None where no trace of ``tries`` warm calls was whole.  Each traced
    call is bracketed by a marker kernel on each side, and a trace that
    lacks either marker is tried again: CUPTI's tracing is not always
    available to the process, and a trace may drop the kernels launched
    just after it starts.  ``partial_ok``: with no whole trace, the first
    trace that holds any of ``fn``'s kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    partial = None
    for i in range(tries):
        activities = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if i % 2 else [])
        with profile(activities=activities) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if "CUDA" in str(ev.device_type) for _ in range(ev.count)]
        own = [k for k in names if TRACE_MARKER not in k]
        if len(names) - len(own) == 2:
            return own
        partial = partial or own or None
        log(f"[profiler] try {i + 1} of {tries} traced {len(own)} of the "
            f"call's device kernels and {len(names) - len(own)} of the 2 "
            f"markers: not whole")
    return partial if partial_ok else None


def check_k2_wide(fn, what: str, exact: bool = True) -> None:
    """Fail unless one warm call of ``fn``, K2 above 256 bins, runs only
    the two-level path's kernels: no table walk, no torch op.  ``exact``:
    also all four of them (prep, two look-back levels, unstage) once each.
    On a process group the profiler has traced no kernel of a call, or
    dropped the last one, so there the trace is held to the path's
    kernels only.  Where the profiler gives no whole trace, it is logged
    as not checked."""
    names = kernel_names(fn, partial_ok=not exact)
    if names is None:
        log(f"[kernels] one K2 call at {what}: not checked, the profiler "
            f"gave no whole trace")
        return
    log(f"[kernels] one K2 call at {what} runs {json.dumps(names)}")
    found = [sum(w in k for k in names) for w in K2_WIDE_KERNELS]
    if sum(found) != len(names) or any(
            f > want for f, want in zip(found, (1, 2, 1))):
        raise AssertionError(f"K2 at {what} ran {names}, expected only "
                             f"{list(K2_WIDE_KERNELS)} x [1, 2, 1]")
    if exact and found != [1, 2, 1]:
        raise AssertionError(f"K2 at {what} ran {names}, expected "
                             f"{list(K2_WIDE_KERNELS)} x [1, 2, 1]")


def check_k1_wide(fn, what: str) -> None:
    """Fail unless one warm call of ``fn``, K1 above 2**14 bins, runs the
    cluster kernel once and no other histogram kernel (the output's fill
    aside).  Logged as not checked where the profiler gives no whole
    trace."""
    names = kernel_names(fn)
    if names is None:
        log(f"[kernels] one K1 call at {what}: not checked, the profiler "
            f"gave no whole trace")
        return
    log(f"[kernels] one K1 call at {what} runs {json.dumps(names)}")
    k1 = [k for k in names if "histogram" in k]
    if len(k1) != 1 or K1_WIDE_KERNEL not in k1[0]:
        raise AssertionError(f"K1 at {what} ran {names}, expected "
                             f"{K1_WIDE_KERNEL} alone")


def sass_hmma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions per kernel in ``lib``'s SASS."""
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            counts[fn] += 1
    return counts


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                tol: float) -> float:
    """Raise unless |got - want| <= tol + tol * |want| everywhere (and both
    are finite, of one shape); return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} values beyond "
                             f"{tol} (max |err| {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def lm_phases(args, dev, card: str, path_counts: dict) -> tuple:
    """Phases 7-10: K5 against its plain version, llama3.2-1b prefill and
    serve on the card, and their times.  Adds the prefill and serve
    launch counts to ``path_counts``; returns (kernel table rows, e2e
    rows)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.serve import FractalScheduler, make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.train_lib import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[lm] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    B, S = PREFILL_BATCH, PREFILL_SEQ
    cfg = get_config("llama3.2-1b")
    if args.lm_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.lm_layers)
    H, hd = cfg.n_heads, cfg.resolved_head_dim

    def qkv(rng, shape, dtype):
        b, sq, h, d, skv = shape
        return tuple(torch.from_numpy(rng.standard_normal(sh, np.float32)).to(
            dev, dtype) for sh in ((b, sq, h, d), (b, skv, h, d),
                                   (b, skv, h, d)))

    # -- 7. K5 against its plain version ----------------------------------------
    t0 = time.perf_counter()
    rng = phase_rng(args.seed, 7)
    k5_err = {"float32": 0.0, "bfloat16": 0.0}
    full = (B, S, H, hd, S)
    moe_cfg = get_config(MOE_ARCH)
    moe_full = (B, S, moe_cfg.n_heads, moe_cfg.resolved_head_dim, S)
    # phase 19's whisper shapes: the encoder over n_audio_ctx frames (no
    # tile divides 1500) and the decoder's cross-attention to them
    audio_cfg = get_config(AUDIO_ARCH)
    audio_enc = (B, AUDIO_FRAMES, audio_cfg.n_heads,
                 audio_cfg.resolved_head_dim, AUDIO_FRAMES)
    audio_cross = (B, TEXT_CTX, *audio_enc[2:])
    # (B, Sq, H, hd, Skv, q a strided slice): the reference's test shapes,
    # one query row, fewer keys than queries, hd 8 and 80 (zero-padded to
    # the fragment depth), hd 96 and 128, an hd that takes the
    # element-wise loads, a strided q, the two models' prefill shapes, and
    # whisper's encoder and cross-attention shapes
    shapes = ((2, 64, 4, 16, 64, False), (1, 48, 2, 8, 80, False),
              (2, 100, 2, 32, 100, False), (2, 1, 3, 64, 70, False),
              (1, 150, 2, 64, 40, False), (2, 77, 2, 8, 77, False),
              (1, 90, 2, 80, 130, False), (2, 33, 2, 96, 65, False),
              (1, 130, 2, 128, 70, False), (1, 33, 2, 20, 47, False),
              (2, 65, 2, 64, 65, True), (*full, False),
              (*moe_full, False), (*audio_enc, False), (*audio_cross, False))
    for *shape, strided in shapes:
        shape = tuple(shape)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            tol = (2e-2 if dtype == torch.bfloat16
                   else 1e-4 if shape in (full, moe_full, audio_enc,
                                          audio_cross) else 2e-5)
            q, k, v = qkv(rng, shape, dtype)
            if strided:  # heads [1:1+H] and hd [0:hd) of a wider tensor
                b, sq, h, d, _ = shape
                q = qkv(rng, (b, sq, h + 2, d + 16, 1),
                        dtype)[0][:, :, 1:1 + h, :d]
            for causal in (True, False):
                err = check_close(
                    f"K5 {dname} {shape} strided q={strided} causal={causal}",
                    flash_attention_kernel(q, k, v, causal=causal),
                    ref.flash_attention_ref(q, k, v, causal=causal), tol)
                k5_err[dname] = max(k5_err[dname], err)
            del q, k, v
    log(f"[kernels] K5 flash attention within tolerance of its plain "
        f"version at {len(shapes)} shapes x causal/not x fp32/bf16 "
        f"({time.perf_counter() - t0:.1f} s); max |err| {json.dumps(k5_err)}")

    # -- 8. prefill ----------------------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = T.Transformer(cfg, device=dev).init_params(gen)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.from_numpy(phase_rng(args.seed, 8).integers(
        0, cfg.vocab, (B, S)).astype(np.int64)).to(dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(dataclasses.replace(
        cfg, use_pallas_attention=True))
    prefill_plain = make_prefill_step(dataclasses.replace(
        cfg, use_pallas_attention=False))
    log(f"[prefill] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{H} q / {cfg.n_kv_heads} kv heads x {hd}, vocab {cfg.vocab}, "
        f"{n_params / 1e9:.3f} B fp32 parameters from seed {args.seed} "
        f"({time.perf_counter() - t0:.1f} s to build)")
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    path_counts["prefill"] = ops.launch_counts()
    k5 = path_counts["prefill"]["flash_attention_kernel"]
    if k5 != cfg.n_layers:
        raise AssertionError(f"prefill launched K5 {k5} times, expected one "
                             f"per layer ({cfg.n_layers})")
    logits_plain = prefill_plain(model, batch)
    # fp32 through 16 layers, attention sums in another order
    prefill_err = check_close("prefill logits, K5 vs plain attention",
                              logits, logits_plain, 1e-3)
    log(f"[prefill] B={B} S={S}: logits {tuple(logits.shape)} finite, within "
        f"1e-3 of the plain path (max |err| {prefill_err:.3e}); K5 launches "
        f"{k5}")
    del logits_plain

    # -- 9. serve ------------------------------------------------------------------
    steps = 8  # decode reproduces the prefill's first tokens
    decode = make_decode_step(cfg)
    cache = T.init_cache(cfg, B, steps, model.dtype, dev)
    with torch.inference_mode():
        dec = []
        for t in range(steps):
            step_logits, cache = T.decode_step(model, cfg, cache,
                                               tokens[:, t:t + 1], t)
            dec.append(step_logits[:, 0])
    decode_err = check_close("decode vs prefill logits",
                             torch.stack(dec, 1), logits[:, :steps], 1e-3)
    nxt, _ = decode(model, T.init_cache(cfg, B, 1, model.dtype, dev),
                    tokens[:, :1], 0)
    if not torch.equal(nxt[:, 0].long(), logits[:, 0].argmax(-1)):
        raise AssertionError("greedy decode step disagrees with the prefill")
    del logits, dec, cache, step_logits
    log(f"[serve] {steps} decode steps within 1e-3 of the prefill logits "
        f"(max |err| {decode_err:.3e})")
    requests = make_requests(8, cfg.vocab, phase_rng(args.seed, 9))
    on_card, on_cpu = FractalScheduler(dev), FractalScheduler("cpu")
    for r in requests:
        on_card.add(r)
        on_cpu.add(r)
    order = [[r.rid for r in on_card.take(1)] for _ in requests]
    if order != [[r.rid for r in on_cpu.take(1)] for _ in requests]:
        raise AssertionError("scheduler order on the card differs from the "
                             "CPU's")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve(model, requests, batch_slots=4, max_len=96)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    path_counts["serve"] = ops.launch_counts()
    unanswered = [r.rid for r in served if len(r.out) != r.max_new
                  or not all(0 <= t < cfg.vocab for t in r.out)]
    if unanswered:
        raise AssertionError(f"requests not answered in full: {unanswered}")
    for name in ("fractal_histogram", "fractal_rank_kernel"):
        if path_counts["serve"][name] <= 0:
            raise AssertionError(f"the scheduler's sorts launched no {name}")
    generated = sum(len(r.out) for r in served)
    fed = sum(len(r.prompt) + len(r.out) - 1 for r in served)
    log(f"[serve] {len(served)}/{len(requests)} requests answered in "
        f"{serve_s:.3f} s ({generated} tokens generated); admission order "
        f"{[o[0] for o in order]} equal on card and CPU; launches "
        f"{json.dumps(path_counts['serve'])}")

    # -- 10. times -------------------------------------------------------------------
    table = []
    rng = phase_rng(args.seed, 10)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        q, k, v = qkv(rng, full, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound, bound_by, route, fma_bound = attention_bound_ms(
            B, S, S, H, hd, True, dtype)
        row = {
            "ms": cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=True)),
            "plain_ms": cuda_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=True), 1, 3),
            "bound_ms": bound, "bound_by": bound_by, "bound_route": route,
            "library_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
            "max_abs_err": k5_err[dname],
        }
        log(f"[time] K5 {dname} (q, k, v {full[:4]}, causal): {row['ms']:.3f} "
            f"ms, bound {bound:.3f} ms ({bound_by}, {route}), plain "
            f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.3f} ms; "
            f"earlier runs: first version {FIRST_VERSION_MS[f'k5_{dname}']} "
            f"ms, its fp32-FMA bound {fma_bound:.3f} ms")
        if dtype == torch.float32:
            entry = {"name": "flash_attention_kernel", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:106",
                     "launches": 0, **row,
                     "shape": f"q, k, v {full[:4]} fp32, causal"}
        else:
            entry.update({f"bf16_{key}": val for key, val in row.items()})
        del q, k, v, qt, kt, vt
    table.append(entry)

    if args.profile:
        log(json.dumps({"profile_prefill": profile_call(
            lambda: prefill(model, batch)), "card": card}))
        log(json.dumps({"profile_serve": profile_call(
            lambda: serve(model, make_requests(
                8, cfg.vocab, phase_rng(args.seed, 9)), 4, 96)),
            "card": card}))
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    prefill_plain_ms = cuda_ms(lambda: prefill_plain(model, batch), 1, 3)
    e2e = [{
        "name": f"prefill {cfg.name} B={B} S={S} fp32, K5 attention",
        "layers": cfg.n_layers, "ms": prefill_ms,
        "plain_attention_ms": prefill_plain_ms,
        "tokens_per_s": B * S / prefill_ms * 1e3,
    }, {
        "name": f"serve {cfg.name} fp32: 8 requests, 4 slots, max_len 96",
        "layers": cfg.n_layers, "wall_s": serve_s,
        "generated_tokens": generated, "fed_tokens": fed,
        "generated_tokens_per_s": generated / serve_s,
        "fed_tokens_per_s": fed / serve_s,
    }]
    for row in e2e:
        log(f"[e2e] {row}")
    return table, e2e


def tpch_days(year: int, month: int, day: int) -> int:
    return (datetime.date(year, month, day) - datetime.date(1970, 1, 1)).days


def tpch_tables(seed: int, log2_lines: int, dev) -> tuple:
    """``orders`` (2**(log2_lines - 2) rows) and ``lineitem`` (1-7 lines
    an order, about 2**log2_lines rows) in the column shapes of TPC-H's
    dbgen (spec 4.2.3), drawn on the card from ``(seed, 11)``: sparse
    order keys (the first 8 of every 32), order dates uniform over
    1992-01-01..1998-08-02, ship dates 1-121 days after, receipt 1-30
    days after that, return flag R or A if received by 1995-06-17 else N,
    line status O if shipped after it else F, quantity 1-50, extended
    price quantity x a retail price of 900.00-2099.00, discount
    0.00-0.10, total price the order's lines' extended prices.  Both
    tables' rows are shuffled, so no sort sees presorted input.  Days
    count from 1970-01-01 as int32."""
    from repro_torch.query import Table

    gen = torch.Generator(device=dev).manual_seed(
        int(phase_rng(seed, 11).integers(1 << 62)))

    def randint(lo, hi, n):  # [lo, hi]
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    n_orders = 1 << (log2_lines - 2)
    i = torch.arange(n_orders, device=dev, dtype=torch.int32)
    okey = ((i >> 3) << 5) + (i & 7) + 1
    odate = randint(tpch_days(1992, 1, 1), tpch_days(1998, 8, 2), n_orders)
    lines = randint(1, 7, n_orders)
    n_lines = int(lines.sum())
    order = torch.repeat_interleave(
        torch.arange(n_orders, device=dev), lines.long(), output_size=n_lines)
    first = torch.cumsum(lines, 0, dtype=torch.int32) - lines
    linenumber = (torch.arange(n_lines, device=dev, dtype=torch.int32)
                  - first[order] + 1)
    qty = randint(1, 50, n_lines)
    price = qty.double() * randint(90000, 209900, n_lines).double() / 100.0
    discount = randint(0, 10, n_lines).float() / 100.0
    ship = odate[order] + randint(1, 121, n_lines)
    receipt = ship + randint(1, 30, n_lines)
    today = tpch_days(1995, 6, 17)
    coin = randint(0, 1, n_lines).bool()
    flag = torch.where(receipt <= today,
                       torch.where(coin, ord("R"), ord("A")), ord("N"))
    status = torch.where(ship > today, ord("O"), ord("F"))
    total = torch.zeros(n_orders, dtype=torch.float64, device=dev)
    total.index_add_(0, order, price)
    operm = torch.randperm(n_orders, generator=gen, device=dev)
    lperm = torch.randperm(n_lines, generator=gen, device=dev)
    orders = Table({"o_orderkey": okey[operm], "o_orderdate": odate[operm],
                    "o_totalprice": total[operm]}, device=dev)
    lineitem = Table({
        "l_orderkey": okey[order][lperm], "l_linenumber": linenumber[lperm],
        "l_quantity": qty[lperm], "l_extendedprice": price[lperm],
        "l_discount": discount[lperm], "l_shipdate": ship[lperm],
        "l_returnflag": flag[lperm].to(torch.uint8),
        "l_linestatus": status[lperm].to(torch.uint8)}, device=dev)
    return orders, lineitem


def f64_order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 values as int64 in IEEE total order (the sign-magnitude
    transform, derived here independently of the port's codec)."""
    v = x.view(torch.int64)
    return v ^ ((v >> 63) & 0x7FFFFFFFFFFFFFFF)


def stable_lex_perm(*keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting by ``keys`` (first key most significant):
    one stable ``torch.argsort`` a key, least significant first."""
    perm = torch.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def plain_join(left_key: torch.Tensor, right_key: torch.Tensor) -> tuple:
    """Inner-join row pairs in (key, left arrival, right arrival) order:
    stable argsorts of both sides, per-key match ranges by
    ``torch.searchsorted``."""
    lperm = torch.argsort(left_key.long(), stable=True)
    rperm = torch.argsort(right_key.long(), stable=True)
    lk, rk = left_key.long()[lperm], right_key.long()[rperm]
    lo = torch.searchsorted(rk, lk)
    cnt = torch.searchsorted(rk, lk, right=True) - lo
    total = int(cnt.sum())
    lpos = torch.repeat_interleave(cnt, output_size=total)
    rpos = (torch.arange(total, device=lk.device)
            + (lo - (torch.cumsum(cnt, 0) - cnt))[lpos])
    return lperm[lpos], rperm[rpos]


def plain_groups(key: torch.Tensor) -> tuple:
    """(sorted distinct keys, each row's group) by ``torch.unique``."""
    return torch.unique(key, sorted=True, return_inverse=True)


def segment_sum(inv: torch.Tensor, vals: torch.Tensor, groups: int):
    return torch.zeros(groups, dtype=vals.dtype,
                       device=vals.device).index_add_(0, inv, vals)


def segment_extreme(inv: torch.Tensor, vals: torch.Tensor, groups: int,
                    how: str):
    return torch.empty(groups, dtype=vals.dtype, device=vals.device
                       ).scatter_reduce_(0, inv, vals, how, include_self=False)


def count_syncs(fn):
    """``fn()`` under CUDA's sync debug mode: returns (its result, the
    synchronizing calls it made: the host's waits for scalars)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in seen)


def query_ms(fn, iters: int = 3) -> tuple:
    """(CUDA-event ms, host wall ms) of one call of ``fn``, medians of
    ``iters`` after one warm-up; the call's own host syncs count."""
    fn()
    torch.cuda.synchronize()
    ev, wall = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end))
    return statistics.median(ev), statistics.median(wall)


def query_phases(args, dev, card: str, path_counts: dict) -> list:
    """Phases 11-12: TPC-H-shaped ``orders`` and ``lineitem`` on the card,
    six queries through ``repro_torch.query`` held against plain-torch
    oracles, the query path's kernel launches, and each query's time
    beside its plain-torch yardstick.  Adds ``path_counts["query"]``;
    returns the e2e rows."""
    from repro_torch import query as Q
    from repro_torch.core import make_sort_plan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram
    from repro_torch.kernels.fractal_rank import fractal_rank_kernel

    # -- 11. tables, queries, oracles --------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    orders, lineitem = tpch_tables(args.seed, args.query_log2n, dev)
    torch.cuda.synchronize()
    n_lines = lineitem.num_rows
    col_bytes = sum(c.numel() * c.element_size()
                    for t in (orders, lineitem)
                    for c in (t.column(n) for n in t.column_names))
    log(f"[query] orders {orders.num_rows} rows, lineitem {n_lines} rows "
        f"({col_bytes / 2**30:.2f} GiB of columns on the card) from seed "
        f"{args.seed} in {time.perf_counter() - t0:.1f} s")
    L = lineitem.column
    o3 = Q.Table({"orderkey": orders.column("o_orderkey"),
                  "o_orderdate": orders.column("o_orderdate")}, device=dev)
    l3 = Q.Table({"orderkey": L("l_orderkey"),
                  "l_extendedprice": L("l_extendedprice"),
                  "l_discount": L("l_discount")}, device=dev)
    seg_log2 = 20
    m = (n_lines >> seg_log2) << seg_log2
    batch_words = Q.Float64Codec().encode(L("l_extendedprice")[:m])
    q1_aggs = {"sum_qty": ("l_quantity", "sum"),
               "sum_base_price": ("l_extendedprice", "sum"),
               "count_order": (None, "count"),
               "min_shipdate": ("l_shipdate", "min"),
               "max_shipdate": ("l_shipdate", "max")}

    def q3():
        j = Q.sort_merge_join(o3, l3, "orderkey")
        j = j.with_columns({"revenue": j.column("l_extendedprice")
                            * (1 - j.column("l_discount").double())})
        g = Q.group_by(j, "orderkey", {"revenue": ("revenue", "sum"),
                                       "o_orderdate": ("o_orderdate", "min")})
        return j, g, Q.top_k(g, [("revenue", "desc"), ("o_orderdate", "asc")],
                             10)

    # the port's queries, and each one's plain-torch yardstick (the
    # oracle's own computation, never called by the port)
    def q1_plain():
        uniq, inv = plain_groups((L("l_returnflag").long() << 8)
                                 | L("l_linestatus").long())
        g = uniq.numel()
        ship = L("l_shipdate")
        return {"l_returnflag": (uniq >> 8).to(torch.uint8),
                "l_linestatus": (uniq & 255).to(torch.uint8),
                "sum_qty": segment_sum(inv, L("l_quantity").long(), g),
                "sum_base_price": segment_sum(inv, L("l_extendedprice"), g),
                "count_order": torch.bincount(inv, minlength=g),
                "min_shipdate": segment_extreme(inv, ship, g, "amin"),
                "max_shipdate": segment_extreme(inv, ship, g, "amax")}

    def q3_plain():
        lrows, rrows = plain_join(o3.column("orderkey"), l3.column("orderkey"))
        revenue = (l3.column("l_extendedprice")[rrows]
                   * (1 - l3.column("l_discount")[rrows].double()))
        uniq, inv = plain_groups(o3.column("orderkey")[lrows])
        g = uniq.numel()
        rev = segment_sum(inv, revenue, g)
        odate = segment_extreme(inv, o3.column("o_orderdate")[lrows], g,
                                "amin")
        top = stable_lex_perm(~f64_order_key(rev), odate.long())[:10]
        return lrows, rrows, uniq, rev, odate, top

    def gather_all(perm):
        return {n: L(n)[perm] for n in lineitem.column_names}

    def orderby3_plain():
        return gather_all(stable_lex_perm(~f64_order_key(L("l_extendedprice")),
                                          L("l_orderkey").long()))

    def orderby16_plain():
        return gather_all(torch.argsort(L("l_shipdate"), stable=True))

    def distinct_plain():
        uniq, inv = plain_groups(L("l_shipdate"))
        rows = torch.arange(n_lines, device=dev)
        return gather_all(segment_extreme(inv, rows, uniq.numel(), "amin"))

    def batched_plain():
        seg = torch.arange(m, device=dev) >> seg_log2
        perm = stable_lex_perm(seg, f64_order_key(L("l_extendedprice")[:m]))
        return batch_words[perm], perm

    queries = {
        "q1": (lambda: Q.group_by(lineitem, ["l_returnflag", "l_linestatus"],
                                  q1_aggs), q1_plain),
        "q3": (q3, q3_plain),
        "order_by_3word": (lambda: Q.order_by(
            lineitem, [("l_extendedprice", "desc"), "l_orderkey"]),
            orderby3_plain),
        "order_by_shipdate_16bit": (lambda: Q.order_by(
            lineitem, "l_shipdate", codecs={"l_shipdate": Q.IntCodec(16)}),
            orderby16_plain),
        "distinct_shipdate": (lambda: Q.distinct(lineitem, ["l_shipdate"]),
                              distinct_plain),
        "sort_rowids_batched": (lambda: Q.operators.sort_rowids_batched(
            batch_words, 64, seg_log2), batched_plain),
    }

    def same(what, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want.to(got.dtype)):
            raise AssertionError(f"{what}: differs from the plain-torch oracle")

    def close(what, got, want, rtol):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: shape or non-finite values")
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
        if rel > rtol:
            raise AssertionError(f"{what}: relative error {rel:.3e} > {rtol}")
        return rel

    def same_table(what, got, want: dict):
        if list(got.column_names) != list(want):
            raise AssertionError(f"{what}: columns {got.column_names}")
        for name, col in want.items():
            same(f"{what} {name}", got.column(name), col)

    checks, syncs, rel_errs = {}, {}, {}
    counts = {k: 0 for k in ops.KERNELS}
    for name, (port, plain) in queries.items():
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        got, syncs[name] = count_syncs(port)
        launched = ops.launch_counts()
        for k, c in launched.items():
            counts[k] += c
        want = plain()
        if name == "q1":
            same_table(name, got.select(["l_returnflag", "l_linestatus",
                                         "count_order", "min_shipdate",
                                         "max_shipdate"]),
                       {k: want[k] for k in ("l_returnflag", "l_linestatus",
                                             "count_order", "min_shipdate",
                                             "max_shipdate")})
            same("q1 sum_qty", got.column("sum_qty"), want["sum_qty"])
            rel_errs[name] = close("q1 sum_base_price",
                                   got.column("sum_base_price"),
                                   want["sum_base_price"], QUERY_F64_RTOL)
            checks[name] = f"{got.num_rows} groups"
        elif name == "q3":
            j, g, top = got
            lrows, rrows, uniq, rev, odate, _ = want
            for col in ("orderkey", "o_orderdate"):
                same(f"q3 join {col}", j.column(col), o3.column(col)[lrows])
            for col in ("l_extendedprice", "l_discount"):
                same(f"q3 join {col}", j.column(col), l3.column(col)[rrows])
            same("q3 group keys", g.column("orderkey"), uniq)
            same("q3 group o_orderdate", g.column("o_orderdate"), odate)
            rel_errs[name] = close("q3 group revenue", g.column("revenue"),
                                   rev, QUERY_F64_RTOL)
            # top-k of the port's own groups (sums equal only to rtol)
            perm = stable_lex_perm(~f64_order_key(g.column("revenue")),
                                   g.column("o_orderdate").long())[:10]
            same_table("q3 top_k", top, {c: g.column(c)[perm]
                                         for c in g.column_names})
            checks[name] = (f"join {j.num_rows} rows, {g.num_rows} groups, "
                            f"top revenue {float(top.column('revenue')[0]):.2f}")
            q3_groups = g
        elif name == "sort_rowids_batched":
            same("batched words", got[0], want[0])
            same("batched row ids", got[1].long(), want[1])
            checks[name] = f"{m} rows in {m >> seg_log2} segments"
        else:
            same_table(name, got, want)
            checks[name] = f"{got.num_rows} rows"
        del got, want
        log(f"[query] {name}: bit-exact against its oracle"
            + (f" (float64 sums within {QUERY_F64_RTOL}: max rel err "
               f"{rel_errs[name]:.2e})" if name in rel_errs else "")
            + f"; {checks[name]}; {syncs[name]} host syncs; launches "
            f"{json.dumps({k: c for k, c in launched.items() if c})} "
            f"({time.perf_counter() - t1:.1f} s with the check)")
    path_counts["query"] = counts
    for name in ("fractal_histogram", "fractal_rank_kernel"):
        if counts[name] <= 0:
            raise AssertionError(f"the query path launched no {name}")
    log(f"[launches] query path: {json.dumps(counts)} (K3 "
        f"{counts['fractal_rank_scatter_kernel']}, K4 "
        f"{counts['fractal_reconstruct']}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")

    # K1 and K2 at the query path's own shapes, against their plain
    # versions on the same inputs (these launches count on no path):
    # top-k's prune histogram over Q3's groups, and the first pass of the
    # batched sort's least significant word (its (segment, digit) table
    # and its rank from zero bin starts)
    def agree(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want.to(got.dtype)):
            raise AssertionError(f"{what}: differs from its plain version")
        log(f"[check] {what}: bit-exact with its plain version")

    by = [("revenue", "desc"), ("o_orderdate", "asc")]
    codec, prepped = Q.operators._key_data(q3_groups, by, None)
    width0 = Q.word_widths(codec.bits)[0]
    top_bits = min(Q.operators._TOPK_PRUNE_BITS, width0)
    w0 = codec.encode_fn(prepped)[:, 0]
    prefix = ((w0 >> (width0 - top_bits)) & ((1 << top_bits) - 1)).contiguous()
    agree(f"K1 top-k prune, {prefix.numel()} rows x {1 << top_bits} bins",
          fractal_histogram(prefix, 1 << top_bits),
          ref.histogram_ref(prefix, 1 << top_bits))
    del q3_groups, prepped, w0, prefix
    j, eff = Q.operators.active_words(64)[-1]
    dp = make_sort_plan(1 << seg_log2, eff).passes[0]
    digit = ((batch_words[:, j] >> dp.shift) & (dp.n_bins - 1)).contiguous()
    cells = (m >> seg_log2) * dp.n_bins
    cell = (torch.arange(m, dtype=torch.int32, device=dev) >> seg_log2
            ) * dp.n_bins + digit
    agree(f"K1 segment table, {m} rows x {cells} cells",
          fractal_histogram(cell, cells), ref.histogram_ref(cell, cells))
    zero = torch.zeros((dp.n_bins,), dtype=torch.int32, device=dev)
    agree(f"K2 zero bin starts, {m} rows x {dp.n_bins} bins",
          fractal_rank_kernel(digit, zero, dp.n_bins),
          ref.rank_ref(digit, zero, dp.n_bins))
    del digit, cell

    # -- 12. times ------------------------------------------------------------------
    e2e = []
    for name, (port, plain) in queries.items():
        ms, wall = query_ms(port)
        plain_ms, plain_wall = query_ms(plain)
        e2e.append({"name": f"query {name}", "lineitem_rows": n_lines,
                    "ms": ms, "wall_ms": wall, "yardstick_ms": plain_ms,
                    "yardstick_wall_ms": plain_wall,
                    "host_syncs": syncs[name]})
        log(f"[e2e] {e2e[-1]}")
    if args.profile:
        log(json.dumps({"profile_query": {
            name: profile_call(port, top=12)
            for name, (port, _) in queries.items()}, "card": card}))
    return e2e


def zipf_on_card(seed: int, phase: int, a: float, n: int, dev) -> np.ndarray:
    """``n`` draws of Zipf(``a``) as host uint32, clamped to 2**32 - 1,
    drawn on the card from ``(seed, phase)``: numpy's rejection sampler
    (Devroye's, ``Generator.zipf``), vectorized, redrawing the rejected
    slots; draws past 2**63 are rejected as numpy rejects them."""
    gen = torch.Generator(device=dev).manual_seed(
        int(phase_rng(seed, phase).integers(1 << 62)))
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.float64, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
        v = torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1) & (x < 2.0 ** 63) & (v * x * (t - 1.0) / (b - 1.0)
                                            <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out.clamp(max=(1 << 32) - 1).long().cpu().numpy().astype(np.uint32)


def span_seconds(tr, name: str) -> float:
    """Wall seconds of the spans named ``name`` in trace ``tr``."""
    return sum(s["t1"] - s["t0"] for s in tr.find(name))


STREAM_SPANS = ("stream.histogram", "stream.distribute",
                "stream.partition_sort", "store.put", "store.get")


def stream_phases(args, dev, card: str, path_counts: dict) -> tuple:
    """Phases 13-14: the external sort of 2**log2n host keys under a
    device budget of 1/8 of their bytes, and three streaming queries over
    lineitem rows held on the host, each bit-exact against its in-memory
    result on the card.  Adds ``path_counts["stream"]``; returns (e2e
    rows, the kernels' max |err| at the stream's shapes)."""
    from repro_torch import query as Q
    from repro_torch import stream as S
    from repro_torch.core import exclusive_cumsum, fractal_sort
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram
    from repro_torch.kernels.fractal_rank import fractal_rank_kernel
    from repro_torch.obs import trace
    from repro_torch.stream.external import row_cost_bytes

    counts = {k: 0 for k in ops.KERNELS}

    def launched(fn):
        """``fn()`` with the kernels' launches added to the stream path's."""
        ops.reset_launch_counts()
        out = fn()
        for k, c in ops.launch_counts().items():
            counts[k] += c
        return out

    def same(what, got: torch.Tensor, want: torch.Tensor):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its check")

    # -- 13. the external sort ----------------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    rng = phase_rng(args.seed, 13)
    data = {
        "uniform": rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),
        "zipf": zipf_on_card(args.seed, 13, 1.2, n, dev),
    }
    limit = 4 * n // 8  # 1/8 of the key bytes: 64 MiB at n = 2**27
    rows = S.MemoryBudget(limit).rows(row_cost_bytes(1))
    log(f"[stream] n = 2**{args.log2n} host keys a set ({4 * n / 2**20:.0f} "
        f"MiB), budget {limit / 2**20:.0f} MiB, source chunks of {rows} "
        f"rows, from seed {args.seed} in {time.perf_counter() - t0:.1f} s")

    def external(kind, keys, argsort=False, traced=True):
        """One external sort (or argsort) of host ``keys`` on the card:
        (result, wall ms, budget, the card's allocation rise, store logs,
        trace or None)."""
        budget = S.MemoryBudget(limit)
        store = S.RunStore()
        fn = S.external_argsort if argsort else S.external_sort
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ctx = trace.tracing() if traced else contextlib.nullcontext()
        with ctx as sess:
            t1 = time.perf_counter()
            out = launched(lambda: list(fn(S.ArraySource(keys, rows), 32,
                                           budget, store=store, device=dev)))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        rise = torch.cuda.max_memory_allocated() - base
        logs = (sum(store.put_log_bytes), sum(store.get_log_bytes),
                len(store.put_log))  # fragments: base runs and slices
        store.close()
        # the keys come back as uint32 views; concatenate their int32 bits
        if argsort:
            out = (torch.cat([k.view(torch.int32) for k, _ in out]),
                   torch.cat([i for _, i in out]))
        else:
            out = torch.cat([k.view(torch.int32) for k in out])
        return (out, wall, budget, rise, logs,
                sess.trace if traced else None)

    def oracle(keys):
        k64 = torch.from_numpy(keys).to(dev).view(torch.int32).long() \
            & 0xFFFFFFFF
        return torch.sort(k64, stable=True)

    e2e, peaks = [], []
    for kind, argsort in (("uniform", False), ("zipf", False),
                          ("uniform", True)):
        keys = data[kind]
        out, wall, budget, rise, (put_b, get_b, puts), tr = external(
            kind, keys, argsort)
        want = oracle(keys)
        if argsort:
            same(f"external_argsort {kind} keys",
                 out[0].to(dev).long() & 0xFFFFFFFF, want.values)
            same(f"external_argsort {kind} row ids", out[1].to(dev),
                 want.indices)
        else:
            same(f"external_sort {kind}", out.to(dev).long() & 0xFFFFFFFF,
                 want.values)
        del out, want
        if budget.peak_bytes > budget.limit_bytes:
            raise AssertionError(f"{kind}: budget peak {budget.peak_bytes} > "
                                 f"limit {budget.limit_bytes}")
        if rise > budget.limit_bytes:
            raise AssertionError(f"{kind}: the card's allocations rose "
                                 f"{rise} bytes, over the {limit}-byte budget")
        peaks.append(rise)
        levels = sorted({s["attrs"]["level_bits"]
                         for s in tr.find("stream.histogram")}, reverse=True)
        top = [s for s in tr.find("stream.distribute") if s["parent"] is None]
        name = f"external_{'argsort' if argsort else 'sort'} {kind}"
        row = {"name": name, "n": n, "budget_bytes": limit, "wall_ms": wall,
               "partitions": top[0]["attrs"]["partitions"] if top else 1,
               "recursion_depth": len(levels) - 1,
               "spilled_bytes": put_b, "read_back_bytes": get_b,
               "fragments": puts, "budget_peak_bytes": budget.peak_bytes,
               "device_peak_rise_bytes": rise,
               "span_s": {k: span_seconds(tr, k) for k in STREAM_SPANS}}
        e2e.append(row)
        log(f"[stream] {name}: bit-exact against torch.sort; {json.dumps(row)}")
    # the same sort untraced (the spans' cost), and the in-memory sorts of
    # the same keys on the card
    keys = data["uniform"]
    _, wall, _, _, _, _ = external("uniform", keys, traced=False)
    on_card = torch.from_numpy(keys).to(dev)
    k64 = on_card.view(torch.int32).long() & 0xFFFFFFFF
    e2e.append({"name": "external_sort uniform, untraced", "n": n,
                "wall_ms": wall,
                "fractal_sort_ms": cuda_ms(
                    lambda: fractal_sort(on_card, 32, device=dev), 1, 3),
                "torch_sort_ms": cuda_ms(lambda: torch.sort(k64), 1, 3)})
    log(f"[stream] {json.dumps(e2e[-1])}")
    del on_card, k64
    # REPRO_STREAM_WORKERS=2 gives the single worker's output
    n24 = min(n, 1 << 24)
    sub = data["uniform"][:n24]
    outs = {}
    for workers in (1, 2):
        os.environ["REPRO_STREAM_WORKERS"] = str(workers)
        budget = S.MemoryBudget(limit)
        t1 = time.perf_counter()
        parts = launched(lambda: list(S.external_argsort(
            S.ArraySource(sub, rows), 32, budget, device=dev)))
        outs[workers] = (torch.cat([k.view(torch.int32) for k, _ in parts]),
                         torch.cat([i for _, i in parts]))
        log(f"[stream] external_argsort n=2**{n24.bit_length() - 1} with "
            f"{workers} worker(s): {(time.perf_counter() - t1) * 1e3:.1f} ms, "
            f"budget peak {budget.peak_bytes} bytes")
    os.environ.pop("REPRO_STREAM_WORKERS")
    for a, b in zip(outs[1], outs[2]):
        if not torch.equal(a, b):
            raise AssertionError("2 stream workers changed the output")
    log("[stream] 2 workers: the output equals the single worker's")
    del outs, parts

    # K1 and K2 at the stream's shapes against their plain versions (these
    # launches count on no path): a chunk's 1024-bin field carried onto
    # the counts of the chunk before, and distribute's partition ids
    errs = {"fractal_histogram": 0, "fractal_rank_kernel": 0}

    def agree(kernel, what, got, want):
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        if err:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {what}: max |err| = {err}")
        log(f"[check] {kernel} at {what}: bit-exact with its plain version")

    keys = torch.from_numpy(data["uniform"][:2 * rows]).to(dev)
    field = (keys.view(torch.int32) >> 22) & 1023
    carry = fractal_histogram(field[:rows].contiguous(), 1024)
    chunk = field[rows:].contiguous()
    agree("fractal_histogram", f"{chunk.numel()} rows x 1024 bins, init",
          fractal_histogram(chunk, 1024, init=carry),
          ref.histogram_ref(chunk, 1024, init=carry))
    top = np.bincount(data["uniform"] >> 22, minlength=1024)
    plan = S.partition_bins(top, S.MemoryBudget(limit).rows(
        row_cost_bytes(1)))
    lut = torch.from_numpy(S.partition.bin_to_partition(plan, 1024)
                           .astype(np.int32)).to(dev)
    pid = lut.index_select(0, chunk)
    n_bins = len(plan) + 1
    start = exclusive_cumsum(fractal_histogram(pid, n_bins))
    agree("fractal_rank_kernel", f"{pid.numel()} rows x {n_bins} bins "
          f"(distribute)", fractal_rank_kernel(pid, start, n_bins),
          ref.rank_ref(pid, start, n_bins))
    del keys, field, carry, chunk, pid, data

    # -- 14. streaming queries -------------------------------------------------------
    _, lineitem = tpch_tables(args.seed, args.query_log2n, dev)
    m = min(lineitem.num_rows, 1 << args.stream_log2n)
    host = Q.Table({c: lineitem.column(c)[:m].cpu()
                    for c in lineitem.column_names}, device="cpu")
    del lineitem
    card_rows = Q.Table({c: host.column(c) for c in host.column_names},
                        device=dev)
    col_bytes = sum(host.column(c).nbytes for c in host.column_names)
    q_limit = col_bytes // 8
    q1_aggs = {"sum_qty": ("l_quantity", "sum"),
               "sum_base_price": ("l_extendedprice", "sum"),
               "count_order": (None, "count"),
               "min_shipdate": ("l_shipdate", "min"),
               "max_shipdate": ("l_shipdate", "max")}
    ship16 = {"l_shipdate": Q.IntCodec(16)}
    top_by = [("l_extendedprice", "desc"), "l_orderkey"]
    queries = {
        "order_by_shipdate_16bit": (
            lambda t: Q.order_by(t, "l_shipdate", codecs=ship16)),
        "q1_group_by": (lambda t: Q.group_by(
            t, ["l_returnflag", "l_linestatus"], q1_aggs)),
        "top_k_10": lambda t: Q.top_k(t, top_by, 10),
    }
    log(f"[stream] lineitem: the first {m} rows ({col_bytes / 2**20:.0f} MiB "
        f"of columns) on the host, budget {q_limit / 2**20:.1f} MiB")
    for name, op in queries.items():
        st = S.StreamTable.from_table(host, S.MemoryBudget(q_limit),
                                      device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with trace.tracing() as sess:
            t1 = time.perf_counter()
            got = launched(lambda: op(st))
            if isinstance(got, S.StreamTable):
                got = got.to_table()
            wall = (time.perf_counter() - t1) * 1e3
        rise = torch.cuda.max_memory_allocated() - base
        want = op(card_rows)
        rel = 0.0
        for c in want.column_names:
            g, w = got.column(c).to(dev), want.column(c)
            if c == "sum_base_price":
                rel = float(((g - w).abs() / w.abs().clamp_min(1e-300)).max())
                if rel > QUERY_F64_RTOL:
                    raise AssertionError(f"{name} {c}: relative error {rel}")
            else:
                same(f"{name} {c}", g, w)
        if st.budget.peak_bytes > st.budget.limit_bytes:
            raise AssertionError(f"{name}: budget peak {st.budget.peak_bytes}"
                                 f" > limit {st.budget.limit_bytes}")
        mem_ms, _ = query_ms(lambda: op(card_rows), iters=3)
        e2e.append({"name": f"stream {name}", "rows": m,
                    "budget_bytes": q_limit, "wall_ms": wall,
                    "in_memory_ms": mem_ms,
                    "budget_peak_bytes": st.budget.peak_bytes,
                    "device_peak_rise_bytes": rise, "result_rows": got.num_rows,
                    "f64_max_rel_err": rel,
                    "recursion_depth": len({
                        s["attrs"]["level_bits"]
                        for s in sess.trace.find("stream.histogram")}) - 1,
                    "span_s": {k: span_seconds(sess.trace, k)
                               for k in STREAM_SPANS}})
        log(f"[stream] {name}: bit-exact against the in-memory operator on "
            f"the card; {json.dumps(e2e[-1])}")
        del got, want
    path_counts["stream"] = counts
    for k in ("fractal_histogram", "fractal_rank_kernel"):
        if counts[k] <= 0:
            raise AssertionError(f"the stream path launched no {k}")
    log(f"[launches] stream path: {json.dumps(counts)}; device peak rise "
        f"over the 2**{args.log2n} sorts {max(peaks)} bytes, budget {limit}")
    return e2e, errs


def k1_wide_digits(uni: torch.Tensor, zipf: torch.Tensor) -> dict:
    """The distributed pass's K1 digits at 2**16 bins: the high 16-bit
    field of phase 15's uniform and zipf(1.2) keys, and every key in one
    bin (the first uniform key's field)."""
    high = lambda k: (k.view(torch.int32) >> 16) & 0xFFFF
    u = high(uni)
    return {"uniform": u, "zipf": high(zipf),
            "one_bin": torch.full_like(u, int(u[0]))}


def k1_wide_times(digits: dict) -> dict:
    """K1 at 2**16 bins on each of ``digits``, one call at a time, beside
    its plain version and ``torch.bincount`` (a yardstick the port never
    calls); each result is first held bit-exact against the plain one."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram

    bins = 1 << 16
    times = {}
    for name, d in digits.items():
        err = max_abs_err(fractal_histogram(d, bins), ref.histogram_ref(d, bins))
        if err:
            raise AssertionError(f"fractal_histogram at 2**16 bins, {name}: "
                                 f"max |err| = {err}")
        times[name] = {
            "ms": cuda_ms(lambda: fractal_histogram(d, bins)),
            "plain_ms": cuda_ms(lambda: ref.histogram_ref(d, bins), 1, 3),
            "library_ms": cuda_ms(lambda: torch.bincount(d, minlength=bins))}
    return times


@contextlib.contextmanager
def one_rank_group(dev):
    """A one-rank process group for the distributed phases: NCCL on the
    card (the machine has one card; NCCL refuses two ranks on one), gloo
    on the CPU; rendezvous through a file, no network.  Destroyed on
    exit."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def distributed_phases(args, dev, card: str, path_counts: dict) -> tuple:
    """Phases 15-16 on a one-rank group: the distributed sort of 2**log2n
    keys on the card, then the external sort and a streaming ORDER BY
    through ``DeviceShardStore``, each bit-exact against its check.  Adds
    ``path_counts["distributed"]`` and ``path_counts["device_store"]``
    (the store's own runs only); returns (e2e rows, the kernels' max
    |err| at the path's shapes, K2's times at the pass's 2**16 bins)."""
    from repro_torch import query as Q
    from repro_torch import stream as S
    from repro_torch.core import (distributed_fractal_argsort,
                                  distributed_fractal_sort, exclusive_cumsum,
                                  fractal_sort, make_distributed_sort_pairs,
                                  make_sort_plan)
    from repro_torch.core.fractal_tree import u32_to_int64
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram
    from repro_torch.kernels.fractal_rank import (
        fractal_rank_kernel, fractal_rank_scatter_kernel, scatter_table_fits)
    from repro_torch.stream.external import row_cost_bytes

    errs = {"fractal_histogram": 0, "fractal_rank_kernel": 0}

    def agree(kernel, what, got, want):
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        if err:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {what}: max |err| = {err}")
        log(f"[check] {kernel} at {what}: bit-exact with its plain version")

    def same(what, got: torch.Tensor, want: torch.Tensor):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its check")

    def no_overflow(what, ov):
        if bool(ov):
            raise AssertionError(f"{what}: the buckets overflowed")

    def launched(counts, fn):
        """``fn()`` with the kernels' launches added to ``counts``."""
        ops.reset_launch_counts()
        out = fn()
        for k, c in ops.launch_counts().items():
            counts[k] += c
        return out

    # -- 15. the distributed sort ----------------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    rng = phase_rng(args.seed, 15)
    uni = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                           .astype(np.uint32)).to(dev)
    zipf = torch.from_numpy(zipf_on_card(args.seed, 15, 1.2, n, dev)).to(dev)
    data = {(32, "uniform"): uni, (32, "zipf"): zipf,
            (16, "uniform"): (uni.view(torch.int32) >> 16) & 0xFFFF,
            (16, "zipf"): torch.clamp(u32_to_int64(zipf), max=0xFFFF)
            .to(torch.int32)}
    payload = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(dev)
    log(f"[distributed] n = 2**{args.log2n} keys a set from seed "
        f"{args.seed} in {time.perf_counter() - t0:.1f} s; one "
        f"{'NCCL' if dev.type == 'cuda' else 'gloo'} rank")
    # K1 as the pass calls it (2**16 bins) on the uniform and zipf keys'
    # high field and on one bin: each bit-exact, then timed, before the
    # process group exists (there the profiler traces device kernels);
    # launches here count on no path
    k1_digits = k1_wide_digits(uni, zipf)
    k1_times = k1_wide_times(k1_digits)
    k1_wide = {
        "shape": f"n=2**{args.log2n}, 2**16 bins (the distributed pass's "
                 f"local histogram; uniform, zipf and one-bin digits)",
        **{key: {d: t[key] for d, t in k1_times.items()}
           for key in ("ms", "plain_ms", "library_ms")},
        # keys read once, the counts read (init) and written once
        "bound_ms": (4 * n + 8 * (1 << 16)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    log(f"[time] fractal_histogram at {k1_wide['shape']}: " + "; ".join(
        f"{d} {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, torch.bincount "
        f"{t['library_ms']:.3f})" for d, t in k1_times.items())
        + f"; bound {k1_wide['bound_ms']:.3f} ms; earlier run: global "
          f"atomics {json.dumps(GLOBAL_ATOMIC_K1_MS)} ms")
    check_k1_wide(lambda: fractal_histogram(k1_digits["zipf"], 1 << 16),
                  f"n=2**{args.log2n}, 2**16 bins, the zipf keys' high field")
    del k1_digits
    e2e = []
    with one_rank_group(dev):
        ops.reset_launch_counts()
        outs = {}
        t0 = time.perf_counter()
        for (p, dist_name), keys in data.items():
            outs[p, dist_name] = distributed_fractal_sort(keys, None, p)
        perm, perm_ov = distributed_fractal_argsort(uni, None, 32)
        pairs = make_distributed_sort_pairs(None, 32)(uni, payload)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        path_counts["distributed"] = counts
        log(f"[launches] distributed sort path ({main_s:.1f} s): "
            f"{json.dumps(counts)}")
        for k in ("fractal_histogram", "fractal_rank_kernel"):
            if counts[k] <= 0:
                raise AssertionError(f"the distributed path launched no {k}")
        # the engine rule: K3's table passes its cap at 2**16 bins here
        k3 = scatter_table_fits(n, 1 << 16)
        if k3 and counts["fractal_rank_scatter_kernel"] <= 0:
            raise AssertionError("the engine rule sends the 16-bit fields to "
                                 "K3, which never launched")
        log(f"[distributed] engine rule at n = 2**{args.log2n}, 2**16 bins: "
            f"{'K3' if k3 else 'K2 (K3 table past its cap)'}")
        for (p, dist_name), (got, ov) in outs.items():
            keys = data[p, dist_name]
            no_overflow(f"sort p={p} {dist_name}", ov)
            k64 = u32_to_int64(keys)
            same(f"distributed_fractal_sort p={p} {dist_name}",
                 u32_to_int64(got), torch.sort(k64).values)
        del outs
        k64 = u32_to_int64(uni)
        want_perm = torch.argsort(k64, stable=True)
        no_overflow("argsort", perm_ov)
        same("distributed_fractal_argsort uniform", perm.long(), want_perm)
        sk, sv, ov = pairs
        no_overflow("pairs", ov)
        same("distributed sort pairs keys", u32_to_int64(sk), k64[want_perm])
        same("distributed sort pairs int64 payload", sv, payload[want_perm])
        del perm, pairs, sk, sv, want_perm, k64
        log("[distributed] sort p=32 and p=16 (uniform, zipf(1.2)), argsort "
            "and pairs (int64 payload) bit-exact against torch.sort, no "
            "overflow")

        # K1 and K2 at the path's own shapes against their plain versions:
        # a 16-bit field of the keys, its rank from the global bin starts,
        # and the destinations over the group's D = 1 bucket
        kb = uni.view(torch.int32)
        field = (kb >> 16) & 0xFFFF
        c = fractal_histogram(field, 1 << 16)
        agree("fractal_histogram", f"n=2**{args.log2n}, 2**16 bins", c,
              ref.histogram_ref(field, 1 << 16))
        start = exclusive_cumsum(c)
        agree("fractal_rank_kernel", f"n=2**{args.log2n}, 2**16 bins",
              fractal_rank_kernel(field, start, 1 << 16),
              ref.rank_ref(field, start, 1 << 16))
        agree("fractal_rank_kernel",
              f"n=2**{args.log2n}, 2**16 bins, counts given",
              fractal_rank_kernel(field, start, 1 << 16, counts=c),
              ref.rank_ref(field, start, 1 << 16))
        dest = torch.zeros_like(field)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        agree("fractal_rank_kernel", f"n=2**{args.log2n}, 1 destination",
              fractal_rank_kernel(dest, zero, 1), ref.rank_ref(dest, zero, 1))
        # the engine rule's two sides at 2**16 bins: K2 at the path's n as
        # the pass calls it (the counts given) beside its plain version and
        # the library's stable sort, and K2 and K3 at the most keys K3's
        # table admits (launches here count on no path)
        # digits and counts in, ranks out, the bin starts in
        bytes_at = lambda m: 8 * m + 2 * 4 * (1 << 16)
        n_k3 = min(n, 1 << 25)
        d_k3 = field[:n_k3]
        c_k3 = fractal_histogram(d_k3, 1 << 16)
        s_k3 = exclusive_cumsum(c_k3)
        k2_wide = lambda: fractal_rank_kernel(field, start, 1 << 16, counts=c)
        wide = {"shape": f"n=2**{args.log2n}, 2**16 bins, counts given (the "
                         "distributed pass's local rank)",
                "ms": cuda_ms(k2_wide),
                "plain_ms": cuda_ms(
                    lambda: ref.rank_ref(field, start, 1 << 16), 1, 3),
                "bound_ms": bytes_at(n) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": cuda_ms(
                    lambda: torch.sort(field, stable=True))}
        bare = cuda_ms(lambda: fractal_rank_kernel(field, start, 1 << 16))
        k2_cap = cuda_ms(
            lambda: fractal_rank_kernel(d_k3, s_k3, 1 << 16, counts=c_k3))
        k3_cap = cuda_ms(
            lambda: fractal_rank_scatter_kernel(d_k3, s_k3, 1 << 16))
        log(f"[time] fractal_rank_kernel at {wide['shape']}: "
            f"{wide['ms']:.3f} ms, bound {wide['bound_ms']:.3f} ms, plain "
            f"{wide['plain_ms']:.3f} ms, stable torch.sort "
            f"{wide['library_ms']:.3f} ms, bare (K1 launched for the "
            f"counts) {bare:.3f} ms; at n=2**{n_k3.bit_length() - 1}: "
            f"K2 {k2_cap:.3f} ms, K3 {k3_cap:.3f} ms, bound "
            f"{bytes_at(n_k3) / HBM_BYTES_PER_S * 1e3:.3f} ms; earlier run: "
            f"table walk {TABLE_WALK_MS} ms")
        check_k2_wide(k2_wide, f"n=2**{args.log2n}, 2**16 bins, counts "
                               f"given, on the process group", exact=False)
        del field, c, start, dest, d_k3, c_k3, s_k3

        for p in (32, 16):
            keys = data[p, "uniform"]
            k = keys if p == 16 else u32_to_int64(keys)
            e2e.append({
                "name": f"distributed_fractal_sort p={p} uniform, 1 rank",
                "plan": make_sort_plan(n, p, max_bins_log2=16).describe(),
                "n": n,
                "ms": cuda_ms(lambda: distributed_fractal_sort(keys, None, p),
                              1, 5),
                "fractal_sort_ms": cuda_ms(
                    lambda: fractal_sort(keys, p, device=dev), 1, 5),
                "torch_sort_ms": cuda_ms(lambda: torch.sort(k), 1, 5)})
            log(f"[e2e] {json.dumps(e2e[-1])}")
            del k
        e2e.append({"name": "distributed_fractal_argsort p=32 uniform, "
                            "1 rank", "n": n,
                    "ms": cuda_ms(lambda: distributed_fractal_argsort(
                        uni, None, 32), 1, 5)})
        log(f"[e2e] {json.dumps(e2e[-1])}")
        if args.profile:
            for dist_name, keys in (("uniform", uni), ("zipf", zipf)):
                log(json.dumps({
                    f"profile_distributed_sort_p32_{dist_name}": profile_call(
                        lambda: distributed_fractal_sort(keys, None, 32),
                        top=20), "card": card}))
        del data, uni, zipf, payload, kb
        gc.collect()
        torch.cuda.empty_cache()

        # -- 16. the device store ------------------------------------------------------
        # phase 13's uniform keys and budget, phase 14's lineitem rows
        keys = phase_rng(args.seed, 13).integers(
            0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        limit = 4 * n // 8  # 1/8 of the key bytes: 64 MiB at n = 2**27
        # only the store's own runs count here, not the in-memory checks
        counts = dict.fromkeys(ops.KERNELS, 0)
        rows = S.MemoryBudget(limit).rows(row_cost_bytes(1))  # phase 13's
        cost = S.DeviceShardStore(device=dev).row_cost_bytes(1)
        log(f"[device_store] n = 2**{args.log2n} host keys, budget "
            f"{limit / 2**20:.0f} MiB, source chunks of {rows} rows, "
            f"partitions of at most {S.MemoryBudget(limit).rows(cost)} "
            f"rows (the store's row cost, {cost} bytes)")
        k64 = torch.from_numpy(keys).to(dev).view(torch.int32).long() \
            & 0xFFFFFFFF
        want = torch.sort(k64, stable=True)
        del k64
        for argsort in (False, True):
            budget = S.MemoryBudget(limit)
            store = S.DeviceShardStore(device=dev)
            fn = S.external_argsort if argsort else S.external_sort
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            out = launched(counts, lambda: list(fn(
                S.ArraySource(keys, rows), 32, budget, store=store,
                device=dev)))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            rise = torch.cuda.max_memory_allocated() - base
            name = f"external_{'argsort' if argsort else 'sort'} uniform"
            if argsort:
                got = torch.cat([k.view(torch.int32) for k, _ in out])
                same(f"{name} row ids (DeviceShardStore)",
                     torch.cat([i for _, i in out]).to(dev), want.indices)
            else:
                got = torch.cat([k.view(torch.int32) for k in out])
            same(f"{name} (DeviceShardStore)",
                 got.to(dev).long() & 0xFFFFFFFF, want.values)
            if budget.peak_bytes > budget.limit_bytes:
                raise AssertionError(f"{name}: budget peak "
                                     f"{budget.peak_bytes} > limit {limit}")
            if rise > budget.limit_bytes:
                raise AssertionError(f"{name}: the card's allocations rose "
                                     f"{rise} bytes, over the {limit}-byte "
                                     f"budget")
            parts = len({rid for rid, _ in store.device_log})
            e2e.append({"name": f"{name}, DeviceShardStore (1 rank)", "n": n,
                        "budget_bytes": limit, "wall_ms": wall,
                        "fragments": parts,
                        "budget_peak_bytes": budget.peak_bytes,
                        "device_peak_rise_bytes": rise})
            log(f"[device_store] {name}: bit-exact against torch.sort; "
                f"{json.dumps(e2e[-1])}")
            del out, got
            store.close()
        del want, keys
        _, lineitem = tpch_tables(args.seed, args.query_log2n, dev)
        m = min(lineitem.num_rows, 1 << args.stream_log2n)
        host = Q.Table({c: lineitem.column(c)[:m].cpu()
                        for c in lineitem.column_names}, device="cpu")
        del lineitem
        card_rows = Q.Table({c: host.column(c) for c in host.column_names},
                            device=dev)
        q_limit = sum(host.column(c).nbytes for c in host.column_names) // 8
        ship16 = {"l_shipdate": Q.IntCodec(16)}
        st = S.StreamTable.from_table(host, S.MemoryBudget(q_limit),
                                      device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        got = launched(counts, lambda: Q.order_by(
            st, "l_shipdate", codecs=ship16,
            placement=S.DeviceShardStore(device=dev)).to_table())
        wall = (time.perf_counter() - t1) * 1e3
        rise = torch.cuda.max_memory_allocated() - base
        want = Q.order_by(card_rows, "l_shipdate", codecs=ship16)
        for c in want.column_names:
            same(f"order_by_shipdate_16bit {c} (DeviceShardStore)",
                 got.column(c).to(dev), want.column(c))
        if st.budget.peak_bytes > st.budget.limit_bytes:
            raise AssertionError(f"order_by: budget peak "
                                 f"{st.budget.peak_bytes} > limit {q_limit}")
        if rise > q_limit:
            raise AssertionError(f"order_by: the card's allocations rose "
                                 f"{rise} bytes, over the budget")
        e2e.append({"name": "stream order_by_shipdate_16bit, "
                            "DeviceShardStore (1 rank)", "rows": m,
                    "budget_bytes": q_limit, "wall_ms": wall,
                    "budget_peak_bytes": st.budget.peak_bytes,
                    "device_peak_rise_bytes": rise})
        log(f"[device_store] order_by ship date: bit-exact against the "
            f"in-memory operator; {json.dumps(e2e[-1])}")
        del got, want, host, card_rows
        path_counts["device_store"] = counts
        log(f"[launches] device store path: {json.dumps(counts)}")
        for k in ("fractal_histogram", "fractal_rank_kernel"):
            if counts[k] <= 0:
                raise AssertionError(f"the device store path launched no {k}")
    return e2e, errs, {"fractal_rank_kernel": wide,
                       "fractal_histogram": k1_wide}


# The reference's tune points (benchmarks/bench_sortplan.py TUNE_POINTS):
# the sort points, the wide acceptance point and the query layer's codec
# widths; phase 17 adds n = 2**log2n at p = 32 and 16
TUNE_POINTS = ((1 << 12, 16), (1 << 15, 32), (1 << 17, 32), (1 << 15, 9),
               (1 << 15, 16))


def rank_kernels(delta: dict) -> str:
    """The rank kernels a launch-count delta shows: "K2", "K3" or both."""
    names = [k for k, name in (("K2", "fractal_rank_kernel"),
                               ("K3", "fractal_rank_scatter_kernel"))
             if delta.get(name)]
    return "+".join(names) or "none"


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def tune_phases(args, dev, card: str, path_counts: dict,
                tune_dir: str) -> list:
    """Phase 17: the plan autotuner and the paper's baseline sorts on the
    card.  Sweeps the plan grid at the reference's tune points and at
    n = 2**log2n into a cache in ``tune_dir``, times every grid plan at
    n = 2**log2n, checks that the all-defaults sort, one ORDER BY and one
    external sort resolve through the filled cache, and times the
    baselines beside fractal_sort.  Adds
    ``path_counts["autotune_baselines"]``; returns e2e rows."""
    from repro_torch import query as Q
    from repro_torch import stream as S
    from repro_torch.core import autotune as AT
    from repro_torch.core import (bitonic_sort, bitonic_sort_stats,
                                  comparison_sort_stats, fractal_argsort,
                                  fractal_sort,
                                  fractal_sort_stats, lsd_radix_sort,
                                  make_sort_plan, radix_sort_stats,
                                  torch_sort)
    from repro_torch.core.fractal_tree import u32_to_int64
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    from repro_torch.stream import external as EXT

    counts = {k: 0 for k in ops.KERNELS}

    def launched(fn):
        """``(fn(), its kernel launches)``; the launches add to this
        path's."""
        ops.reset_launch_counts()
        out = fn()
        delta = {k: c for k, c in ops.launch_counts().items() if c}
        for k, c in delta.items():
            counts[k] += c
        return out, delta

    def same(what, got: torch.Tensor, want: torch.Tensor):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from torch.sort")

    t_phase = time.perf_counter()
    hit = metrics.counter("autotune.hit")
    n = 1 << args.log2n
    cache = os.path.join(tune_dir, "tuned.json")

    # -- 17a. the sweep, each point's rank kernel by its launch counts --------
    measured = []  # per measured grid point: its rank kernels
    measure = AT._measure_plan

    def counted_measure(n_meas, p, plan, backend, repeat=AT._MEASURE_REPEAT):
        before = ops.launch_counts()
        wall = measure(n_meas, p, plan, backend, repeat)
        measured.append(rank_kernels(launch_delta(before,
                                                  ops.launch_counts())))
        return wall

    AT._measure_plan = counted_measure
    sweeps = {}
    try:
        for pn, pp in TUNE_POINTS + ((n, 32), (n, 16)):
            measured.clear()
            t0 = time.perf_counter()
            won, _ = launched(lambda: AT.autotune_plan(
                pn, pp, backend="cuda", cache_path=cache))
            entry = AT._load(cache)[AT.cache_key("cuda", pp, None,
                                                 AT.shape_bucket(pn))]
            grid = AT.candidate_grid(pp)
            if len(measured) != len(grid) or len(entry["sweep"]) != len(grid):
                raise AssertionError(f"sweep at n={pn} p={pp} measured "
                                     f"{len(measured)} of {len(grid)} points")
            points = [{"w": s["max_bins_log2"], "engine": s["engine"],
                       "plan": s["plan"], "kernel": k,
                       "us": s["wall_s"] * 1e6}
                      for s, k in zip(entry["sweep"], measured)]
            sweeps[(pn, pp)] = (entry, points)
            log(f"[tune] sweep n={pn} p={pp} (measured at "
                f"n={entry['n_measured']}, {time.perf_counter() - t0:.1f} s): "
                f"winner {won.describe()} w={entry['max_bins_log2']} "
                f"{entry['engine']}; points {json.dumps(points)}")
            # a second call at the point measures nothing
            measured.clear()
            hits = hit.value
            again = AT.autotune_plan(pn, pp, backend="cuda",
                                     cache_path=cache)
            if measured or hit.value != hits + 1 or again != won:
                raise AssertionError(
                    f"a second call at n={pn} p={pp} measured "
                    f"{len(measured)} points, hits +{hit.value - hits}")
    finally:
        AT._measure_plan = measure
    log(f"[tune] a second call at each of {len(sweeps)} points measured "
        f"nothing (autotune.hit +1 each)")

    # -- 17b. every grid plan at n = 2**log2n ---------------------------------
    rng = phase_rng(args.seed, 17)
    u32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    data = {32: torch.from_numpy(u32).to(dev),
            16: torch.from_numpy((u32 >> 16).astype(np.int32)).to(dev)}
    del u32
    want = {p: torch.sort(u32_to_int64(k)).values for p, k in data.items()}
    full = {}
    for p, keys in data.items():
        entry, points = sweeps[(n, p)]
        rows = []
        for pt in points:
            plan = make_sort_plan(n, p, max_bins_log2=pt["w"],
                                  engine=pt["engine"])
            out, delta = launched(lambda: fractal_sort(keys, p, plan=plan))
            same(f"fractal_sort p={p} plan {plan.describe()} {pt['engine']}",
                 u32_to_int64(out), want[p])
            del out
            rows.append({"w": pt["w"], "engine": pt["engine"],
                         "plan": plan.describe(),
                         "kernel_full": rank_kernels(delta),
                         "ms_full": cuda_ms(
                             lambda: fractal_sort(keys, p, plan=plan), 1, 3),
                         "kernel_measured": pt["kernel"],
                         "us_measured": pt["us"]})
        by_ms = sorted(rows, key=lambda r: r["ms_full"])
        rank = 1 + [(r["w"], r["engine"]) for r in by_ms].index(
            (entry["max_bins_log2"], entry["engine"]))
        full[p] = {"rows": rows, "winner_rank": rank,
                   "fastest": f"w={by_ms[0]['w']} {by_ms[0]['engine']}"}
        log(f"[tune] n=2**{args.log2n} p={p}: every grid plan bit-exact; "
            f"the winner at n={entry['n_measured']} (w="
            f"{entry['max_bins_log2']} {entry['engine']}) ranks {rank} of "
            f"{len(rows)} at full size, fastest {full[p]['fastest']}; "
            f"{json.dumps(rows)}")

    # -- 17c. the defaults resolve through the filled cache -------------------
    os.environ[AT.CACHE_ENV] = cache
    keys = data[32]
    entry = sweeps[(n, 32)][0]
    won = make_sort_plan(n, 32, max_bins_log2=entry["max_bins_log2"],
                         engine=entry["engine"])
    hits = hit.value
    out, by_default = launched(lambda: fractal_sort(keys, 32))
    if hit.value != hits + 1:
        raise AssertionError("the all-defaults sort did not hit the cache")
    same("fractal_sort p=32, all defaults", u32_to_int64(out), want[32])
    _, pinned = launched(lambda: fractal_sort(keys, 32, plan=won))
    if by_default != pinned:
        raise AssertionError(f"the all-defaults sort launched {by_default}, "
                             f"the winner's plan {pinned}")
    log(f"[tune] all-defaults fractal_sort p=32: the cached winner "
        f"{won.describe()} ({entry['engine']}), bit-exact, launches "
        f"{json.dumps(by_default)} as the pinned winner's")
    del out
    # ORDER BY a 16-bit code: 2**15 rows resolve at the (2**15, 16) point
    m = 1 << 15
    col = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, m)
                           .astype(np.int32)).to(dev)
    table = Q.Table({"k": col, "row": torch.arange(m, dtype=torch.int32,
                                                   device=dev)}, device=dev)
    hits, consults = hit.value, AT.consult_count()
    got, _ = launched(lambda: Q.order_by(table, "k",
                                         codecs={"k": Q.IntCodec(16)}))
    same("order_by IntCodec(16)", got.column("row").long(),
         torch.argsort(col, stable=True))
    if AT.consult_count() != consults + 1 or hit.value != hits + 1:
        raise AssertionError(
            f"order_by consulted the tuner {AT.consult_count() - consults} "
            f"times with {hit.value - hits} hits; expected one hit")
    log(f"[tune] order_by IntCodec(16) of {m} rows: bit-exact, one tuner "
        f"consult, a hit at the (2**15, 16) point")
    # an external sort consults the tuner once per (length, bits) bucket
    n24 = min(n, 1 << 24)
    host = data[32][:n24].cpu().numpy()
    budget = S.MemoryBudget(4 * n24 // 8)
    asked = []
    resolve = EXT.tuned_plan

    def recording(n_, p_, backend, **kw):
        asked.append((n_, p_, backend))
        return resolve(n_, p_, backend=backend, **kw)

    EXT.tuned_plan = recording
    try:
        consults = AT.consult_count()
        store = S.RunStore()
        try:
            chunks, _ = launched(lambda: list(S.external_sort(
                S.ArraySource(host, budget.rows(EXT.row_cost_bytes(1))), 32,
                budget, store=store, device=dev)))
        finally:
            store.close()
    finally:
        EXT.tuned_plan = resolve
    got = torch.cat([c.view(torch.int32) for c in chunks]).to(dev)
    same("external_sort 2**24", u32_to_int64(got),
         torch.sort(u32_to_int64(data[32][:n24])).values)
    if (not asked or len(set(asked)) != len(asked)
            or AT.consult_count() - consults != len(asked)
            or {b for _, _, b in asked} != {"cuda"}):
        raise AssertionError(f"external_sort consulted the tuner "
                             f"{AT.consult_count() - consults} times over "
                             f"buckets {asked}; expected once a bucket")
    log(f"[tune] external_sort of 2**{n24.bit_length() - 1} host keys: "
        f"bit-exact, {len(chunks)} chunks, one tuner consult for each of "
        f"{len(asked)} buckets {sorted(set(asked))}")
    del chunks, host, got
    # what the consult costs the host: the serve scheduler's call (an
    # all-defaults fractal_argsort of a short queue of 16-bit keys, to the
    # host) against the same call with the plan the consult resolves
    # pinned, in alternating rounds; and the consult alone against the
    # static plan's construction
    queue = torch.from_numpy(rng.integers(0, 1 << 16, 8).astype(np.int32)
                             ).to(dev)
    static_q = make_sort_plan(queue.numel(), 16)
    if AT.tuned_plan(queue.numel(), 16, backend="cuda") != static_q:
        raise AssertionError("the scheduler's sort resolved a cached plan")

    def host_us(fn, calls: int) -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e6

    by_default, pinned = [], []
    for _ in range(5):
        by_default.append(host_us(
            lambda: fractal_argsort(queue, 16).cpu(), 200))
        pinned.append(host_us(
            lambda: fractal_argsort(queue, 16, plan=static_q).cpu(), 200))
    consult_us = host_us(
        lambda: AT.tuned_plan(queue.numel(), 16, backend="cuda"), 10000)
    static_us = host_us(lambda: make_sort_plan(queue.numel(), 16), 10000)
    log(f"[tune] consult cost on the host: all-defaults fractal_argsort of "
        f"{queue.numel()} 16-bit keys to the host "
        f"{statistics.median(by_default):.2f} µs a call, with the plan "
        f"pinned {statistics.median(pinned):.2f} µs (median of 5 rounds "
        f"of 200, alternating); tuned_plan alone {consult_us:.2f} µs, "
        f"make_sort_plan {static_us:.2f} µs (10000 calls each)")

    # -- 17d. the baselines beside fractal_sort -------------------------------
    e2e = []
    for p, keys in data.items():
        static = make_sort_plan(n, p)
        tuned = AT.tuned_plan(n, p, backend="cuda")
        runs = [
            ("lsd_radix_sort radix 8", lambda: lsd_radix_sort(keys, p, 8),
             radix_sort_stats(n, p, 8)),
            ("lsd_radix_sort radix 16", lambda: lsd_radix_sort(keys, p, 16),
             radix_sort_stats(n, p, 16)),
            ("bitonic_sort", lambda: bitonic_sort(keys),
             bitonic_sort_stats(n, p)),
            ("torch_sort", lambda: torch_sort(keys),
             comparison_sort_stats(n, p)),
            (f"fractal_sort static {static.describe()}",
             lambda: fractal_sort(keys, p, plan=static),
             fractal_sort_stats(n, p, plan=static)),
            (f"fractal_sort tuned {tuned.describe()} "
             f"{tuned.passes[-1].engine}", lambda: fractal_sort(keys, p),
             fractal_sort_stats(n, p, plan=tuned)),
        ]
        useful = 2 * n * (4 if p > 16 else 2)
        rows = []
        for name, fn, stats in runs:
            same(f"{name} p={p}", u32_to_int64(launched(fn)[0]), want[p])
            ms = cuda_ms(fn, 1, 3)
            rate = stats.bytes_total / ms
            if name == "torch_sort":
                # comparison_sort_stats charges a merge sort's log2 n
                # passes; torch.sort on the card is a radix sort of a few
                # passes, so that model's bytes over this time are no
                # bandwidth (they exceed the card's memory rate)
                rate = None
            elif rate > HBM_BYTES_PER_S / 1e3:
                raise AssertionError(
                    f"{name} p={p}: the model's bytes move at {rate:.4g} "
                    f"B/ms, over the card's memory rate: the model "
                    f"over-counts what runs")
            rows.append({"name": f"{name} p={p}", "n": n, "ms": ms,
                         "analytic_bytes": stats.bytes_total,
                         "analytic_bytes_per_ms": rate,
                         "useful_bytes_per_ms": useful / ms,
                         "analytic_b_eff": useful / stats.bytes_total})
        fr_static, fr_tuned = rows[-2]["ms"], rows[-1]["ms"]
        for row in rows:
            # effective bandwidth (useful bytes over time) against
            # fractal_sort's: the paper's Fig. 10 measure on this card
            row["eff_bw_vs_fractal_static"] = fr_static / row["ms"]
            row["eff_bw_vs_fractal_tuned"] = fr_tuned / row["ms"]
            log(f"[baseline] bit-exact; {json.dumps(row)}")
        e2e += rows
        del want[p]

    path_counts["autotune_baselines"] = counts
    log(f"[launches] autotune / baselines path (phase 17 in "
        f"{time.perf_counter() - t_phase:.1f} s): {json.dumps(counts)}")
    for k in ops.SORT_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"the autotune / baselines path launched "
                                 f"no {k}")
    e2e.append({"name": "autotune winners",
                "sweeps": {f"n={pn} p={pp}": f"w={e['max_bins_log2']} "
                           f"{e['engine']}"
                           for (pn, pp), (e, _) in sweeps.items()},
                "rank_at_full_size": {f"p={p}": v["winner_rank"]
                                      for p, v in full.items()},
                "fastest_at_full_size": {f"p={p}": v["fastest"]
                                         for p, v in full.items()}})
    return e2e


# phase 18's configuration and shapes
MOE_ARCH = "qwen3-moe-30b-a3b"
# one full-width layer's tokens: C = 320 at capacity 1.25
MOE_LAYER_TOKENS = 4096
# (T, E) of the dispatch checks: one token, a decode step's 4 slots x
# top-8, prefill's 2 x 2048 x 8 assignments, the reference bench's
# shapes (benchmarks/bench_moe_dispatch.py:18), which are also timed, and
# phase 19's jamba shapes at E = 16, top-2: 19a's decode (B = 2) and
# prefill (2 x 32 tokens), 19b's serve step (4 slots) and prefill (2 x
# 2048 tokens), and 20b's smoke qwen3-moe train step (2 x 32 tokens,
# top-2 of 8 experts)
MOE_DISPATCH_SHAPES = ((1, 128), (32, 128), (64, 128), (4096, 128),
                       (32768, 128), (1 << 14, 128), (1 << 16, 128),
                       (1 << 16, 8), (4, 16), (8, 16), (128, 16),
                       (8192, 16), (128, 8))
MOE_BENCH_SHAPES = ((1 << 14, 128), (1 << 16, 128), (1 << 16, 8))
MOE_CHECK_SEQ = 32  # decode against prefill: B = 2 prompts of 32 tokens


def expert_ids(rng: np.random.Generator, n: int, n_experts: int,
               dist: str) -> np.ndarray:
    """(n,) int32 expert ids: uniform, zipf(1.2)-skewed or one expert."""
    if dist == "uniform":
        ids = rng.integers(0, n_experts, n)
    elif dist == "zipf":
        ids = np.minimum(rng.zipf(1.2, n) - 1, n_experts - 1)
    else:
        ids = np.full(n, rng.integers(0, n_experts))
    return ids.astype(np.int32)


def moe_phases(args, dev, card: str, path_counts: dict) -> tuple:
    """Phase 18: the MoE path on the card.  Adds ``path_counts["moe"]``
    (one prefill and one serve of qwen3-moe-30b-a3b); returns (e2e rows,
    K1's and K2's max |err| in this phase, their rows at prefill's
    dispatch shape)."""
    from repro_torch.configs import get_config
    from repro_torch.core.fractal_tree import exclusive_cumsum
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram
    from repro_torch.kernels.fractal_rank import fractal_rank_kernel
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train_lib import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = phase_rng(args.seed, 18)
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    E, k, D, F_ = m.num_experts, m.top_k, cfg.d_model, m.d_ff
    k12 = ("fractal_histogram", "fractal_rank_kernel")
    errs = {name: 0 for name in k12}
    e2e = []

    def k1_k2() -> tuple:
        got = ops.launch_counts()
        return tuple(got[name] for name in k12)

    # -- a. the dispatch against its plain version, bit for bit ---------------
    t0 = time.perf_counter()
    cases = 0
    for (n, n_e), dist in itertools.product(
            MOE_DISPATCH_SHAPES, ("uniform", "zipf", "one_expert")):
        ids = torch.from_numpy(expert_ids(rng, n, n_e, dist)).to(dev)
        ops.reset_launch_counts()
        got = ops.moe_dispatch(ids, n_e)
        if k1_k2() != (1, 1):
            raise AssertionError(f"moe_dispatch T={n} E={n_e} launched K1, "
                                 f"K2 {k1_k2()} times, expected once each")
        want = ref.moe_dispatch_ref(ids, n_e)
        torch.cuda.synchronize()
        for part, g, w, kernel in zip(
                ("perm", "rank", "counts"), got, want,
                ("fractal_rank_kernel", "fractal_rank_kernel",
                 "fractal_histogram")):
            err = max_abs_err(g, w)
            errs[kernel] = max(errs[kernel], err)
            if err or g.dtype != torch.int32:
                raise AssertionError(f"moe_dispatch {part} at T={n} E={n_e} "
                                     f"{dist}: max |err| {err}, {g.dtype}")
        cases += 1
    log(f"[moe] dispatch (K1 + K2) bit-exact against the argsort dispatch "
        f"over {cases} cases ((T, E) in {list(MOE_DISPATCH_SHAPES)} x "
        f"uniform / zipf(1.2) / one expert) in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- b. the zero-router tie case on one full-width layer ------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    layer = M.MoE(cfg, torch.bfloat16, dev)
    layer.init_params(gen)
    n_tok = MOE_LAYER_TOKENS
    x = torch.from_numpy(rng.standard_normal((1, n_tok, D), np.float32)).to(
        dev, torch.bfloat16)
    router = layer.router.clone()
    layer.router.zero_()
    _, ids, w = M.route(layer.router, x.reshape(n_tok, D), k)
    tied_out, tied_aux = M.moe_apply(layer, cfg, x)
    layer.router.copy_(router)
    if not (torch.equal(ids, torch.arange(k, dtype=torch.int32,
                                          device=dev).repeat(n_tok))
            and bool((w == 1.0 / k).all())):
        raise AssertionError("a zero router does not send every token to "
                             "experts 0..k-1 with equal weights")
    # every assignment in experts 0..k-1 at probability 1/E: aux is 1
    if not (bool(torch.isfinite(tied_out).all())
            and abs(tied_aux.item() - 1.0) < 1e-6):
        raise AssertionError(f"zero router: aux {tied_aux.item()}, out "
                             f"finite {bool(torch.isfinite(tied_out).all())}")
    log(f"[moe] zero router: all {n_tok} tokens to experts 0..{k - 1} with "
        f"weight 1/{k}, aux {tied_aux.item()}")
    del tied_out, router

    # -- c. one full-width layer: on K1/K2 against the argsort dispatch -------
    C = max(k, math.ceil(m.capacity_factor * n_tok * k / E))
    ops.reset_launch_counts()
    out, aux = M.moe_apply(layer, cfg, x)
    layer_launches = k1_k2()
    out_ref, aux_ref = M.moe_apply(layer, cfg, x,
                                   dispatch=ref.moe_ranks_ref)
    torch.cuda.synchronize()
    if layer_launches != (1, 1):
        raise AssertionError(f"one MoE layer launched K1, K2 "
                             f"{layer_launches} times, expected once each")
    if not (torch.equal(out, out_ref) and torch.equal(aux, aux_ref)):
        raise AssertionError("the MoE layer on K1/K2 differs from the same "
                             "layer on the argsort dispatch")
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"MoE layer out {tuple(out.shape)} not finite "
                             f"or not of {tuple(x.shape)}")
    expert_bytes = 3 * E * D * F_ * torch.finfo(torch.bfloat16).bits // 8
    flops = 3 * 2 * E * C * D * F_
    byte_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    e2e.append({
        "name": f"moe layer {MOE_ARCH} bf16: T={n_tok}, C={C}",
        "ms": cuda_ms(lambda: M.moe_apply(layer, cfg, x)),
        "argsort_dispatch_ms": cuda_ms(lambda: M.moe_apply(
            layer, cfg, x, dispatch=ref.moe_ranks_ref)),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "expert_bytes": expert_bytes, "flops": flops, "aux": aux.item(),
    })
    log(f"[moe] one layer (D {D}, E {E}, k {k}, F {F_}, bf16, T {n_tok}, "
        f"C {C}): out and aux bit-equal on K1/K2 and on the argsort "
        f"dispatch; {json.dumps(e2e[-1])}")
    if args.profile:
        log(json.dumps({"profile_moe_layer": profile_call(
            lambda: M.moe_apply(layer, cfg, x)), "card": card}))
    del layer, x, out, out_ref, ids, w

    # -- e. decode against prefill: 2 full-width layers, fp32, no drops -------
    t0 = time.perf_counter()
    small = dataclasses.replace(
        cfg, n_layers=2, use_pallas_attention=True,
        moe=dataclasses.replace(m, capacity_factor=float(E)))
    model = T.Transformer(small, device=dev).init_params(gen)
    B, S = 2, MOE_CHECK_SEQ
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)
    ops.reset_launch_counts()
    full = make_prefill_step(small)(model, {"tokens": tokens})
    prefill_launches = k1_k2()
    cache = T.init_cache(small, B, S, model.dtype, dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        dec = [T.decode_step(model, small, cache, tokens[:, t:t + 1], t)[0][:, 0]
               for t in range(S)]
    decode_launches = k1_k2()
    if prefill_launches != (2, 2) or decode_launches != (2 * S, 2 * S):
        raise AssertionError(f"2 MoE layers launched K1, K2 "
                             f"{prefill_launches} times on a prefill and "
                             f"{decode_launches} on {S} decode steps")
    # fp32 through 2 layers, attention and expert sums in another order
    decode_err = check_close("moe decode vs prefill logits",
                             torch.stack(dec, 1), full, 1e-3)
    log(f"[moe] decode vs prefill, 2 layers fp32, capacity {float(E)}: {S} "
        f"steps within 1e-3 (max |err| {decode_err:.3e}); K1, K2 "
        f"{prefill_launches} on the prefill, {decode_launches} on the decode "
        f"({time.perf_counter() - t0:.1f} s)")
    e2e.append({"name": f"moe decode vs prefill {MOE_ARCH} 2 layers fp32",
                "max_abs_err": decode_err})
    del model, cache, full, dec
    gc.collect()
    torch.cuda.empty_cache()

    # -- d. qwen3-moe-30b-a3b at full width and depth, bf16 -------------------
    if args.moe_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.moe_layers)
    t0 = time.perf_counter()
    model = T.Transformer(cfg, device=dev, dtype=torch.bfloat16).init_params(
        gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {D}, {E} experts "
        f"top-{k} of width {F_}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads "
        f"x {cfg.resolved_head_dim}, vocab {cfg.vocab}: "
        f"{n_params / 1e9:.3f} B bf16 parameters (fp32 router) from seed "
        f"{args.seed} in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    n_moe = cfg.n_layers
    # one decode step of 4 slots: one K1 and one K2 launch a layer
    cache = T.init_cache(cfg, 4, 8, model.dtype, dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        step_logits, _ = T.decode_step(model, cfg, cache,
                                       tokens.reshape(4, -1)[:, :1], 0)
    torch.cuda.synchronize()
    if k1_k2() != (n_moe, n_moe):
        raise AssertionError(f"one decode step launched K1, K2 {k1_k2()} "
                             f"times, expected one a layer ({n_moe})")
    if args.profile:
        log(json.dumps({"profile_moe_decode_step": profile_call(
            lambda: T.decode_step(model, cfg, cache,
                                  tokens.reshape(4, -1)[:, :1], 0)),
            "card": card}))
    del cache, step_logits
    B, S = PREFILL_BATCH, PREFILL_SEQ
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S))).to(dev)}
    prefill = make_prefill_step(dataclasses.replace(
        cfg, use_pallas_attention=True))
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    on_prefill = ops.launch_counts()
    if (k1_k2() != (n_moe, n_moe)
            or on_prefill["flash_attention_kernel"] != cfg.n_layers):
        raise AssertionError(f"prefill launched K1, K2 {k1_k2()} and K5 "
                             f"{on_prefill['flash_attention_kernel']} times, "
                             f"expected {n_moe} each")
    if (logits.shape != (B, S, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or not of ({B}, {S}, {cfg.vocab})")
    log(f"[moe] prefill B={B} S={S}: logits {tuple(logits.shape)} finite; "
        f"launches {json.dumps({n: c for n, c in on_prefill.items() if c})}")
    del logits
    requests = make_requests(8, cfg.vocab, rng)
    printed = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        served = serve(model, requests, batch_slots=4, max_len=96)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    path_counts["moe"] = ops.launch_counts()
    for line in printed.getvalue().splitlines():
        log(line)
    steps = int(re.search(r"(\d+) decode steps", printed.getvalue()).group(1))
    unanswered = [r.rid for r in served if len(r.out) != r.max_new
                  or not all(0 <= t < cfg.vocab for t in r.out)]
    if unanswered:
        raise AssertionError(f"requests not answered in full: {unanswered}")
    on_serve = tuple(path_counts["moe"][n] - on_prefill[n] for n in k12)
    if min(on_serve) < n_moe * steps:
        raise AssertionError(f"serve launched K1, K2 {on_serve} times in "
                             f"{steps} decode steps, fewer than one a step "
                             f"in each of {n_moe} MoE layers")
    generated = sum(len(r.out) for r in served)
    fed = sum(len(r.prompt) + len(r.out) - 1 for r in served)
    # a decode step reads every weight but the embedding table (the
    # einsums run every expert, whatever the routing)
    read = sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "embed")
    experts = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters()
                  if re.search(r"ffn\.w[igd]$", name))
    log(f"[moe] serve: {len(served)}/{len(requests)} requests answered in "
        f"{serve_s:.3f} s, {steps} decode steps; K1, K2 {on_serve} launches "
        f"(the scheduler's sorts and {n_moe} a step)")

    # -- f. times ----------------------------------------------------------------
    for n, n_e in MOE_BENCH_SHAPES:
        ids = torch.from_numpy(expert_ids(rng, n, n_e, "uniform")).to(dev)
        e2e.append({
            "name": f"moe_dispatch T={n} E={n_e} uniform",
            "us": cuda_ms(lambda: ops.moe_dispatch(ids, n_e)) * 1e3,
            "argsort_dispatch_us": cuda_ms(
                lambda: ref.moe_dispatch_ref(ids, n_e)) * 1e3,
            # ids read, perm and rank written, counts written
            "bound_us": (12 * n + 4 * n_e) / HBM_BYTES_PER_S * 1e6,
        })
        log(f"[time] {json.dumps(e2e[-1])}")
    # K1 and K2 at prefill's dispatch: 2 x 2048 tokens x top-8 over E
    n = B * S * k
    ids = torch.from_numpy(expert_ids(rng, n, E, "uniform")).to(dev)
    starts = exclusive_cumsum(fractal_histogram(ids, E))
    shape = f"n={n} (prefill's T*k), {E} bins"
    kernel_rows = {
        "fractal_histogram": {
            "moe_shape": shape,
            "moe_ms": cuda_ms(lambda: fractal_histogram(ids, E)),
            "moe_plain_ms": cuda_ms(lambda: ref.histogram_ref(ids, E)),
            "moe_library_ms": cuda_ms(lambda: torch.bincount(ids,
                                                             minlength=E)),
            "moe_bound_ms": (4 * n + 4 * E) / HBM_BYTES_PER_S * 1e3},
        "fractal_rank_kernel": {
            "moe_shape": shape,
            "moe_ms": cuda_ms(lambda: fractal_rank_kernel(ids, starts, E)),
            "moe_plain_ms": cuda_ms(lambda: ref.rank_ref(ids, starts, E)),
            "moe_library_ms": cuda_ms(lambda: torch.sort(ids, stable=True)),
            "moe_bound_ms": (8 * n + 4 * E) / HBM_BYTES_PER_S * 1e3},
    }
    for name, row in kernel_rows.items():
        log(f"[time] {name} at {shape}: {json.dumps(row)}")
    if args.profile:
        log(json.dumps({"profile_moe_prefill": profile_call(
            lambda: prefill(model, batch)), "card": card}))
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    e2e += [{
        "name": f"prefill {MOE_ARCH} B={B} S={S} bf16, K5 attention",
        "layers": cfg.n_layers, "ms": prefill_ms,
        "tokens_per_s": B * S / prefill_ms * 1e3,
    }, {
        "name": f"serve {MOE_ARCH} bf16: 8 requests, 4 slots, max_len 96",
        "layers": cfg.n_layers, "wall_s": serve_s, "decode_steps": steps,
        "ms_a_step": serve_s / steps * 1e3,
        "weight_read_bound_ms_a_step": read / HBM_BYTES_PER_S * 1e3,
        "expert_read_bound_ms_a_step": experts / HBM_BYTES_PER_S * 1e3,
        "generated_tokens": generated, "fed_tokens": fed,
        "generated_tokens_per_s": generated / serve_s,
        "fed_tokens_per_s": fed / serve_s,
    }]
    for row in e2e[-2:]:
        log(f"[e2e] {row}")
    log(f"[launches] moe path (phase 18 in "
        f"{time.perf_counter() - t_phase:.1f} s): "
        f"{json.dumps(path_counts['moe'])}")
    return e2e, errs, kernel_rows


# phase 19's configurations and shapes
HYBRID_ARCH, XLSTM_ARCH = "jamba-v0.1-52b", "xlstm-125m"
AUDIO_ARCH, VLM_ARCH = "whisper-small", "internvl2-76b"
HYBRID_LAYERS = 16  # of jamba's 32: two periods, 52.0 GB of bf16 weights
VLM_LAYERS = 8  # of internvl2's 80: 17.9 GB of bf16 weights
# whisper's n_audio_ctx (the reference's launch/dryrun.py:43) and n_text_ctx
AUDIO_FRAMES, TEXT_CTX = 1500, 448
FAMILY_CHECK_SEQ = 32  # jamba decode against prefill: B = 2 prompts of 32
XLSTM_DECODE_STEPS = 96  # past the first 64-token mLSTM chunk
AUDIO_DECODE_STEPS = 16


def active_params(model) -> int:
    """Parameters a token multiplies by: every weight but the embedding
    table, an MoE layer's (E, D, F) experts at top_k / E."""
    cfg = model.cfg
    n = 0
    for name, p in model.named_parameters():
        if name == "embed" or name.startswith("encoder."):
            continue
        if p.dim() == 3:  # an MoE layer's experts
            n += p.numel() * cfg.moe.top_k // cfg.moe.num_experts
        else:
            n += p.numel()
    return n


def prefill_bound_ms(model, B: int, S: int, prefix: int = 0) -> float:
    """The least time of a bf16 prefill on the card: its products with
    the active weights (2 flops a multiply-add, the unembedding of the S
    text positions) and its causal attention scores and values over the
    tensor cores' dense bf16 peak."""
    cfg = model.cfg
    T_ = B * (S + prefix)
    head = cfg.d_model * cfg.vocab  # in active_params unless tied
    body = active_params(model) - (0 if cfg.tie_embeddings else head)
    lin = 2 * body * T_ + 2 * head * B * S
    n_attn = sum(b.mixer_kind == "attn" for b in model.blocks)
    L_ = S + prefix
    attn = n_attn * 4 * B * cfg.n_heads * cfg.resolved_head_dim * (
        L_ * (L_ + 1) // 2)
    return (lin + attn) / BF16_FLOPS * 1e3


def weight_bytes(model) -> int:
    """What a decode step reads: every weight but the embedding table (the
    einsums run every expert, whatever the routing)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "embed")


def families_phases(args, dev, card: str, path_counts: dict) -> list:
    """Phase 19: the remaining model families on the card.  Adds
    ``path_counts["families"]`` (the main-path runs of 19a-e); returns e2e
    rows."""
    from repro_torch.configs import get_config, list_configs, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    from repro_torch.train_lib import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = phase_rng(args.seed, 19)
    families: dict = {}
    e2e = []
    k125 = ("fractal_histogram", "fractal_rank_kernel",
            "flash_attention_kernel")

    def generator() -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(
            int(rng.integers(1 << 62)))

    def counted(fn):
        """Run ``fn`` on a main path: (its result, this run's launches),
        which add to the families column."""
        ops.reset_launch_counts()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        for name, c in got.items():
            families[name] = families.get(name, 0) + c
        return out, {name: got[name] for name in k125}

    def tokens_of(cfg, B, S):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)

    def randn(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    def built(cfg, dtype, what):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = T.Transformer(cfg, device=dev, dtype=dtype).init_params(
            generator())
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        log(f"[families] {what} {cfg.name}: {cfg.n_layers} layers"
            + (f" (+{cfg.encoder_layers} encoder)" if cfg.encoder_layers
               else "")
            + f", d_model {cfg.d_model}, vocab {cfg.vocab}: {n / 1e9:.3f} B "
            f"{str(dtype)[6:]} parameters ({weight_bytes(model) / 1e9:.2f} "
            f"GB read a decode step) in {time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        return model

    def peak() -> float:
        return torch.cuda.max_memory_allocated() / 2**30

    def served(model, requests, n_moe: int) -> dict:
        """serve() of ``requests`` with 4 slots at max_len 96: every one
        answered in full, K1 and K2 launched (the scheduler's sorts, and
        ``n_moe`` a decode step)."""
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            done, got = counted(lambda: serve(model, requests, batch_slots=4,
                                              max_len=96))
        serve_s = time.perf_counter() - t0
        steps = int(re.search(r"(\d+) decode steps",
                              printed.getvalue()).group(1))
        bad = [r.rid for r in done if len(r.out) != r.max_new
               or not all(0 <= t < model.cfg.vocab for t in r.out)]
        if bad:
            raise AssertionError(f"{model.cfg.name}: requests not answered "
                                 f"in full: {bad}")
        if min(got["fractal_histogram"], got["fractal_rank_kernel"]) < max(
                1, n_moe * steps):
            raise AssertionError(f"{model.cfg.name} serve launched {got} in "
                                 f"{steps} steps with {n_moe} MoE layers")
        log(f"[families] {model.cfg.name} serve: {len(done)}/"
            f"{len(requests)} requests answered in {serve_s:.3f} s, {steps} "
            f"decode steps; launches {json.dumps(got)}")
        return {"wall_s": serve_s, "decode_steps": steps,
                "ms_a_step": serve_s / steps * 1e3,
                "generated_tokens": sum(len(r.out) for r in done)}

    # -- a. jamba, one period at full width, fp32: decode against prefill --
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    E = cfg.moe.num_experts
    n_moe = sum(f == "moe" for _, f in cfg.pattern)
    n_attn = sum(m == "attn" for m, _ in cfg.pattern)
    small = dataclasses.replace(
        cfg, n_layers=len(cfg.pattern), use_pallas_attention=True,
        moe=dataclasses.replace(cfg.moe, capacity_factor=float(E)))
    model = built(small, torch.float32, "19a")
    B, S = 2, FAMILY_CHECK_SEQ
    tokens = tokens_of(cfg, B, S)
    full, on_prefill = counted(lambda: make_prefill_step(small)(
        model, {"tokens": tokens}))
    cache = T.init_cache(small, B, S, model.dtype, dev)
    dec, on_decode = counted(lambda: torch.stack([
        T.decode_step(model, small, cache, tokens[:, t:t + 1], t)[0][:, 0]
        for t in range(S)], 1))
    want = {"fractal_histogram": n_moe, "fractal_rank_kernel": n_moe,
            "flash_attention_kernel": n_attn}
    if on_prefill != want or on_decode != {
            "fractal_histogram": n_moe * S, "fractal_rank_kernel": n_moe * S,
            "flash_attention_kernel": 0}:
        raise AssertionError(f"jamba one period launched {on_prefill} on a "
                             f"prefill (expected {want}) and {on_decode} on "
                             f"{S} decode steps (K1, K2 {n_moe} a step)")
    err = check_close("jamba decode vs prefill logits", dec, full, 1e-3)
    e2e.append({"name": f"19a {HYBRID_ARCH} one period fp32, decode vs "
                        f"prefill, B={B} S={S}",
                "max_abs_err": err, "peak_gib": peak()})
    log(f"[families] 19a jamba {small.n_layers} layers fp32, capacity "
        f"{float(E)}: {S} decode steps within 1e-3 of the prefill (max "
        f"|err| {err:.3e}); launches {on_prefill} on the prefill, "
        f"{on_decode} on the decode; peak {peak():.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, cache, full, dec
    gc.collect()
    torch.cuda.empty_cache()

    # -- b. jamba at full width, bf16, 16 of 32 layers ------------------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=args.hybrid_layers)
    model = built(cfg, torch.bfloat16, "19b")
    n_moe = sum(f == "moe" for _, f in cfg.pattern) * cfg.repeats
    n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.repeats
    B, S = PREFILL_BATCH, PREFILL_SEQ
    batch = {"tokens": tokens_of(cfg, B, S)}
    prefill = make_prefill_step(dataclasses.replace(
        cfg, use_pallas_attention=True))
    logits, on_prefill = counted(lambda: prefill(model, batch))
    want = {"fractal_histogram": n_moe, "fractal_rank_kernel": n_moe,
            "flash_attention_kernel": n_attn}
    if on_prefill != want:
        raise AssertionError(f"jamba prefill launched {on_prefill}, "
                             f"expected {want}")
    if (logits.shape != (B, S, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"jamba logits {tuple(logits.shape)} not "
                             f"finite or not of ({B}, {S}, {cfg.vocab})")
    del logits
    prefill_peak = peak()
    log(f"[families] 19b jamba prefill B={B} S={S}: logits finite; "
        f"launches {on_prefill}; peak {prefill_peak:.2f} GiB")
    serve_row = served(model, make_requests(8, cfg.vocab, rng), n_moe)
    if args.profile:
        log(json.dumps({"profile_jamba_prefill": profile_call(
            lambda: prefill(model, batch)), "card": card}))
        cache = T.init_cache(cfg, 4, 96, model.dtype, dev)
        step_tokens = batch["tokens"][:, :2].reshape(4, 1)
        with torch.inference_mode():
            log(json.dumps({"profile_jamba_decode_step": profile_call(
                lambda: T.decode_step(model, cfg, cache, step_tokens, 0)),
                "card": card}))
        del cache
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    e2e.append({
        "name": f"19b prefill {HYBRID_ARCH} {cfg.n_layers} of 32 layers "
                f"bf16 B={B} S={S}, K5 attention",
        "ms": prefill_ms, "bound_ms": prefill_bound_ms(model, B, S),
        "bound_by": "operations", "active_params": active_params(model),
        "tokens_per_s": B * S / prefill_ms * 1e3, "peak_gib": prefill_peak})
    e2e.append({
        "name": f"19b serve {HYBRID_ARCH} {cfg.n_layers} layers bf16: 8 "
                f"requests, 4 slots, max_len 96",
        **serve_row,
        "weight_read_bound_ms_a_step": weight_bytes(model)
        / HBM_BYTES_PER_S * 1e3, "weight_gb": weight_bytes(model) / 1e9,
        "peak_gib": peak()})
    for row in e2e[-2:]:
        log(f"[e2e] {row}")
    log(f"[families] 19b done in {time.perf_counter() - t0:.1f} s")
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- c. xlstm-125m at full width and depth, fp32 --------------------------
    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    model = built(cfg, torch.float32, "19c")
    B, S = PREFILL_BATCH, PREFILL_SEQ
    batch = {"tokens": tokens_of(cfg, B, S)}
    prefill = make_prefill_step(cfg)
    logits, _ = counted(lambda: prefill(model, batch))
    if (logits.shape != (B, S, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"xlstm logits {tuple(logits.shape)} not "
                             f"finite or not of ({B}, {S}, {cfg.vocab})")
    # the chunked mLSTM against its token loop on layer 0's own input
    with torch.inference_mode():
        block = model.blocks[0]
        h = L.rms_norm(model.embed[batch["tokens"]], block.norm1.scale,
                       cfg.rms_eps)
        chunked = X.mlstm_apply_chunked(block.mixer, cfg, h,
                                        cfg.mlstm_chunk)
        recurrent = X.mlstm_apply_recurrent(block.mixer, cfg, h)
    mlstm_err = check_close("xlstm chunked vs recurrent mLSTM", chunked,
                            recurrent, 2e-4)
    del chunked, recurrent
    steps = XLSTM_DECODE_STEPS
    cache = T.init_cache(cfg, B, steps, model.dtype, dev)
    dec, _ = counted(lambda: torch.stack([
        T.decode_step(model, cfg, cache, batch["tokens"][:, t:t + 1], t)[0][
            :, 0] for t in range(steps)], 1))
    decode_err = check_close("xlstm decode vs prefill logits", dec,
                             logits[:, :steps], 1e-3)
    del logits, dec, cache
    log(f"[families] 19c xlstm prefill B={B} S={S} finite; chunked mLSTM "
        f"(chunk {cfg.mlstm_chunk}) within 2e-4 of its token loop at full "
        f"width (max |err| {mlstm_err:.3e}); {steps} decode steps within "
        f"1e-3 of the prefill (max |err| {decode_err:.3e})")
    serve_row = served(model, make_requests(8, cfg.vocab, rng), 0)
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    slstm = [b for b in model.blocks if b.mixer_kind == "slstm"]
    with torch.inference_mode():
        h = randn((B, S, cfg.d_model))
        slstm_ms = sum(cuda_ms(lambda: X.slstm_apply(b.mixer, cfg, h), 1, 3)
                       for b in slstm)
    e2e.append({
        "name": f"19c prefill {XLSTM_ARCH} fp32 B={B} S={S}",
        "ms": prefill_ms, "tokens_per_s": B * S / prefill_ms * 1e3,
        "slstm_token_loop_ms": slstm_ms, "slstm_layers": len(slstm),
        "slstm_share": slstm_ms / prefill_ms,
        "mlstm_chunked_vs_recurrent_max_abs_err": mlstm_err,
        "decode_vs_prefill_max_abs_err": decode_err, "peak_gib": peak()})
    e2e.append({"name": f"19c serve {XLSTM_ARCH} fp32: 8 requests, 4 slots, "
                        f"max_len 96", **serve_row})
    for row in e2e[-2:]:
        log(f"[e2e] {row}")
    log(f"[families] 19c done in {time.perf_counter() - t0:.1f} s")
    del model, batch, h
    gc.collect()
    torch.cuda.empty_cache()

    # -- d. whisper-small at full width and depth, fp32 ------------------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(AUDIO_ARCH), use_pallas_attention=True)
    model = built(cfg, torch.float32, "19d")
    B = PREFILL_BATCH
    frames = randn((B, AUDIO_FRAMES, cfg.d_model))
    (cross, _), on_encode = counted(
        lambda: T.encode_cross_kv(model, cfg, frames))
    if on_encode["flash_attention_kernel"] != cfg.encoder_layers:
        raise AssertionError(f"whisper's encoder launched K5 "
                             f"{on_encode['flash_attention_kernel']} times, "
                             f"expected {cfg.encoder_layers}")
    batch = {"tokens": tokens_of(cfg, B, TEXT_CTX), "frontend": frames}
    prefill = make_prefill_step(cfg)
    logits, on_prefill = counted(lambda: prefill(model, batch))
    k5 = cfg.encoder_layers + 2 * cfg.n_layers  # encoder, self, cross
    if on_prefill["flash_attention_kernel"] != k5:
        raise AssertionError(f"whisper's prefill launched K5 "
                             f"{on_prefill['flash_attention_kernel']} times, "
                             f"expected {k5}")
    with torch.inference_mode():
        plain = make_prefill_step(dataclasses.replace(
            cfg, use_pallas_attention=False))(model, batch)
    prefill_err = check_close("whisper prefill, K5 vs plain attention",
                              logits, plain, 1e-3)
    del plain
    steps = AUDIO_DECODE_STEPS
    cache = T.init_cache(cfg, B, steps, model.dtype, dev)
    dec, _ = counted(lambda: torch.stack([
        T.decode_step(model, cfg, cache, batch["tokens"][:, t:t + 1], t,
                      cross_kv=cross)[0][:, 0] for t in range(steps)], 1))
    decode_err = check_close("whisper decode (encode_cross_kv) vs prefill",
                             dec, logits[:, :steps], 1e-3)
    del logits, dec, cache
    encode_ms = cuda_ms(lambda: T.encode_cross_kv(model, cfg, frames), 1, 3)
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    e2e.append({
        "name": f"19d {AUDIO_ARCH} fp32: encoder over B={B} x "
                f"{AUDIO_FRAMES} frames, prefill {TEXT_CTX} tokens, K5",
        "encode_ms": encode_ms, "prefill_ms": prefill_ms,
        "k5_launches_encode": on_encode["flash_attention_kernel"],
        "k5_launches_prefill": on_prefill["flash_attention_kernel"],
        "prefill_vs_plain_max_abs_err": prefill_err,
        "decode_vs_prefill_max_abs_err": decode_err, "peak_gib": peak()})
    log(f"[e2e] {e2e[-1]}")
    log(f"[families] 19d whisper: encoder {cfg.encoder_layers} K5 launches "
        f"at ({B}, {AUDIO_FRAMES}, {cfg.n_heads}, {cfg.resolved_head_dim}) "
        f"non-causal; prefill {k5} (self {TEXT_CTX} causal, cross "
        f"{TEXT_CTX} x {AUDIO_FRAMES}) within 1e-3 of plain attention; "
        f"{steps} decode steps with encode_cross_kv within 1e-3 "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, batch, cross, frames
    gc.collect()
    torch.cuda.empty_cache()

    # -- e. internvl2-76b at full width, bf16, 8 of 80 layers -----------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS,
                              use_pallas_attention=True)
    model = built(cfg, torch.bfloat16, "19e")
    B, S, P = PREFILL_BATCH, PREFILL_SEQ, cfg.num_patches
    batch = {"tokens": tokens_of(cfg, B, S),
             "frontend": randn((B, P, cfg.d_model), torch.bfloat16)}
    prefill = make_prefill_step(cfg)
    logits, on_prefill = counted(lambda: prefill(model, batch))
    if on_prefill["flash_attention_kernel"] != cfg.n_layers:
        raise AssertionError(f"internvl2 prefill launched {on_prefill}, "
                             f"expected K5 {cfg.n_layers} times")
    if (logits.shape != (B, S, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"internvl2 logits {tuple(logits.shape)} not "
                             f"finite or not of ({B}, {S}, {cfg.vocab})")
    del logits
    prefill_ms = cuda_ms(lambda: prefill(model, batch), 1, 3)
    e2e.append({
        "name": f"19e prefill {VLM_ARCH} {cfg.n_layers} of 80 layers bf16 "
                f"B={B}, {P} patches + {S} tokens, K5 attention",
        "ms": prefill_ms, "bound_ms": prefill_bound_ms(model, B, S, P),
        "bound_by": "operations", "peak_gib": peak()})
    log(f"[e2e] {e2e[-1]}")
    log(f"[families] 19e internvl2: logits ({B}, {S}, {cfg.vocab}) finite, "
        f"{on_prefill['flash_attention_kernel']} K5 launches "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    path_counts["families"] = families

    # -- f. every registered config at smoke size -------------------------------
    t0 = time.perf_counter()
    for name in list_configs():
        cfg = dataclasses.replace(smoke_config(get_config(name)),
                                  use_pallas_attention=True)
        model = T.Transformer(cfg, device=dev).init_params(generator())
        B, S = 2, 32
        tokens = tokens_of(cfg, B, S)
        n_fe = {"audio": 16, "patch": cfg.num_patches}.get(cfg.frontend)
        fe = None if n_fe is None else randn((B, n_fe, cfg.d_model))
        with torch.inference_mode():
            logits = make_prefill_step(cfg)(model, {"tokens": tokens,
                                                    "frontend": fe})
            cross = (T.encode_cross_kv(model, cfg, fe)[0]
                     if cfg.encoder_layers else None)
            cache = T.init_cache(cfg, B, S, model.dtype, dev)
            step, _ = T.decode_step(model, cfg, cache, tokens[:, :1], 0,
                                    cross_kv=cross)
        torch.cuda.synchronize()
        for what, t, shape in (("prefill", logits, (B, S, cfg.vocab)),
                               ("decode", step, (B, 1, cfg.vocab))):
            if t.shape != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{cfg.name} {what} logits "
                                     f"{tuple(t.shape)} not finite or not of "
                                     f"{shape}")
        del model, logits, cache, step, cross
    log(f"[families] 19f every config at smoke size ({len(list_configs())}: "
        f"{', '.join(list_configs())}): one prefill with K5 on and one "
        f"decode step on the card, finite ({time.perf_counter() - t0:.1f} s)")
    log(f"[launches] families path (phase 19 in "
        f"{time.perf_counter() - t_phase:.1f} s): {json.dumps(families)}")
    return e2e


TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6  # 20a: 8,192 tokens a step
TRAIN_MOE_LAYERS = 2  # of qwen3-moe's 48 in 20c: 1.87 B parameters
TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 2, 3
TRAIN_SMOKE_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "xlstm-125m")
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5  # 20b: the card against the CPU
LENGTHS_LOG2N = 24  # 20d


def step_agrees(what: str, ref, got, oc, lr: float,
                cap_tiny: bool = True) -> tuple:
    """20b's gate on one AdamW step from the same weights and batch, given
    each side's ``(parameters by name, weights before, opt state)``
    (``ref``: the CPU's, or the unsharded step's; ``got``: the card's, or
    the sharded step's; compared on ``got``'s device): ``got``'s clipped
    gradients (``mu / (1 - b1)``) within (TRAIN_RTOL, TRAIN_ATOL) of
    ``ref``'s; every parameter moved by more than lr / 2 somewhere; the
    updated parameters within the same tolerance, except where a side's
    gradient lies in (0, 10 eps): there the step divides it by about eps,
    so fp32 noise moves the parameter by a good part of lr, and those
    elements (at most 1 % of all) are held within 2 lr.  Without
    ``cap_tiny`` the 1 % bounds the elements that use the exception
    (differ past the tolerance) rather than every element whose gradient
    lies in (0, 10 eps): a full-width step has 3-6 % of those (phase 21),
    a fact of its gradients, not a disagreement.  Returns (worst gradient excess, worst
    parameter excess, elements whose gradient lies in (0, 10 eps),
    elements, elements held within 2 lr past the tolerance)."""
    (p_ref, before, o_ref), (p_got, _, o_got) = ref, got
    worst_g = worst_p = 0.0
    n_loose = n_all = n_excepted = 0
    for name, p in p_ref.items():
        q = p_got[name].detach()
        dev = q.device
        g, h = (o["mu"][name].detach().to(dev) / (1 - oc.b1)
                for o in (o_ref, o_got))
        excess = ((h - g).abs() - TRAIN_RTOL * g.abs()).max().item()
        worst_g = max(worst_g, excess)
        if excess > TRAIN_ATOL:
            raise AssertionError(f"{what}: the gradient of {name} differs "
                                 f"by {excess} past rtol {TRAIN_RTOL}")
        p = p.detach().to(dev)
        if not (q - before[name].to(dev)).abs().max().item() > lr / 2:
            raise AssertionError(f"{what}: {name} did not move (lr {lr})")
        loose = ((torch.minimum(g.abs(), h.abs()) < 10 * oc.eps)
                 & ((g != 0) | (h != 0)))
        diff = (q - p).abs()
        excess = torch.where(loose, 0, diff - TRAIN_RTOL * p.abs()).max()
        worst_p = max(worst_p, excess.item())
        if excess.item() > TRAIN_ATOL or torch.where(
                loose, diff, 0).max().item() > 2 * lr + TRAIN_ATOL:
            raise AssertionError(f"{what}: {name} after one step differs "
                                 f"by {excess.item()} past rtol "
                                 f"{TRAIN_RTOL}")
        n_loose += int(loose.sum())
        n_excepted += int((loose & (diff > TRAIN_RTOL * p.abs()
                                    + TRAIN_ATOL)).sum())
        n_all += p.numel()
        del g, h, p, q, loose, diff
    if (n_loose if cap_tiny else n_excepted) > n_all // 100:
        raise AssertionError(f"{what}: {n_loose} of {n_all} gradients "
                             f"within 10 eps of 0, {n_excepted} past the "
                             f"tolerance")
    return worst_g, worst_p, n_loose, n_all, n_excepted


def train_phases(args, dev, card: str, path_counts: dict) -> list:
    """Phase 20: the train path on the card.  Adds ``path_counts["train"]``
    (20a-d's runs); returns e2e rows."""
    import copy
    import functools

    from repro_torch import checkpoint as CK
    from repro_torch import optim as O
    from repro_torch import train_lib as TL
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import (DataConfig, Prefetcher, SyntheticLM,
                                  length_bucketed_order, put_batch)
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = phase_rng(args.seed, 20)
    e2e = []
    k12 = ("fractal_histogram", "fractal_rank_kernel")
    ops.reset_launch_counts()

    def generator(device=dev) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            int(rng.integers(1 << 62)))

    def source(cfg, B: int, S: int) -> SyntheticLM:
        return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B,
                                      seed=int(rng.integers(1 << 31))),
                           device="cpu")

    def peak() -> float:
        return torch.cuda.max_memory_allocated() / 2**30

    def trained(model, cfg, oc, data, steps: int, what: str) -> tuple:
        """``steps`` train steps; fatal unless every loss, aux loss and
        grad norm is finite.  Returns (losses, grad norms and ms a step;
        a function that runs step ``s``)."""
        state = {"opt": O.init_opt_state(model.named_parameters(), oc)}
        step = TL.make_train_step(cfg, oc)

        def one(s: int) -> dict:
            state["opt"], met = step(model, state["opt"], data.get(s))
            return met

        out = {"loss": [], "aux_loss": [], "grad_norm": [], "ms": []}
        for s in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = one(s)
            vals = {k: float(met[k]) for k in ("loss", "aux_loss",
                                               "grad_norm")}
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            for k, v in vals.items():
                out[k].append(v)
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"20{what} step {s}: {vals}")
        return out, one

    def mfu(n_params: int, tokens: int, ms: float) -> float:
        """Model FLOPs (6 N a token) over the step's time at the card's
        fp32 peak outside the tensor cores (TF32 stays off)."""
        return 6 * n_params * tokens / (ms / 1e3 * FP32_FMA_FLOPS)

    # -- a. llama3.2-1b at full width and depth, fp32 -----------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    model = T.Transformer(cfg, device=dev).init_params(generator())
    n_params = sum(p.numel() for p in model.parameters())
    oc = O.OptimizerConfig(warmup_steps=10, total_steps=100)
    data = Prefetcher(source(cfg, TRAIN_BATCH, TRAIN_SEQ),
                      functools.partial(put_batch, device=dev))
    run, one = trained(model, cfg, oc, data, TRAIN_STEPS, "a")
    if abs(run["loss"][0] - math.log(cfg.vocab)) > 1.0:
        raise AssertionError(f"20a step 0 loss {run['loss'][0]:.4f}, not "
                             f"within 1.0 of ln({cfg.vocab}) = "
                             f"{math.log(cfg.vocab):.4f}")
    warm = statistics.median(run["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = {"name": f"train {TRAIN_ARCH} fp32", "params": n_params,
           "state_gb": 16 * n_params / 1e9, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat, "step_ms": run["ms"],
           "warm_step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
           "mfu_6nd_fp32": mfu(n_params, tokens, warm),
           "bound_6nd_ms": 6 * n_params * tokens / FP32_FMA_FLOPS * 1e3,
           "loss": run["loss"], "grad_norm": run["grad_norm"],
           "peak_gib": peak(), "card": card}
    e2e.append(row)
    log(f"[train] 20a {TRAIN_ARCH}: {n_params / 1e9:.3f} B fp32 parameters "
        f"({row['state_gb']:.1f} GB with grads and moments), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat {cfg.remat}: losses "
        f"{[round(v, 4) for v in run['loss']]} (step 0 vs ln V "
        f"{math.log(cfg.vocab):.4f}), grad norms "
        f"{[round(v, 4) for v in run['grad_norm']]}; ms a step "
        f"{[round(v, 1) for v in run['ms']]}, warm median {warm:.1f} ms, "
        f"{row['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
        f"{row['mfu_6nd_fp32']:.4f} of {FP32_FMA_FLOPS / 1e12:.0f} TFLOP/s "
        f"fp32 (6ND bound {row['bound_6nd_ms']:.1f} ms); peak "
        f"{row['peak_gib']:.2f} GiB; {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    if args.profile:  # device time of one warm step by kernel
        log(json.dumps({"profile_train_step": profile_call(
            lambda: one(TRAIN_STEPS), top=25), "card": card}))
    del model, data, one
    gc.collect()
    torch.cuda.empty_cache()

    # -- b. the card against the CPU at smoke size ----------------------------
    t0 = time.perf_counter()
    # no warmup: the first step's lr is 3e-4, so each parameter moves by
    # about that, far above the gate's atol
    oc = O.OptimizerConfig(warmup_steps=0)
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = smoke_config(get_config(arch))
        on_cpu = T.Transformer(cfg, device="cpu").init_params(
            generator("cpu"))
        before = {k: p.detach().clone() for k, p in on_cpu.named_parameters()}
        on_card = copy.deepcopy(on_cpu).to(dev)
        batch = source(cfg, 2, 32).batch(0)
        sides, losses = [], []
        for model in (on_cpu, on_card):
            opt = O.init_opt_state(model.named_parameters(), oc)
            opt, met = TL.make_train_step(cfg, oc)(
                model, opt, put_batch(batch, model.device))
            sides.append((dict(model.named_parameters()), before, opt))
            losses.append(float(met["loss"]))
        lr = float(met["lr"])
        l_cpu, l_card = losses
        if abs(l_card - l_cpu) > TRAIN_ATOL + TRAIN_RTOL * abs(l_cpu):
            raise AssertionError(f"20b {arch}: loss {l_card} on the card, "
                                 f"{l_cpu} on the CPU")
        worst_g, worst_p, n_loose, n_all, _ = step_agrees(
            f"20b {arch}", *sides, oc, lr)
        log(f"[train] 20b {cfg.name}: loss card {l_card:.6f} cpu "
            f"{l_cpu:.6f}; clipped gradients within rtol {TRAIN_RTOL} + "
            f"{worst_g:.3g}, updated parameters (lr {lr:.3g}) within rtol "
            f"{TRAIN_RTOL} + {worst_p:.3g} (gate atol {TRAIN_ATOL}) but "
            f"{n_loose} of {n_all} elements whose gradient is within 10 eps "
            f"of 0 (held within 2 lr)")
    # the checkpoint of the card's state restores on the CPU, and back
    state = {"params": dict(on_card.named_parameters()), "opt": opt}
    with tempfile.TemporaryDirectory() as ck:
        CK.save(ck, 1, state)
        host = CK.restore(ck, 1, state, device="cpu")
        back = CK.restore(ck, 1, host, device=dev)
    for (name, a), (_, h), (_, b) in zip(CK.flatten(state), CK.flatten(host),
                                         CK.flatten(back)):
        if h.device.type != "cpu" or b.device != a.device or not (
                torch.equal(h, a.detach().cpu()) and torch.equal(b, a)):
            raise AssertionError(f"20b checkpoint: {name} did not survive "
                                 f"the card -> CPU -> card round trip")
    # K5 refuses to run under grad on the card, as on the CPU
    q = torch.zeros((1, 8, 2, 16), device=dev, requires_grad=True)
    try:
        flash_attention_kernel(q, q, q)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("20b: K5 ran on inputs that require grad")
    log(f"[train] 20b checkpoint card -> CPU -> card bit-exact over "
        f"{len(CK.flatten(state))} leaves; K5 refuses inputs that require "
        f"grad ({time.perf_counter() - t0:.1f} s)")
    del on_cpu, on_card, state, host, back, q

    # -- c. qwen3-moe-30b-a3b at full width, 2 layers, fp32 ---------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=args.train_moe_layers)
    model = T.Transformer(cfg, device=dev).init_params(generator())
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_params(model)
    data = Prefetcher(source(cfg, TRAIN_MOE_BATCH, TRAIN_SEQ),
                      functools.partial(put_batch, device=dev))
    before = ops.launch_counts()
    run, _ = trained(model, cfg, O.OptimizerConfig(warmup_steps=10,
                                                   total_steps=100),
                     data, TRAIN_MOE_STEPS, "c")
    got = launch_delta(before, ops.launch_counts())
    if min(got.get(k, 0) for k in k12) <= 0:
        raise AssertionError(f"20c launched {got}: K1 and K2 must launch")
    warm = statistics.median(run["ms"][1:])
    tokens = TRAIN_MOE_BATCH * TRAIN_SEQ
    row = {"name": f"train {MOE_ARCH} {cfg.n_layers} layers fp32",
           "params": n_params, "active_params": n_active,
           "state_gb": 16 * n_params / 1e9, "batch": TRAIN_MOE_BATCH,
           "seq": TRAIN_SEQ, "step_ms": run["ms"], "warm_step_ms": warm,
           "tokens_per_s": tokens / warm * 1e3,
           "mfu_6nd_fp32_active": mfu(n_active, tokens, warm),
           "loss": run["loss"], "aux_loss": run["aux_loss"],
           "launches": got, "peak_gib": peak(), "card": card}
    e2e.append(row)
    log(f"[train] 20c {MOE_ARCH}, {cfg.n_layers} layers: "
        f"{n_params / 1e9:.3f} B fp32 parameters ({n_active / 1e9:.3f} B "
        f"active), batch {TRAIN_MOE_BATCH} x {TRAIN_SEQ}: losses "
        f"{[round(v, 4) for v in run['loss']]}, aux "
        f"{[round(v, 4) for v in run['aux_loss']]}; ms a step "
        f"{[round(v, 1) for v in run['ms']]}, warm median {warm:.1f} ms, "
        f"{row['tokens_per_s']:.0f} tokens/s, model-FLOPs share (active) "
        f"{row['mfu_6nd_fp32_active']:.4f}; launches {json.dumps(got)}; "
        f"peak {row['peak_gib']:.2f} GiB; {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, data
    gc.collect()
    torch.cuda.empty_cache()

    # -- d. length-bucketed order of 2**24 lengths ----------------------------
    t0 = time.perf_counter()
    n = 1 << LENGTHS_LOG2N
    lengths = torch.from_numpy(rng.integers(0, 1 << 17, n).astype(
        np.int32)).to(dev)
    before = ops.launch_counts()
    perm = length_bucketed_order(lengths, device=dev)
    torch.cuda.synchronize()
    got = launch_delta(before, ops.launch_counts())
    want = torch.argsort(torch.clamp(lengths, 0, (1 << 16) - 1), stable=True)
    if not torch.equal(perm.long(), want):
        raise AssertionError("20d: length_bucketed_order differs from the "
                             "stable argsort of the clipped lengths")
    if min(got.get(k, 0) for k in k12) <= 0:
        raise AssertionError(f"20d launched {got}: K1 and K2 must launch")
    train_counts = ops.launch_counts()
    path_counts["train"] = train_counts
    ms = cuda_ms(lambda: length_bucketed_order(lengths, device=dev))
    argsort_ms = cuda_ms(lambda: torch.argsort(
        torch.clamp(lengths, 0, (1 << 16) - 1), stable=True))
    e2e.append({"name": "length_bucketed_order", "n": n, "ms": ms,
                "torch_argsort_ms": argsort_ms, "launches": got})
    log(f"[train] 20d length_bucketed_order of 2**{LENGTHS_LOG2N} lengths "
        f"in [0, 2**17), clipped to 16 bits: bit-exact against a stable "
        f"torch.argsort; launches {json.dumps(got)} (K4 "
        f"{'ran' if got.get('fractal_reconstruct') else 'did not run'}: "
        f"argsort carries the permutation through LSD passes only); "
        f"{ms:.3f} ms, torch.argsort {argsort_ms:.3f} ms "
        f"({time.perf_counter() - t0:.1f} s)")
    del lengths, perm, want

    # -- e. the training driver: induced failure, restart, journal -----------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_ARCH, "--smoke", "--steps", "25", "--global-batch", "4",
             "--seq-len", "32", "--ckpt-dir", ck, "--ckpt-every", "10",
             "--induce-failure", "15"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if res.returncode != 0:
            raise AssertionError(f"20e: the training driver exited "
                                 f"{res.returncode}:\n{res.stdout}\n"
                                 f"{res.stderr[-4000:]}")
        with open(os.path.join(ck, "journal.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f]
    for line in ("[train] step 15 failed: induced failure at step 15; "
                 "restoring", "[train] restarted from step 10",
                 "[train] done; straggler count:"):
        if line not in res.stdout:
            raise AssertionError(f"20e: no {line!r} in\n{res.stdout}")
    if steps.count(12) != 2 or max(steps) != 24:
        raise AssertionError(f"20e: journal steps {steps}")
    log(f"[train] 20e python -m repro_torch.launch.train on the card: step "
        f"12 replayed twice, journal ends at step 24 "
        f"({time.perf_counter() - t0:.1f} s, the child's start included)")

    # -- f. the int8-compressed DDP step on a one-rank NCCL group -------------
    t0 = time.perf_counter()
    cfg = smoke_config(get_config(TRAIN_ARCH))
    model = T.Transformer(cfg, device=dev).init_params(generator())
    batch = source(cfg, 2, 32).batch(0)
    batch = put_batch(batch, dev)
    oc = O.OptimizerConfig()
    with one_rank_group(dev):
        err = TL.init_error_feedback(model)
        with TL.full_precision():
            (_, (loss, _)), grads = TL.value_and_grad(model, cfg, batch)
        for name, g in grads.items():
            got, new_err = O.compressed_psum(g, None, err[name])
            g32 = g.float() + err[name]
            scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
            deq = torch.clamp(torch.round(g32 / scale), -127, 127).to(
                torch.int8).float() * scale
            if not (torch.equal(got, deq) and torch.equal(new_err,
                                                          g32 - deq)):
                raise AssertionError(f"20f: {name}'s reduced gradient is not "
                                     f"its int8 dequantization")
        opt = O.init_opt_state(model.named_parameters(), oc)
        opt, err, met = TL.make_compressed_ddp_step(cfg, oc)(
            model, opt, err, batch)
        step_loss = float(met["loss"])
    if not (math.isfinite(step_loss) and math.isfinite(
            float(met["grad_norm"]))) or abs(step_loss - float(loss)) > (
            TRAIN_ATOL + TRAIN_RTOL * abs(float(loss))):
        raise AssertionError(f"20f: step loss {step_loss}, plain "
                             f"{float(loss)}, metrics {met}")
    log(f"[train] 20f make_compressed_ddp_step on a one-rank NCCL group: "
        f"{len(grads)} reduced gradients equal their int8 dequantization; "
        f"step loss {step_loss:.6f} ({time.perf_counter() - t0:.1f} s)")
    del model, grads, opt, err

    log(f"[launches] train path (20a-d): "
        f"{json.dumps({k: c for k, c in train_counts.items() if c})}")
    phase_peak = max([peak()] + [r["peak_gib"] for r in e2e
                                 if "peak_gib" in r])
    log(f"[train] phase 20 in {time.perf_counter() - t_phase:.1f} s, peak "
        f"{phase_peak:.2f} GiB")
    return e2e


SHARD_STEPS = 3  # 21a: one step held to the unsharded one, two more timed
SHARD_DECODE_STEPS, SHARD_DECODE_LEN = 16, 256  # 21c: B = 2
PIPE_M, PIPE_MB, PIPE_SEQ = 4, 2, 256  # 21d: microbatches of (2, 256, D)
SHARD_STUB = {"data": 16, "model": 16}  # 21e: the production mesh's sizes


def timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3

def peak() -> float:
    return torch.cuda.max_memory_allocated() / 2**30

def held_to_unsharded(cfg, B: int, S: int, steps: int, what: str, mesh,
                      rng, dev, counts: dict) -> dict:
    """One ``make_train_step`` step, kept on the host, then
    ``shard_train_step`` from the same weights and batch, held to it by
    ``step_agrees`` (20b's gate; the 1 % cap on the elements that use
    its exception); ``steps - 1`` more sharded steps, timed.  The
    sharded steps' launches are added to ``counts``."""
    from repro_torch import optim as O
    from repro_torch import train_lib as TL
    from repro_torch.data import DataConfig, SyntheticLM, put_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    oc = O.OptimizerConfig(warmup_steps=0)  # lr 3e-4 from the first step
    seed = int(rng.integers(1 << 62))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B,
                                  seed=int(rng.integers(1 << 31))),
                       device="cpu")
    batches = [put_batch(data.batch(s), dev) for s in range(steps)]

    def fresh():
        return T.Transformer(cfg, device=dev).init_params(
            torch.Generator(device=dev).manual_seed(seed))

    torch.cuda.reset_peak_memory_stats()
    model = fresh()
    before = {k: p.detach().to("cpu", copy=True)
              for k, p in model.named_parameters()}
    opt = O.init_opt_state(model.named_parameters(), oc)
    (opt, met), plain_ms = timed(lambda: TL.make_train_step(cfg, oc)(
        model, opt, batches[0]))
    ref = ({k: p.detach().cpu() for k, p in model.named_parameters()},
           before, {"mu": {k: v.cpu() for k, v in opt["mu"].items()}})
    plain = {"loss": float(met["loss"]), "ms": plain_ms,
             "peak_gib": peak(), "lr": float(met["lr"])}
    del model, opt, met
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = fresh()
    TL.shard_model(model, cfg, mesh)
    opt = O.init_opt_state(model.named_parameters(), oc)
    step = TL.shard_train_step(cfg, oc, mesh)
    ms, losses = [], []
    ops.reset_launch_counts()  # the comparison between launches none
    (opt, met), t = timed(lambda: step(model, opt, batches[0]))
    ms.append(t)
    losses.append(float(met["loss"]))
    step_peak = peak()
    if abs(losses[0] - plain["loss"]) > (TRAIN_ATOL + TRAIN_RTOL
                                         * abs(plain["loss"])):
        raise AssertionError(f"{what}: sharded loss {losses[0]}, "
                             f"unsharded {plain['loss']}")
    full = TL.gather_state(model, opt, mesh)
    worst_g, worst_p, n_tiny, n_all, n_excepted = step_agrees(
        what, ref, (full["params"], None, full["opt"]), oc, plain["lr"],
        cap_tiny=False)
    del full, ref, before
    gc.collect()
    torch.cuda.empty_cache()
    for s in range(1, steps):
        (opt, met), t = timed(lambda: step(model, opt, batches[s]))
        ms.append(t)
        losses.append(float(met["loss"]))
    got_counts = ops.launch_counts()
    for k, c in got_counts.items():
        counts[k] = counts.get(k, 0) + c
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    del model, opt, met, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"plain": plain, "ms": ms, "losses": losses,
            "peak_gib": max(step_peak, peak()),
            "worst_grad_excess": worst_g, "worst_param_excess": worst_p,
            "elements": n_all, "tiny_gradients": n_tiny,
            "excepted": n_excepted,
            "launches": {k: c for k, c in got_counts.items() if c}}


def sharding_phases(args, dev, card: str, path_counts: dict,
                    train_row: dict = None) -> list:
    """Phase 21: the LM's sharding on a (1, 1) mesh over a one-rank NCCL
    group.  Adds ``path_counts["sharding"]`` (the sharded train steps of
    21a-b); returns e2e rows.  ``train_row``: 20a's, logged beside 21a."""
    import functools

    from repro_torch import sharding as SH
    from repro_torch.configs import get_config, list_configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import act_sharding as AS
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.pipeline import gpipe_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = phase_rng(args.seed, 21)
    e2e = []
    k12 = ("fractal_histogram", "fractal_rank_kernel")
    sharding = {}

    if dev.type == "cuda":  # the mesh's communicator takes this device
        torch.cuda.set_device(torch.cuda.current_device())
    with one_rank_group(dev):
        mesh = make_host_mesh(1, 1, device=dev)
        log(f"[shard] one-rank {torch.distributed.get_backend()} group, "
            f"mesh {dict(SH.axis_sizes(mesh))}; {card}")

        # -- a. llama3.2-1b at full width and depth, fp32 ---------------------
        t0 = time.perf_counter()
        cfg = get_config(TRAIN_ARCH)
        run = held_to_unsharded(cfg, TRAIN_BATCH, TRAIN_SEQ, SHARD_STEPS,
                                "21a", mesh, rng, dev, sharding)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        warm = statistics.median(run["ms"][1:])
        row = {"name": f"shard_train_step {TRAIN_ARCH} fp32 (1, 1) mesh",
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
               "step_ms": run["ms"], "warm_step_ms": warm,
               "tokens_per_s": tokens / warm * 1e3,
               "unsharded_step0_ms": run["plain"]["ms"],
               "unsharded_peak_gib": run["plain"]["peak_gib"], **{
                   k: run[k] for k in ("losses", "peak_gib",
                                       "worst_grad_excess",
                                       "worst_param_excess", "elements",
                                       "tiny_gradients", "excepted")},
               "card": card}
        e2e.append(row)
        log(f"[shard] 21a {TRAIN_ARCH} fp32, batch {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, remat {cfg.remat}, shard_train_step on the (1, 1) "
            f"mesh: loss {run['losses'][0]:.6f} (unsharded "
            f"{run['plain']['loss']:.6f}); clipped gradients within rtol "
            f"{TRAIN_RTOL} + {run['worst_grad_excess']:.3g}, updated "
            f"parameters within rtol {TRAIN_RTOL} + "
            f"{run['worst_param_excess']:.3g} (gate atol {TRAIN_ATOL}) but "
            f"{run['excepted']} of {run['elements']} elements, held within 2 "
            f"lr (gradients in (0, 10 eps): {run['tiny_gradients']}); ms a "
            f"step {[round(v, 1) for v in run['ms']]} (step 0 "
            f"unsharded {run['plain']['ms']:.1f}), warm median {warm:.1f} "
            f"ms, {row['tokens_per_s']:.0f} tokens/s; peak "
            f"{run['peak_gib']:.2f} GiB (unsharded step "
            f"{run['plain']['peak_gib']:.2f})" + (
                "" if train_row is None else
                f"; beside 20a's unsharded {train_row['warm_step_ms']:.1f} "
                f"ms, {train_row['tokens_per_s']:.0f} tokens/s, "
                f"{train_row['peak_gib']:.2f} GiB (sharded / unsharded "
                f"{warm / train_row['warm_step_ms']:.4f})") +
            f"; {card} ({time.perf_counter() - t0:.1f} s)")

        # -- b. qwen3-moe-30b-a3b at full width, 2 layers, fp32 ----------------
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  n_layers=args.train_moe_layers)
        run = held_to_unsharded(cfg, TRAIN_MOE_BATCH, TRAIN_SEQ, 1, "21b",
                                mesh, rng, dev, sharding)
        if min(run["launches"].get(k, 0) for k in k12) <= 0:
            raise AssertionError(f"21b launched {run['launches']}: K1 and K2 "
                                 f"must launch in moe_apply's mesh branch")
        row = {"name": f"shard_train_step {MOE_ARCH} {cfg.n_layers} layers "
                       f"fp32 (1, 1) mesh", "batch": TRAIN_MOE_BATCH,
               "seq": TRAIN_SEQ, "step_ms": run["ms"],
               "unsharded_step0_ms": run["plain"]["ms"], **{
                   k: run[k] for k in ("losses", "peak_gib", "launches",
                                       "worst_grad_excess",
                                       "worst_param_excess", "elements",
                                       "tiny_gradients", "excepted")},
               "card": card}
        e2e.append(row)
        log(f"[shard] 21b {MOE_ARCH}, {cfg.n_layers} layers fp32, batch "
            f"{TRAIN_MOE_BATCH} x {TRAIN_SEQ}, through moe_apply's mesh "
            f"branch: loss {run['losses'][0]:.6f} (unsharded "
            f"{run['plain']['loss']:.6f}); gradients within rtol "
            f"{TRAIN_RTOL} + {run['worst_grad_excess']:.3g}, parameters "
            f"within rtol {TRAIN_RTOL} + {run['worst_param_excess']:.3g} "
            f"(gate atol {TRAIN_ATOL}) but {run['excepted']} of "
            f"{run['elements']} elements, held within 2 lr (gradients in "
            f"(0, 10 eps): {run['tiny_gradients']}); step "
            f"{run['ms'][0]:.1f} ms (unsharded step 0 "
            f"{run['plain']['ms']:.1f}); launches "
            f"{json.dumps(run['launches'])}; peak {run['peak_gib']:.2f} GiB "
            f"({time.perf_counter() - t0:.1f} s)")

        # -- c. split-KV decode over the one-rank data group -------------------
        t0 = time.perf_counter()
        cfg = get_config(TRAIN_ARCH)
        model = T.Transformer(cfg, device=dev).init_params(
            torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 62))))
        group = mesh.get_group("data")
        dense = T.init_cache(cfg, 2, SHARD_DECODE_LEN, torch.float32,
                             device=dev)
        split = T.init_cache(cfg, 2, SHARD_DECODE_LEN, torch.float32,
                             device=dev,
                             kv_shards=torch.distributed.get_world_size(group))
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, SHARD_DECODE_STEPS))).to(dev)
        worst = 0.0
        with AS.meshed(None, mesh), torch.inference_mode():
            for pos in range(SHARD_DECODE_STEPS):
                want, _ = T.decode_step(model, cfg, dense,
                                        tokens[:, pos:pos + 1], pos)
                got, _ = T.decode_step(model, cfg, split,
                                       tokens[:, pos:pos + 1], pos,
                                       kv_seq_axis="data")
                worst = max(worst, check_close(f"21c split-KV decode at pos "
                                               f"{pos}", got, want, 1e-3))
            split_ms = cuda_ms(lambda: T.decode_step(
                model, cfg, split, tokens[:, :1], SHARD_DECODE_STEPS,
                kv_seq_axis="data"), 1, 5)
            dense_ms = cuda_ms(lambda: T.decode_step(
                model, cfg, dense, tokens[:, :1], SHARD_DECODE_STEPS), 1, 5)
        e2e.append({"name": f"split-KV decode {TRAIN_ARCH} fp32",
                    "steps": SHARD_DECODE_STEPS, "max_abs_err": worst,
                    "ms": split_ms, "dense_ms": dense_ms, "card": card})
        log(f"[shard] 21c {TRAIN_ARCH} split-KV decode over the one-rank "
            f"data group: {SHARD_DECODE_STEPS} steps within 1e-3 of the "
            f"dense decode (max |err| {worst:.3e}); a step {split_ms:.3f} ms, "
            f"dense {dense_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)")

        # -- d. gpipe at S = 1: llama's first MLP as the stage ------------------
        t0 = time.perf_counter()
        stage = functools.partial(L.mlp_apply, cfg=cfg)
        x = torch.randn((PIPE_M, PIPE_MB, PIPE_SEQ, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            int(rng.integers(1 << 62))))
        with torch.inference_mode():
            got = gpipe_apply(lambda p, h: stage(p, x=h), mesh, "data",
                              model.blocks[0].ffn, x)
            want = torch.stack([stage(model.blocks[0].ffn, x=h) for h in x])
        err = check_close("21d gpipe_apply at S = 1", got, want, 1e-6)
        log(f"[shard] 21d gpipe_apply at S = 1 ({PIPE_M} microbatches of "
            f"{PIPE_MB} x {PIPE_SEQ}, llama's first MLP as the stage): "
            f"max |err| {err:.3e} against the stage applied to each "
            f"({time.perf_counter() - t0:.1f} s)")
        del model, dense, split, x, got, want
        gc.collect()
        torch.cuda.empty_cache()
    path_counts["sharding"] = sharding

    # -- e. per-rank parameter bytes on the production mesh, by spec ----------
    for arch in list_configs():
        cfg = get_config(arch)
        meta = T.Transformer(cfg, device="meta", dtype=torch.bfloat16)
        specs = SH.param_specs(meta, cfg, SHARD_STUB)
        total = held = 0
        for name, p in meta.named_parameters():
            n = p.numel() * p.element_size()
            total += n
            held += n // math.prod(SHARD_STUB[a] for ax in specs[name]
                                   for a in SH.entry_axes(ax))
        log(f"[shard] 21e {arch} bf16 on the {SHARD_STUB} mesh: "
            f"{total / 1e9:.3f} GB of parameters, {held / 2**20:.1f} MiB a "
            f"rank ({held / total * 256:.3f} x total / 256; arithmetic from "
            f"param_specs, nothing allocated)")
    log(f"[launches] sharding path (21a-b's sharded steps): "
        f"{json.dumps({k: c for k, c in sharding.items() if c})}")
    log(f"[shard] phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return e2e


TP_FAKE_MODEL = 4  # 22b: rank 0 of a 4-way tensor-parallel group
TP_DRYRUN_CELLS = (("llama3.2-1b", "train_4k"),
                   ("qwen3-moe-30b-a3b", "train_4k"),
                   ("deepseek-67b", "decode_32k"),
                   ("jamba-v0.1-52b", "long_500k"))  # 22c, on 16 x 16


def tp_phases(args, dev, card: str, path_counts: dict) -> list:
    """Phase 22: tensor parallelism over `model`: the dense layers, the
    vocab-split embedding, head and loss, mamba and the xLSTM mixers.

    22a, on a (1, 1) mesh of one NCCL rank: llama3.2-1b's prefill at full
    width through K5 on the local heads, qwen3-moe-30b-a3b cut to
    ``--train-moe-layers`` layers (its prefill and one sharded train step,
    the dispatch on K1/K2) and llama's split-KV decode through the TP
    layers, each held to the unsharded step (logits and decode within
    1e-3, the train step by 21's gate); then jamba-v0.1-52b's one period
    (8 layers, fp32; K5 in its attention layer, K1/K2 in its four MoE
    layers) and xlstm-125m at full width and depth, fp32: the prefill and
    ``SHARD_DECODE_STEPS`` decode steps through the split mixers held to
    the unsharded ones within 1e-3; adds
    ``path_counts["tensor_parallel"]``.  22b, rank 0 of a (1, 4) mesh on a
    fake process group over the card: llama's prefill as one card of a
    4-way group computes it (8 of 32 heads, 2 of 8 KV heads, F 2048 of
    8192, a quarter of the vocab), and jamba's period's and xlstm-125m's
    likewise (a quarter of mamba's channels and of jamba's experts;
    xlstm's 1 of 4 mLSTM heads and 192 of 768 sLSTM units), timed only
    (the fake collectives leave partial sums and unfilled gathers), and
    K5 at llama's local shape against its plain version.  22c: the dry-run
    of ``TP_DRYRUN_CELLS`` on a fake 16 x 16 group, four child processes
    on the host's cores after 22a-b.  Returns e2e rows."""
    from repro_torch import train_lib as TL
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import act_sharding as AS
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = phase_rng(args.seed, 22)
    e2e, counts = [], {}
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    children = []
    try:
        B, S = PREFILL_BATCH, PREFILL_SEQ
        llama = dataclasses.replace(get_config(TRAIN_ARCH),
                                    use_pallas_attention=True)
        if args.lm_layers:
            llama = dataclasses.replace(llama, n_layers=args.lm_layers)
        moe = dataclasses.replace(get_config(MOE_ARCH),
                                  n_layers=args.train_moe_layers)
        jamba = get_config(HYBRID_ARCH)
        jamba = dataclasses.replace(jamba, n_layers=len(jamba.pattern),
                                    use_pallas_attention=True)
        recurrent = ((jamba, f"{HYBRID_ARCH} one period fp32"),
                     (get_config(XLSTM_ARCH), f"{XLSTM_ARCH} fp32"))

        def counted(fn):
            """``fn()`` with the launch counts zeroed before it and added
            to the TP path's after it."""
            ops.reset_launch_counts()
            out = fn()
            torch.cuda.synchronize()
            for k, c in ops.launch_counts().items():
                counts[k] = counts.get(k, 0) + c
            return out

        def prefill_held(cfg, what: str, mesh) -> dict:
            """The unsharded prefill, then ``shard_prefill_step`` of the
            same weights stored by spec, held within 1e-3; both timed."""
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, S))).to(dev)}
            model = T.Transformer(cfg, device=dev).init_params(
                torch.Generator(device=dev).manual_seed(
                    int(rng.integers(1 << 62))))
            plain = TL.make_prefill_step(cfg)
            want = plain(model, batch)
            plain_ms = cuda_ms(lambda: plain(model, batch), 1, 3)
            TL.shard_model(model, cfg, mesh)
            step = TL.shard_prefill_step(cfg, mesh)
            before = dict(counts)
            got = counted(lambda: step(model, batch))
            launched = {k: c - before.get(k, 0) for k, c in counts.items()
                        if c - before.get(k, 0)}
            err = check_close(f"22a {what} TP prefill vs unsharded", got,
                              want, 1e-3)
            ms = cuda_ms(lambda: step(model, batch), 1, 3)
            del model, got, want
            gc.collect()
            torch.cuda.empty_cache()
            row = {"name": f"TP prefill {what} (1, 1) mesh", "batch": B,
                   "seq": S, "max_abs_err": err, "ms": ms,
                   "unsharded_ms": plain_ms, "launches": launched,
                   "card": card}
            log(f"[tp] {row['name']}: logits within 1e-3 of the unsharded "
                f"prefill (max |err| {err:.3e}); {ms:.2f} ms, unsharded "
                f"{plain_ms:.2f} ms ({ms / plain_ms:.4f}); launches "
                f"{json.dumps(launched)} ({time.perf_counter() - t0:.1f} s)")
            return row

        def recurrent_held(cfg, what: str, mesh) -> dict:
            """The unsharded prefill and ``SHARD_DECODE_STEPS`` decode
            steps, then ``shard_prefill_step`` and the decode steps through
            the split mixers (the same weights stored by spec), each held
            within 1e-3; the times of both."""
            t0 = time.perf_counter()
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                   (B, S))).to(dev)
            model = T.Transformer(cfg, device=dev).init_params(
                torch.Generator(device=dev).manual_seed(
                    int(rng.integers(1 << 62))))
            plain = TL.make_prefill_step(cfg)
            want = plain(model, {"tokens": tokens})
            plain_ms = cuda_ms(lambda: plain(model, {"tokens": tokens}), 1, 3)
            dense = T.init_cache(cfg, B, SHARD_DECODE_LEN, torch.float32,
                                 device=dev)
            with torch.inference_mode():
                want_dec = [T.decode_step(model, cfg, dense,
                                          tokens[:, p:p + 1], p)[0]
                            for p in range(SHARD_DECODE_STEPS)]
                dense_ms = cuda_ms(lambda: T.decode_step(
                    model, cfg, dense, tokens[:, :1], SHARD_DECODE_STEPS),
                    1, 5)
            TL.shard_model(model, cfg, mesh)
            step = TL.shard_prefill_step(cfg, mesh)
            before = dict(counts)
            got = counted(lambda: step(model, {"tokens": tokens}))
            launched = {k: c - before.get(k, 0) for k, c in counts.items()
                        if c - before.get(k, 0)}
            err = check_close(f"22a {what} TP prefill vs unsharded", got,
                              want, 1e-3)
            ms = cuda_ms(lambda: step(model, {"tokens": tokens}), 1, 3)
            del got, want
            cache = T.init_cache(cfg, B, SHARD_DECODE_LEN, torch.float32,
                                 device=dev, mesh=mesh)
            worst = 0.0
            with AS.meshed(("data",), mesh), torch.inference_mode():
                for p in range(SHARD_DECODE_STEPS):
                    got = counted(lambda: T.decode_step(
                        model, cfg, cache, tokens[:, p:p + 1], p,
                        kv_seq_axis="model")[0])
                    worst = max(worst, check_close(
                        f"22a {what} TP decode at pos {p}", got, want_dec[p],
                        1e-3))
                tp_dec_ms = cuda_ms(lambda: T.decode_step(
                    model, cfg, cache, tokens[:, :1], SHARD_DECODE_STEPS,
                    kv_seq_axis="model"), 1, 5)
            nxt, _ = TL.shard_decode_step(cfg, mesh)(
                model, cache, tokens[:, :1], SHARD_DECODE_STEPS)
            if nxt.shape != (B, 1):
                raise AssertionError(f"22a {what} shard_decode_step: "
                                     f"{nxt.shape}")
            del model, cache, dense, want_dec
            gc.collect()
            torch.cuda.empty_cache()
            row = {"name": f"TP prefill and decode {what} (1, 1) mesh",
                   "batch": B, "seq": S, "max_abs_err": err,
                   "decode_max_abs_err": worst, "ms": ms,
                   "unsharded_ms": plain_ms, "decode_ms": tp_dec_ms,
                   "dense_decode_ms": dense_ms, "launches": launched,
                   "card": card}
            log(f"[tp] 22a {what} through the split mixers: prefill within "
                f"1e-3 of the unsharded (max |err| {err:.3e}), "
                f"{SHARD_DECODE_STEPS} decode steps within 1e-3 (max |err| "
                f"{worst:.3e}); prefill {ms:.2f} ms, unsharded "
                f"{plain_ms:.2f} ms ({ms / plain_ms:.4f}); a decode step "
                f"{tp_dec_ms:.3f} ms, dense {dense_ms:.3f} ms; launches on "
                f"the prefill {json.dumps(launched)} "
                f"({time.perf_counter() - t0:.1f} s)")
            return row

        def fake_rank0(cfg, m: int) -> tuple:
            """Rank 0 of a (1, m) mesh on a fake group: ``shard_prefill_step``
            of ``cfg``'s prefill, timed.  Returns (ms, its launches)."""
            with D.fake_world(m):
                mesh = make_host_mesh(1, m, device=dev)
                batch = {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab, (B, S))).to(dev)}
                model = T.Transformer(cfg, device=dev).init_params(
                    torch.Generator(device=dev).manual_seed(
                        int(rng.integers(1 << 62))))
                TL.shard_model(model, cfg, mesh)
                gc.collect()
                torch.cuda.empty_cache()
                step = TL.shard_prefill_step(cfg, mesh)
                ops.reset_launch_counts()
                step(model, batch)
                torch.cuda.synchronize()
                fake = {k: c for k, c in ops.launch_counts().items() if c}
                fake_ms = cuda_ms(lambda: step(model, batch), 1, 3)
                del model
                gc.collect()
                torch.cuda.empty_cache()
            return fake_ms, fake

        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        with one_rank_group(dev):
            mesh = make_host_mesh(1, 1, device=dev)
            # -- a. the TP path on a (1, 1) mesh -----------------------------
            row = prefill_held(llama, f"{TRAIN_ARCH} fp32 K5", mesh)
            if row["launches"].get("flash_attention_kernel", 0) != \
                    llama.n_layers:
                raise AssertionError(f"22a launched {row['launches']}: K5 "
                                     f"once a layer ({llama.n_layers})")
            e2e.append(row)
            row = prefill_held(moe, f"{MOE_ARCH} {moe.n_layers} layers "
                               f"fp32", mesh)
            e2e.append(row)
            t0 = time.perf_counter()
            run = held_to_unsharded(moe, TRAIN_MOE_BATCH, TRAIN_SEQ, 1,
                                    "22a", mesh, rng, dev, counts)
            e2e.append({"name": f"TP shard_train_step {MOE_ARCH} "
                                f"{moe.n_layers} layers fp32 (1, 1) mesh",
                        **{k: run[k] for k in ("losses", "ms", "launches",
                                               "worst_grad_excess",
                                               "worst_param_excess",
                                               "excepted", "elements")},
                        "unsharded_ms": run["plain"]["ms"], "card": card})
            log(f"[tp] 22a {MOE_ARCH} {moe.n_layers} layers, one sharded "
                f"train step through the TP layers and the MoE branch: loss "
                f"{run['losses'][0]:.6f} (unsharded "
                f"{run['plain']['loss']:.6f}); gradients within rtol "
                f"{TRAIN_RTOL} + {run['worst_grad_excess']:.3g}, parameters "
                f"within rtol {TRAIN_RTOL} + {run['worst_param_excess']:.3g} "
                f"but {run['excepted']} of {run['elements']} elements (within "
                f"2 lr); {run['ms'][0]:.1f} ms (unsharded "
                f"{run['plain']['ms']:.1f}); launches "
                f"{json.dumps(run['launches'])} "
                f"({time.perf_counter() - t0:.1f} s)")
            for k in ("fractal_histogram", "fractal_rank_kernel"):
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"22a launched {counts}: {k} on "
                                         f"the MoE TP path")

            t0 = time.perf_counter()
            cfg = get_config(TRAIN_ARCH)
            model = T.Transformer(cfg, device=dev).init_params(
                torch.Generator(device=dev).manual_seed(
                    int(rng.integers(1 << 62))))
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab, (2, SHARD_DECODE_STEPS))).to(dev)
            dense = T.init_cache(cfg, 2, SHARD_DECODE_LEN, torch.float32,
                                 device=dev)
            with torch.inference_mode():
                want = [T.decode_step(model, cfg, dense,
                                      tokens[:, p:p + 1], p)[0]
                        for p in range(SHARD_DECODE_STEPS)]
                dense_ms = cuda_ms(lambda: T.decode_step(
                    model, cfg, dense, tokens[:, :1], SHARD_DECODE_STEPS),
                    1, 5)
            TL.shard_model(model, TL.serving_config(cfg, mesh), mesh)
            cache = T.init_cache(cfg, 2, SHARD_DECODE_LEN, torch.float32,
                                 device=dev, mesh=mesh)
            worst = 0.0
            with AS.meshed(("data",), mesh), torch.inference_mode():
                for p in range(SHARD_DECODE_STEPS):
                    got = counted(lambda: T.decode_step(
                        model, cfg, cache, tokens[:, p:p + 1], p,
                        kv_seq_axis="model")[0])
                    worst = max(worst, check_close(
                        f"22a TP split-KV decode at pos {p}", got, want[p],
                        1e-3))
                tp_ms = cuda_ms(lambda: T.decode_step(
                    model, cfg, cache, tokens[:, :1], SHARD_DECODE_STEPS,
                    kv_seq_axis="model"), 1, 5)
            nxt, _ = TL.shard_decode_step(cfg, mesh)(
                model, cache, tokens[:, :1], SHARD_DECODE_STEPS)
            if nxt.shape != (2, 1):
                raise AssertionError(f"22a shard_decode_step: {nxt.shape}")
            e2e.append({"name": f"TP split-KV decode {TRAIN_ARCH} fp32",
                        "steps": SHARD_DECODE_STEPS, "max_abs_err": worst,
                        "ms": tp_ms, "dense_ms": dense_ms, "card": card})
            log(f"[tp] 22a {TRAIN_ARCH} decode through the TP layers, "
                f"split-KV over `model`: {SHARD_DECODE_STEPS} steps within "
                f"1e-3 of the dense decode (max |err| {worst:.3e}); a step "
                f"{tp_ms:.3f} ms, dense {dense_ms:.3f} ms "
                f"({time.perf_counter() - t0:.1f} s)")
            del model, dense, cache, want
            gc.collect()
            torch.cuda.empty_cache()
            # jamba's period and xlstm-125m through the split mixers
            for cfg, what in recurrent:
                row = recurrent_held(cfg, what, mesh)
                if cfg.name == HYBRID_ARCH:
                    n_moe = sum(f == "moe" for _, f in cfg.pattern)
                    n_attn = sum(mx == "attn" for mx, _ in cfg.pattern)
                    want = {"flash_attention_kernel": n_attn,
                            "fractal_histogram": n_moe,
                            "fractal_rank_kernel": n_moe}
                    if {k: row["launches"].get(k, 0) for k in want} != want:
                        raise AssertionError(
                            f"22a {what} TP prefill launched "
                            f"{row['launches']}, expected {want}")
                e2e.append(row)
        path_counts["tensor_parallel"] = counts

        # -- b. one card of a 4-way TP group, on a fake group --------------
        t0 = time.perf_counter()
        m = TP_FAKE_MODEL
        fake_ms, fake = fake_rank0(llama, m)
        shape = (B, S, llama.n_heads // m, llama.resolved_head_dim)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev) for _ in range(3))
        k5_err = check_close(f"22b K5 at the local shape {shape}",
                             flash_attention_kernel(q, k, v, causal=True),
                             ref.flash_attention_ref(q, k, v, causal=True),
                             1e-4)
        k5_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=True))
        del q, k, v
        unsharded = e2e[0]["unsharded_ms"]
        e2e.append({"name": f"TP prefill {TRAIN_ARCH} fp32, rank 0 of a "
                            f"(1, {m}) fake group (timing only)",
                    "ms": fake_ms, "unsharded_ms": unsharded,
                    "k5_local_shape": list(shape), "k5_max_abs_err": k5_err,
                    "k5_ms": k5_ms, "launches": fake, "card": card})
        log(f"[tp] 22b {TRAIN_ARCH} fp32 prefill {B} x {S} as rank 0 of a "
            f"(1, {m}) mesh computes it ({llama.n_heads // m} of "
            f"{llama.n_heads} heads, {max(llama.n_kv_heads // m, 1)} of "
            f"{llama.n_kv_heads} KV heads, F {llama.d_ff // m} of "
            f"{llama.d_ff}): {fake_ms:.2f} ms against the unsharded "
            f"{unsharded:.2f} ms ({fake_ms / unsharded:.4f}); TIMING ONLY: the "
            f"fake group's collectives move nothing, so its sums are partial "
            f"and its gathers unfilled; launches {json.dumps(fake)} (not "
            f"counted on a path); K5 at {shape} within 1e-4 of its plain "
            f"version (max |err| {k5_err:.3e}), {k5_ms:.3f} ms "
            f"({time.perf_counter() - t0:.1f} s)")
        unsharded_of = {row["name"]: row.get("unsharded_ms") for row in e2e}
        for cfg, what in recurrent:
            t0 = time.perf_counter()
            fake_ms, fake = fake_rank0(cfg, m)
            unsharded = unsharded_of[
                f"TP prefill and decode {what} (1, 1) mesh"]
            e2e.append({"name": f"TP prefill {what}, rank 0 of a (1, {m}) "
                                f"fake group (timing only)",
                        "ms": fake_ms, "unsharded_ms": unsharded,
                        "launches": fake, "card": card})
            log(f"[tp] 22b {what} prefill {B} x {S} as rank 0 of a (1, {m}) "
                f"mesh computes it: {fake_ms:.2f} ms against the unsharded "
                f"{unsharded:.2f} ms ({fake_ms / unsharded:.4f}); TIMING "
                f"ONLY; launches {json.dumps(fake)} (not counted on a path) "
                f"({time.perf_counter() - t0:.1f} s)")

        # -- c. the dry-run cells, one child process each -------------------
        # (after a-b: four CPU-bound children would slow their host side)
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        children += [(arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out-dir", dry_dir], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for arch, shape in TP_DRYRUN_CELLS]
        for arch, shape, child in children:
            out, _ = child.communicate(timeout=600)
            if child.returncode != 0:
                raise AssertionError(f"22c dry-run {arch} x {shape} "
                                     f"failed:\n{out[-3000:]}")
            for line in out.splitlines():
                if line.startswith("[dryrun] ") and " x " in line:
                    log(f"[tp] 22c {line}")
            with open(os.path.join(dry_dir, f"{arch}_{shape}_16x16.json")) as f:
                res = json.load(f)
            e2e.append({"name": f"dry-run {arch} {shape} 16x16",
                        **{k: res[k] for k in (
                            "trace_seconds", "flops_per_device",
                            "bytes_read_per_device", "bytes_written_per_device",
                            "memory")},
                        "collectives": {k: v["count"] for k, v in res[
                            "collectives"]["by_kind"].items()},
                        "wire_bytes": res["collectives"]["total_wire_bytes"]})
        log(f"[tp] 22c {len(children)} dry-run cells on the host's CPU "
            f"(meta tensors, fake 16 x 16 group, one child process each) "
            f"in {time.perf_counter() - t0:.1f} s")
    finally:
        for _, _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(dry_dir, True)
    log(f"[launches] tensor-parallel path (22a): "
        f"{json.dumps({k: c for k, c in counts.items() if c})}")
    log(f"[tp] phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return e2e


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2n", type=int, default=27,
                    help="main-path key count 2**log2n (default 27)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one p=32 sort, one call of K1, its "
                         "sweep and K3, one prefill, one serve, each "
                         "query and one llama3.2-1b train step with "
                         "torch.profiler and print device time by kernel "
                         "and op")
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="cut llama3.2-1b to this many layers (default: "
                         "all 16)")
    ap.add_argument("--moe-layers", type=int, default=None,
                    help="cut qwen3-moe-30b-a3b to this many layers in phase "
                         "18 (default: all 48)")
    ap.add_argument("--hybrid-layers", type=int, default=HYBRID_LAYERS,
                    help="cut jamba-v0.1-52b to this many layers in phase "
                         "19b, a multiple of its period of 8 (default 16 "
                         "of 32: 52 GB of bf16 weights; 8 for a rehearsal)")
    ap.add_argument("--train-moe-layers", type=int, default=TRAIN_MOE_LAYERS,
                    help="qwen3-moe-30b-a3b's layers in phase 20c's train "
                         "steps at full width (default 2)")
    ap.add_argument("--query-log2n", type=int, default=26,
                    help="about 2**N lineitem rows (2**(N-2) orders) in the "
                         "query phases (default 26; 20 for a rehearsal)")
    ap.add_argument("--stream-log2n", type=int, default=24,
                    help="the first 2**N lineitem rows the streaming "
                         "queries read from the host (default 24)")
    args = ap.parse_args()
    if args.hybrid_layers <= 0 or args.hybrid_layers % 8:
        ap.error("--hybrid-layers must be a positive multiple of 8")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    # phases 1-16 resolve their plans from an empty autotune cache, whatever
    # cache the machine holds; phase 17 fills its own in the same directory
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                            "empty.json")
    from repro_torch.core import (exclusive_cumsum, fractal_argsort,
                                  fractal_sort, fractal_sort_pairs,
                                  make_sort_plan)
    from repro_torch.core.fractal_tree import u32_to_int64
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.fractal_histogram import (
        fractal_histogram, fractal_histogram_digits)
    from repro_torch.kernels.fractal_rank import (fractal_rank_kernel,
                                                  fractal_rank_scatter_kernel,
                                                  wide_hi_bins)
    from repro_torch.kernels.fractal_reconstruct import fractal_reconstruct
    from repro_torch.kernels.fractal_scatter import fractal_scatter

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.build_log)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s (0 when already built)")
    spills = []
    for name, text in sorted(_build.build_log.items()):
        kernel = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            if "registers" in line:
                log(f"[build] {name}: {(kernel or '')[:100]}: "
                    f"{line.split(':', 1)[-1].strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(f"{kernel}: {line.strip()}")
    if spills:
        raise AssertionError(f"register spills: {spills}")
    hmma = {fn: c for fn, c in sass_hmma_counts(
        _build.library_file("flash_attention")).items() if "flash_kernel" in fn}
    log(f"[build] K5 SASS HMMA instructions by instance: {json.dumps(hmma)}; "
        f"total {sum(hmma.values())}")
    if not hmma or min(hmma.values()) == 0:
        raise AssertionError(f"a K5 instance has no HMMA instruction: {hmma}")

    # -- 3. kernel vs plain, bit-exact -----------------------------------------
    errs = {k: 0 for k in ops.SORT_KERNELS}

    def agree(kernel: str, got, want, what: str) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        if err != 0:
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version at {what}: max |err| = {err}")

    t0 = time.perf_counter()
    rng = phase_rng(args.seed, 3)
    cases = 0
    for n in (1, 1000, (1 << 20) + 37):
        for n_bins in (16, 256, 1 << 16):
            what = f"n={n} n_bins={n_bins}"
            # digits with some out-of-range pads (-1 and n_bins) mixed in
            d = rng.integers(0, n_bins, n).astype(np.int32)
            d[rng.random(n) < 0.01] = -1
            d[rng.random(n) < 0.01] = n_bins
            keys = torch.from_numpy(d).to(dev)
            agree("fractal_histogram", fractal_histogram(keys, n_bins),
                  ref.histogram_ref(keys, n_bins), what)
            init = torch.from_numpy(
                rng.integers(0, 1000, n_bins).astype(np.int32)).to(dev)
            agree("fractal_histogram", fractal_histogram(keys, n_bins, init=init),
                  ref.histogram_ref(keys, n_bins, init=init), what + " init")
            start = torch.from_numpy(
                rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(dev)
            agree("fractal_rank_kernel",
                  fractal_rank_kernel(keys, start, n_bins),
                  ref.rank_ref(keys, start, n_bins), what)
            # block 256 at 2**16 bins would pass the rank table's cap
            for block in ((1024, 256) if n_bins <= 256 else (1024,)):
                agree("fractal_rank_scatter_kernel",
                      fractal_rank_scatter_kernel(keys, start, n_bins,
                                                  block=block),
                      ref.rank_ref(keys, start, n_bins),
                      f"{what} block={block}")
            for t in (0, 4, 16):
                p = n_bins.bit_length() - 1 + t
                raw = rng.integers(0, 1 << p, n, dtype=np.uint64)
                s = torch.from_numpy(np.sort(raw).astype(np.uint32).view(np.int32)).to(dev)
                su = u32_to_int64(s)
                counts = ref.histogram_ref(su >> t, n_bins)
                trailing = (su & ((1 << t) - 1)).to(torch.int32)
                got = fractal_reconstruct(counts, trailing, n_bins, t)
                agree("fractal_reconstruct", got,
                      ref.reconstruct_ref(counts, trailing, t), f"{what} t={t}")
                agree("fractal_reconstruct", u32_to_int64(got), su,
                      f"{what} t={t} p={p} vs sorted keys")
            cases += 1
    # K2 and K3 on both sides of their look-back / table switch, tile
    # edges, skew
    k2_cases = 0
    for n in (1, 1000, 4095, 4096, 4097, 8191, 8192, 8193, (1 << 20) + 37):
        for n_bins in (1, 2, 16, 256, 257, 300, 511, 4096, 1 << 16):
            for dist in ("uniform", "zipf", "one_bin"):
                if dist == "uniform":
                    d = rng.integers(0, n_bins, n)
                elif dist == "zipf":
                    d = np.minimum(rng.zipf(1.2, n) - 1, n_bins - 1)
                else:
                    d = np.full(n, rng.integers(0, n_bins))
                d = d.astype(np.int32)
                d[rng.random(n) < 0.01] = -1
                d[rng.random(n) < 0.01] = n_bins
                # a high byte below K2's high bins, but no digit
                past = 256 * wide_hi_bins(n_bins)
                if n_bins > 256 and past > n_bins:
                    d[rng.random(n) < 0.01] = rng.integers(n_bins, past)
                keys = torch.from_numpy(d).to(dev)
                start = torch.from_numpy(
                    rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(dev)
                want = ref.rank_ref(keys, start, n_bins)
                what = f"n={n} n_bins={n_bins} {dist}"
                agree("fractal_rank_kernel",
                      fractal_rank_kernel(keys, start, n_bins), want, what)
                if n_bins > 256:  # the counts a sort hands the wide path
                    agree("fractal_rank_kernel",
                          fractal_rank_kernel(
                              keys, start, n_bins,
                              counts=fractal_histogram(keys, n_bins)),
                          want, what + " counts given")
                agree("fractal_rank_scatter_kernel",
                      fractal_rank_scatter_kernel(keys, start, n_bins), want,
                      what)
                k2_cases += 1
    log(f"[kernels] K2 and K3 bit-exact over {k2_cases} cases each (n x "
        f"n_bins x uniform/zipf/one-bin, with pads; K2 above 256 bins with "
        f"and without the counts)")
    # K3: its widest table (2**16 bins at n = 2**22) and an unaligned stream
    for n, n_bins, off in ((1 << 22, 1 << 16, 0), (50_001, 256, 1),
                           (50_001, 257, 3)):
        d = rng.integers(-1, n_bins + 1, n + off).astype(np.int32)
        keys = torch.from_numpy(d).to(dev)[off:]
        start = torch.from_numpy(
            rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(dev)
        agree("fractal_rank_scatter_kernel",
              fractal_rank_scatter_kernel(keys, start, n_bins),
              ref.rank_ref(keys, start, n_bins),
              f"n={n} n_bins={n_bins} offset {off}")
    # K1: register, shared and cluster counting; unaligned, ragged streams
    k1_cases = 0
    for n, n_bins, dist in itertools.product(
            (1, 31, 4095, 4097, (1 << 20) + 37),
            (1, 2, 15, 16, 17, 32, 33, 256, 1 << 14, (1 << 14) + 1, 20_000,
             3 * (1 << 14) + 3, (1 << 16) - 1, 1 << 16),
            ("uniform", "zipf", "one_bin")):
        if dist == "uniform":
            d = rng.integers(-1, n_bins + 1, n + 3)
        else:
            d = (np.minimum(rng.zipf(1.2, n + 3) - 1, n_bins - 1)
                 if dist == "zipf" else np.full(n + 3, rng.integers(n_bins)))
            d[rng.random(n + 3) < 0.01] = -1
            d[rng.random(n + 3) < 0.01] = n_bins
        base = torch.from_numpy(d.astype(np.int32)).to(dev)
        init = torch.from_numpy(
            rng.integers(0, 1000, n_bins).astype(np.int32)).to(dev)
        for off in (0, 1, 2, 3):
            keys = base[off:off + n]
            what = f"n={n} n_bins={n_bins} {dist} offset {off}"
            agree("fractal_histogram", fractal_histogram(keys, n_bins),
                  ref.histogram_ref(keys, n_bins), what)
            agree("fractal_histogram",
                  fractal_histogram(keys, n_bins, init=init),
                  ref.histogram_ref(keys, n_bins, init=init), what + " init")
            k1_cases += 1
    # K1's one sweep: every digit of a plan against per-digit histograms
    sweep_cases = 0
    for n in (1, 4097, (1 << 20) + 37):
        raw = torch.from_numpy(rng.integers(0, 1 << 32, n + 3, dtype=np.uint64)
                               .astype(np.uint32)).to(dev)
        for passes in (make_sort_plan(n, 32).passes,
                       make_sort_plan(n, 16).passes,
                       make_sort_plan(n, 7).passes,
                       make_sort_plan(n, 32, max_bins_log2=8,
                                      engine="scatter").passes):
            init = tuple(torch.from_numpy(rng.integers(
                0, 100, dp.n_bins).astype(np.int32)).to(dev) for dp in passes)
            for off in (0, 3):
                keys = raw[off:off + n]
                for carried in (None, init):
                    got = fractal_histogram_digits(keys, passes, init=carried)
                    want = ref.digit_histograms_ref(keys, passes, init=carried)
                    for dp, g, w in zip(passes, got, want):
                        agree("fractal_histogram_digits", g, w,
                              f"n={n} digit {dp} offset {off} "
                              f"init={carried is not None}")
                    sweep_cases += 1
    log(f"[kernels] K1 bit-exact over {k1_cases} cases (n x n_bins x "
        f"uniform/zipf/one-bin x offset, with and without init), its one "
        f"sweep over {sweep_cases} cases "
        f"(n x plan x offset x init)")
    # the payload carry: keys beside a payload of each row width (both
    # kernel paths), ragged n, sources off their 16-byte boundary, the
    # MSD pass's mask and none; outputs compared bit for bit
    scatter_cases = 0
    for n in (1, 5, 1001, (1 << 20) + 37):
        rank = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        keys = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n + 1)
                                .astype(np.int32)).to(dev)
        for pay in (keys, keys.long(), keys.to(torch.int16),
                    keys.to(torch.uint8), keys.to(torch.bfloat16),
                    torch.randn(n + 1, 3, device=dev)):
            for off, t in itertools.product((0, 1), (None, 28)):
                got = fractal_scatter(rank, keys[off:off + n],
                                      pay[off:off + n], trailing_bits=t)
                want = ref.scatter_ref(rank, keys[off:off + n],
                                       pay[off:off + n], trailing_bits=t)
                for g, w in zip(got, want):
                    agree("fractal_scatter", g.view(torch.uint8),
                          w.view(torch.uint8),
                          f"n={n} {pay.dtype} {tuple(pay.shape[1:])} "
                          f"offset {off} trailing_bits={t}")
                scatter_cases += 1
    log(f"[kernels] the scatter bit-exact over {scatter_cases} cases (n x "
        f"payload width x offset x mask)")
    # the histogram's init carried over ragged chunks equals one histogram
    d = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 37).astype(np.int32)).to(dev)
    carried = None
    for lo in range(0, d.shape[0], 300007):
        carried = fractal_histogram(d[lo:lo + 300007], 256, init=carried)
    agree("fractal_histogram", carried, ref.histogram_ref(d, 256),
          "init carried over ragged chunks")
    log(f"[kernels] K1-K4 bit-exact against their plain versions over "
        f"{cases} shape cases in {time.perf_counter() - t0:.1f} s; "
        f"max |err| {json.dumps(errs)}")

    # -- 4. the main path at n = 2**log2n ------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    rng = phase_rng(args.seed, 4)
    uni32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    zipf = rng.zipf(1.2, n)
    data = {
        (32, "uniform"): torch.from_numpy(uni32).to(dev),
        (32, "zipf"): torch.from_numpy(
            np.minimum(zipf, (1 << 32) - 1).astype(np.uint32)).to(dev),
        (16, "uniform"): torch.from_numpy(
            (uni32 >> 16).astype(np.int32)).to(dev),
        (16, "zipf"): torch.from_numpy(
            np.minimum(zipf, (1 << 16) - 1).astype(np.int32)).to(dev),
    }
    del uni32, zipf
    log(f"[data] n = 2**{args.log2n} keys per set, seed {args.seed}, "
        f"{time.perf_counter() - t0:.1f} s to generate")

    def expect(keys):
        k64 = u32_to_int64(keys)
        return torch.sort(k64, stable=True).values, torch.argsort(k64, stable=True)

    def check(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: result differs from torch.sort")

    ops.reset_launch_counts()
    t_main = time.perf_counter()
    per_sort = None
    for (p, dist), keys in data.items():
        t1 = time.perf_counter()
        out = fractal_sort(keys, p)
        if per_sort is None:  # the first sort: p=32 uniform, default plan
            per_sort = ops.launch_counts()
        want_keys, want_perm = expect(keys)
        check(f"fractal_sort p={p} {dist}", u32_to_int64(out), want_keys)
        if dist == "uniform" and p == 32:
            rowid = torch.arange(n, dtype=torch.int32, device=dev)
            sk, sv = fractal_sort_pairs(keys, rowid, p)
            check("fractal_sort_pairs keys", u32_to_int64(sk), want_keys)
            check("fractal_sort_pairs values", sv.long(), want_perm)
            del sk, sv, rowid
        if dist == "zipf":
            perm = fractal_argsort(keys, p)
            check(f"fractal_argsort p={p} {dist}", perm.long(), want_perm)
            sk, sv = ops.fractal_sort_pairs_kernel(
                keys, torch.arange(n, dtype=torch.int32, device=dev), p)
            check(f"fractal_sort_pairs_kernel p={p} {dist}",
                  sv.long(), want_perm)
            del perm, sk, sv
        if p == 16 and dist == "uniform":
            check("fractal_sort_kernel p=16", u32_to_int64(
                ops.fractal_sort_kernel(keys, p)), want_keys)
        log(f"[main] p={p} {dist}: {make_sort_plan(n, p).describe()} "
            f"bit-exact ({time.perf_counter() - t1:.1f} s with checks)")
        del out, want_keys, want_perm
    keys = data[(32, "uniform")]
    plan8 = make_sort_plan(n, 32, max_bins_log2=8, engine="scatter")
    check("fractal_sort 8-bit scatter plan",
          u32_to_int64(fractal_sort(keys, 32, plan=plan8)), expect(keys)[0])
    log(f"[main] p=32 uniform, plan {plan8.describe()} (engine scatter) "
        f"bit-exact")
    n24 = min(n, 1 << 24)
    keys24 = keys[:n24].contiguous()
    plan16 = make_sort_plan(n24, 32, max_bins_log2=16)
    via_cuda = fractal_sort(keys24, 32, plan=plan16)
    check("fractal_sort 16b+16b plan", u32_to_int64(via_cuda), expect(keys24)[0])
    via_torch = fractal_sort(keys24, 32, plan=plan16, backend="torch")
    check("TorchBackend 16b+16b plan", u32_to_int64(via_torch),
          u32_to_int64(via_cuda))
    log(f"[main] n=2**{n24.bit_length() - 1} p=32 plan {plan16.describe()}: "
        f"CudaBackend and TorchBackend bit-exact")
    counts = ops.launch_counts()
    main_s = time.perf_counter() - t_main

    # -- 5. launch counts over the main path ------------------------------------
    log(f"[launches] main path ({main_s:.1f} s): {json.dumps(counts)}; "
        f"one default-plan p=32 sort: {json.dumps(per_sort)}")
    for name in ops.SORT_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on the sort path")
    path_counts = {"sort": counts}
    # a warm p = 32 sort takes every pass's counts from one K1 sweep
    keys = data[(32, "uniform")]
    fractal_sort(keys, 32)
    ops.reset_launch_counts()
    fractal_sort(keys, 32)
    warm = {k: c for k, c in ops.launch_counts().items() if c}
    names = kernel_names(lambda: fractal_sort(keys, 32))
    if warm.get("fractal_histogram") != 1:
        raise AssertionError(f"a warm p=32 sort launched K1 "
                             f"{warm.get('fractal_histogram')} times by its "
                             f"counter; expected the one sweep")
    if names is None:
        log(f"[launches] one warm p=32 sort: counters {json.dumps(warm)}; "
            f"the profiler gave no whole trace, so the counter alone "
            f"vouches for the one K1 sweep")
    else:
        ours = [m.group(1) for m in (
            re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", k)
            for k in names) if m]
        k1 = [k for k in ours if k.startswith("histogram")]
        log(f"[launches] one warm p=32 sort: counters {json.dumps(warm)}; "
            f"profiler, the repo's kernels: {json.dumps(ours)}")
        if len(k1) != 1:
            raise AssertionError(f"a warm p=32 sort ran K1 {len(k1)} times "
                                 f"by the profiler (its device kernels: "
                                 f"{names}); expected the one sweep")

    # -- 6. times at the main path's shapes ---------------------------------------
    kbits = keys.view(torch.int32)
    d16 = (kbits >> 4) & 15   # pass 1 digit of the default p=32 plan
    d256 = kbits & 255        # pass 0 digit of the 8-bit plan
    c16 = fractal_histogram(d16, 16)
    c256 = fractal_histogram(d256, 256)
    s16, s256 = exclusive_cumsum(c16), exclusive_cumsum(c256)
    # the MSD pass's bin starts (its digit at t = 28)
    s28 = exclusive_cumsum(fractal_histogram((kbits >> 28) & 15, 16))
    plan32 = make_sort_plan(n, 32)
    msd = plan32.passes[-1]  # depth 4, t = 28
    sorted_keys = fractal_sort(keys, 32).view(torch.int32)
    trail = sorted_keys & ((1 << msd.shift) - 1)
    mcounts = fractal_histogram((sorted_keys >> msd.shift) & (msd.n_bins - 1),
                                msd.n_bins)
    cdf = torch.cumsum(mcounts, 0, dtype=torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    # the payload carry of a 16-bin pass; torch's index write with the
    # int64 index made beforehand is its yardstick (the port calls none)
    srank = fractal_rank_kernel(d16, s16, 16)
    sidx = srank.long()
    souts = (torch.empty_like(kbits), torch.empty_like(kbits))

    def index_put(*arrays):
        return tuple(o.index_put_((sidx,), a) for o, a in zip(souts, arrays))

    trail_mask = (1 << msd.shift) - 1
    rows = [
        ("fractal_histogram", "fractal_histogram.cu",
         "src/repro/kernels/fractal_histogram.py:88",
         lambda: fractal_histogram(d16, 16),
         lambda: ref.histogram_ref(d16, 16),
         lambda: torch.bincount(d16, minlength=16),
         4 * n + 2 * 4 * 16, f"n=2**{args.log2n}, 16 bins"),
        ("fractal_histogram_digits", "fractal_histogram.cu",
         "src/repro/kernels/fractal_histogram.py:88",
         lambda: fractal_histogram_digits(kbits, plan32.passes),
         lambda: ref.digit_histograms_ref(kbits, plan32.passes),
         None, 4 * n + 2 * 4 * sum(dp.n_bins for dp in plan32.passes),
         f"n=2**{args.log2n}, the p=32 plan's {len(plan32.passes)} x "
         f"{plan32.passes[0].bits}-bit digits"),
        ("fractal_rank_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:81",
         lambda: fractal_rank_kernel(d16, s16, 16),
         lambda: ref.rank_ref(d16, s16, 16),
         lambda: torch.sort(d16, stable=True),
         4 * n + 4 * 16 + 4 * n, f"n=2**{args.log2n}, 16 bins"),
        # K2 on the key stream, the digit taken in its registers, as a
        # sort's LSD pass (shift 4) and its MSD pass (shift 28) run it
        ("fractal_rank_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:81",
         lambda: fractal_rank_kernel(kbits, s16, 16, shift=4),
         lambda: ref.rank_ref(ref.digit_ref(kbits, 4, 15), s16, 16),
         lambda: torch.sort(d16, stable=True),
         4 * n + 4 * 16 + 4 * n,
         f"n=2**{args.log2n}, 16 bins, the key stream at shift 4"),
        ("fractal_rank_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:81",
         lambda: fractal_rank_kernel(kbits, s28, 16, shift=28),
         lambda: ref.rank_ref(ref.digit_ref(kbits, 28, 15), s28, 16),
         lambda: torch.sort((kbits >> 28) & 15, stable=True),
         4 * n + 4 * 16 + 4 * n,
         f"n=2**{args.log2n}, 16 bins, the key stream at shift 28"),
        ("fractal_rank_scatter_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:150",
         lambda: fractal_rank_scatter_kernel(d256, s256, 256),
         lambda: ref.rank_ref(d256, s256, 256),
         lambda: torch.sort(d256, stable=True),
         4 * n + 4 * 256 + 4 * n, f"n=2**{args.log2n}, 256 bins"),
        ("fractal_reconstruct", "fractal_reconstruct.cu",
         "src/repro/kernels/fractal_reconstruct.py:53",
         lambda: fractal_reconstruct(mcounts, trail, msd.n_bins, msd.shift),
         lambda: ref.reconstruct_ref(mcounts, trail, msd.shift),
         lambda: torch.searchsorted(cdf, slots, right=True),
         4 * n + 4 * msd.n_bins + 4 * n,
         f"n=2**{args.log2n}, {msd.n_bins} bins, t={msd.shift}"),
        ("fractal_scatter", "fractal_scatter.cu", "none (array code)",
         lambda: fractal_scatter(srank, kbits),
         lambda: ref.scatter_ref(srank, kbits),
         lambda: index_put(kbits),
         n * (4 + 4 + 4), f"n=2**{args.log2n}, keys, 16-bin ranks"),
        ("fractal_scatter", "fractal_scatter.cu", "none (array code)",
         lambda: fractal_scatter(srank, kbits, slots),
         lambda: ref.scatter_ref(srank, kbits, slots),
         lambda: index_put(kbits, slots),
         n * (4 + 8 + 8),
         f"n=2**{args.log2n}, keys + int32 payload, 16-bin ranks"),
        ("fractal_scatter", "fractal_scatter.cu", "none (array code)",
         lambda: fractal_scatter(srank, kbits, trailing_bits=msd.shift),
         lambda: ref.scatter_ref(srank, kbits, trailing_bits=msd.shift),
         lambda: index_put(kbits & trail_mask),
         n * (4 + 4 + 4),
         f"n=2**{args.log2n}, keys with the t={msd.shift} mask, 16-bin "
         f"ranks"),
    ]
    table = []
    for name, src, replaces, kern, plain, lib, nbytes, shape in rows:
        want = plain()
        if isinstance(want, tuple):  # the sweep: one tensor per digit
            want = torch.cat(want)
            got = torch.cat(kern())
        else:
            got = kern()
        agree(name, got, want, shape)
        del got, want
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 1, 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None if lib is None else cuda_ms(lib),
            "shape": shape,
        }
        table.append(entry)
        lib_ms = entry["library_ms"]
        log(f"[time] {name} ({shape}): {entry['ms']:.3f} ms, bound "
            f"{entry['bound_ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
            f"library " + ("none" if lib_ms is None else f"{lib_ms:.3f} ms")
            + (f"; earlier run: first version {FIRST_VERSION_MS[name]} ms"
               if name in FIRST_VERSION_MS
               and all(e["name"] != name for e in table[:-1]) else ""))
    if args.profile:  # the redesigned kernels' own device time
        log(json.dumps({"profile_kernels": {
            name: profile_call(kern, top=3) for name, _, _, kern, *_ in rows
            if name in ("fractal_histogram", "fractal_histogram_digits",
                        "fractal_rank_scatter_kernel")}, "card": card}))
    # K2 at 256 bins: the other engine's time where K3 runs (a yardstick)
    log(f"[time] fractal_rank_kernel (n=2**{args.log2n}, 256 bins, the "
        f"yardstick of K3 there): "
        f"{cuda_ms(lambda: fractal_rank_kernel(d256, s256, 256)):.3f} ms")
    # what a sort's pass spent on the digit before K2 took it from the
    # key stream: the extraction and K2 on the digit stream
    log(f"[time] fractal_rank_kernel (n=2**{args.log2n}, 16 bins): "
        f"extraction + the digit stream at shift 4 "
        f"{cuda_ms(lambda: fractal_rank_kernel((kbits >> 4) & 15, s16, 16)):.3f}"
        f" ms, at shift 28 "
        f"{cuda_ms(lambda: fractal_rank_kernel((kbits >> 28) & 15, s28, 16)):.3f}"
        f" ms")
    # K2 at 16 bins is one launch of its own: no count walk, no scan
    names = kernel_names(lambda: fractal_rank_kernel(d16, s16, 16))
    if names is None:
        log(f"[kernels] one K2 call at n=2**{args.log2n}, 16 bins: not "
            f"checked, the profiler gave no whole trace")
    else:
        own = [k for k in names
               if "FillFunctor" not in k and "emset" not in k]
        log(f"[kernels] one K2 call at n=2**{args.log2n}, 16 bins runs "
            f"{json.dumps(names)}")
        if len(own) != 1 or "lookback_rank_kernel" not in own[0]:
            raise AssertionError(f"K2 at 16 bins ran {own}, expected the "
                                 f"one look-back kernel")
    # K2 at 2**16 bins (the keys' high half, with its counts, as the
    # distributed pass calls it) runs the two-level path's kernels only
    dhi = (kbits >> 16) & 0xFFFF
    chi = fractal_histogram(dhi, 1 << 16)
    shi = exclusive_cumsum(chi)
    agree("fractal_rank_kernel",
          fractal_rank_kernel(dhi, shi, 1 << 16, counts=chi),
          ref.rank_ref(dhi, shi, 1 << 16), f"n=2**{args.log2n}, 2**16 bins")
    check_k2_wide(lambda: fractal_rank_kernel(dhi, shi, 1 << 16, counts=chi),
                  f"n=2**{args.log2n}, 2**16 bins, counts given")
    del dhi, chi, shi
    del d16, d256, s28, sorted_keys, trail, slots, srank, sidx, souts

    # the 16b+16b plan's shapes at n = 2**24: 2**16-bin digits, MSD t = 16
    lsd, msd16 = plan16.passes
    rank16 = (fractal_rank_scatter_kernel if lsd.engine == "scatter"
              else fractal_rank_kernel)
    k24 = keys24.view(torch.int32)
    d24 = (k24 >> lsd.shift) & (lsd.n_bins - 1)
    s24 = exclusive_cumsum(fractal_histogram(d24, lsd.n_bins))
    sorted24 = via_cuda.view(torch.int32)
    trail24 = sorted24 & ((1 << msd16.shift) - 1)
    c24 = fractal_histogram((sorted24 >> msd16.shift) & (msd16.n_bins - 1),
                            msd16.n_bins)
    what = f"n=2**{n24.bit_length() - 1}, {lsd.n_bins} bins"
    agree("fractal_histogram", fractal_histogram(d24, lsd.n_bins),
          ref.histogram_ref(d24, lsd.n_bins), what)
    agree(rank16.__name__, rank16(d24, s24, lsd.n_bins),
          ref.rank_ref(d24, s24, lsd.n_bins), what)
    agree("fractal_reconstruct",
          fractal_reconstruct(c24, trail24, msd16.n_bins, msd16.shift),
          ref.reconstruct_ref(c24, trail24, msd16.shift),
          f"{what}, t={msd16.shift}")
    log(f"[kernels] bit-exact against their plain versions at the main "
        f"path's shapes (n=2**{args.log2n} and {what}); max |err| "
        f"{json.dumps(errs)}")
    del k24, d24, sorted24, trail24

    e2e = []
    for p in (32, 16):
        keys = data[(p, "uniform")]
        k64 = u32_to_int64(keys)
        native = keys if p == 16 else k64
        e2e.append({
            "name": f"fractal_sort p={p} uniform",
            "plan": make_sort_plan(n, p).describe(), "n": n,
            "ms": cuda_ms(lambda: fractal_sort(keys, p), 1, 5),
            "torch_sort_ms": cuda_ms(lambda: torch.sort(native), 1, 5),
            "torch_sort_dtype": str(native.dtype),
        })
        log(f"[e2e] {e2e[-1]}")
        del k64, native
    keys = data[(32, "uniform")]
    e2e.append({
        "name": "fractal_sort p=32 uniform, 8-bit scatter plan",
        "plan": plan8.describe(), "n": n,
        "ms": cuda_ms(lambda: fractal_sort(keys, 32, plan=plan8), 1, 5),
    })
    log(f"[e2e] {e2e[-1]}")

    if args.profile:
        log(json.dumps({"profile": profile_call(
            lambda: fractal_sort(keys, 32)), "card": card}))

    # free the sort path's data before the model phases
    del (data, keys, keys24, via_cuda, via_torch, kbits, c16, c256, s16,
         s256, mcounts, cdf, c24, rows, kern, plain, lib, d, carried)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mem] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"after freeing the sort data")
    lm_table, lm_e2e = lm_phases(args, dev, card, path_counts)
    table += lm_table
    e2e += lm_e2e
    gc.collect()
    torch.cuda.empty_cache()
    e2e += query_phases(args, dev, card, path_counts)
    gc.collect()
    torch.cuda.empty_cache()
    stream_e2e, stream_errs = stream_phases(args, dev, card, path_counts)
    e2e += stream_e2e
    gc.collect()
    torch.cuda.empty_cache()
    dist_e2e, dist_errs, dist_shapes = distributed_phases(args, dev, card,
                                                          path_counts)
    e2e += dist_e2e
    gc.collect()
    torch.cuda.empty_cache()
    e2e += tune_phases(args, dev, card, path_counts, tune_dir)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mem] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before the MoE phase")
    moe_e2e, moe_errs, moe_kernel_rows = moe_phases(args, dev, card,
                                                    path_counts)
    e2e += moe_e2e
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mem] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before the families phase")
    e2e += families_phases(args, dev, card, path_counts)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[mem] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before the train phase")
    train_e2e = train_phases(args, dev, card, path_counts)
    e2e += train_e2e
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mem] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before the sharding phase")
    e2e += sharding_phases(args, dev, card, path_counts, train_e2e[0])
    gc.collect()
    torch.cuda.empty_cache()
    e2e += tp_phases(args, dev, card, path_counts)

    # every kernel launched on a main path (sort, prefill, serve, query,
    # stream, distributed, device store, autotune / baselines, moe,
    # families, train, sharding, tensor parallel)
    totals = {k: sum(c.get(k, 0) for c in path_counts.values())
              for k in ops.KERNELS}
    log(f"[launches] over the main paths: {json.dumps(totals)}; by path "
        f"{json.dumps(path_counts)}")
    for name, c in totals.items():
        if c <= 0:
            raise AssertionError(f"{name} was never launched on a main path")
    for entry in table:
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   stream_errs.get(entry["name"], 0),
                                   dist_errs.get(entry["name"], 0),
                                   moe_errs.get(entry["name"], 0))
        entry.update(moe_kernel_rows.get(entry["name"], {}))
        entry["launches"] = totals[entry["name"]]
        entry["launches_by_path"] = {p: c.get(entry["name"], 0)
                                     for p, c in path_counts.items()}
        if entry["name"] in dist_shapes:
            entry["distributed_shape"] = dist_shapes[entry["name"]]
        if entry["name"] == "fractal_histogram":  # its route above 2**14
            entry["cluster_launches_by_path"] = {
                p: c.get("fractal_histogram_cluster", 0)
                for p, c in path_counts.items()}

    name = torch.cuda.get_device_name(0)
    log(json.dumps({"e2e": e2e, "card": card}))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
