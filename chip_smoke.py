#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ems_nbldpc_torch``) on one CUDA card.

    python3 chip_smoke.py            # all phases, from the repo root
    python3 chip_smoke.py --profile  # all phases, and trace one batch of
                                     # each full-width chain
                                     # (profile_out/*.json)
    python3 chip_smoke.py --only-3   # phases 1-3 alone (K1)

Phases; any failure exits non-zero and prints no ``ok`` line.  The code is
random_regular(8100, 4050, 256, dv=2) (N = 8100 symbols = 64800 bits,
R = 1/2, GF(256), dc = 4, 3 super-layers), built once with its encoder.
Launch counts name K4 (``decide_rows``, the layered decoders' decisions)
beside the check-node kernels: one launch a layered step and one at each
decode's reset, which the device loop runs eagerly, outside its graph, so
"none eager" below leaves those resets out; "no launch" on a plain route
includes K4.

1. device: requires ``torch.cuda.is_available()``; prints nvidia-smi's card
   name and power limit, and the torch and CUDA versions;
2. build: compiles the six CUDA kernels and the device loop's graph
   helper with nvcc (sm_90a), one nvcc per source, started together;
   prints the times and ptxas' register / shared-memory report; then
   builds the full-width code;
3. EMS kernel against plain, bit for bit (``torch.equal``): the bare
   ``ops/cuda_cn.fb_checknode`` against ``minconv.fb_checknode_topk`` on
   truncated rows, and the fused step ``ops/cuda_cn.ems_rows`` against
   ``ems_rows_plain`` (and the torch route around the bare kernel) on
   min-normalised unrotated rows, with the real code's tables, at the
   main paths' shapes (layered [F·1350, 4, 256] with G = 1350 and
   flooding [F·4050, 4, 256] with G = 4050, F = 16 and 128, nm = 32) and
   at odd shapes with padding slots and ``valid`` (q = 16, dc = 12,
   nm = q and truncation off among them), on continuous inputs and on
   "ties" inputs (a few integer levels, so that the lower-GF-id-first
   tie order of the lists matters); at the four main shapes, times the
   fused kernel, the torch route around the bare kernel, the plain
   composition and the bare kernel in turns, beside the bound (bytes
   at 3.35 TB/s against candidates at 67 TFLOP/s); then K1's two further
   modes, bit for bit: the dense min-convolution (``ems_rows(...,
   dense=True)``: lists of all q entries) against ``ems_rows_plain(...,
   dense=True)`` (``minconv.fb_checknode_dense``) at the layered and
   flooding shapes (F = 16) with truncation at nm = 200 and without, and
   on the odd shapes; padded rows from K1's workspace (``ROWS_WS``:
   q = 256, dc = 34 and 40 dense, dc = 66 and 70 top-k at nm = 32) and of
   dc = 2 and 1 (the swapped pair and the delta message), both modes; ``ROWS_DENSE``'s dense rows that the dense
   merge's layout could break (q = 64, 128 and 8 at the layered row
   count, dc = 3 and 5, dc = 19 and 20 at q = 256 on either side of the
   workspace), each also with negative values in a third of its rows;
   the bare entry on bf16 rows against ``fb_checknode_topk`` on the same
   bf16 rows (dc = 1, 2 and 40 among them), and at nm = q (the dense
   merge) on bf16 rows and on f32 rows with negative values
   (``BARE_DENSE``); the dense mode timed at the layered shape F = 128 in
   turns with its plain version, beside its bound and its issue floor (an
   add and a minimum a candidate, two instructions, at 128 lanes a clock
   an SM and the card's largest SM clock), the workspace at dc = 40
   likewise, and the bare entry on bf16 rows in turns with it on f32
   rows;
3b. SPA kernel against plain, both entries.  The bare
   ``ops/cuda_spa.spa_checknode`` against ``fht.spa_checknode_plain`` at
   the main paths' shapes (layered F = 16 and 128 with G = 1350
   coefficient rows, flooding F = 16 with G = 4050) and at odd ones (some
   with padding coefficients), on decoder-like and uniform inputs.  The
   fused super-layer step ``cuda_spa.spa_layer`` against
   ``spa_layer_plain`` (and the pre-fusion torch route around the bare
   kernel) on the real code's three layer plans at F = 16 and 128, and on
   random layer tables with padded slots at odd shapes (q = 16 with
   dc = 12, q = 4 with dc = 2 among them), from a decoder-like state (APP
   one low-cost symbol per column and the rest 2..40, CtoV 0..10, the
   padding column and edge 0) with about a quarter of the frames frozen.
   Tolerance: the kernel's butterflies and the plain version's matrix
   products sum in different orders, and the inverse transform cancels q
   terms of O(1) down to p, which leaves p an f32 error near 1e-7 of the
   best symbol's, i.e. a cost error near 1e-7 * exp(cost): 3e-4 at cost 8,
   2e-2 at cost 12 (measured: 1.3e-2 at q = 16), and no agreement at all
   past cost ~16, where both sides are rounding noise.  So: exp(-cost)
   within atol 1e-5 everywhere, costs within atol 1e-3 where the plain
   cost is <= 8 (the likely symbols, which decide), and padding lanes
   exactly 0; for the fused step the updated CtoV so, APP within 1e-3
   where the plain CtoV is <= 8 (mvc is computed the same way on both
   sides), and frozen frames, the layer's untouched columns and edges and
   the padding column and edge equal bit for bit.  Prints the cost error
   by band; times the fused step, the pre-fusion route, the plain step and
   the bare kernel in turns at F = 16 and 128 beside the fused step's
   bound, and the bare kernel against its plain version;
3c. syndrome kernel against plain, both entries, bit for bit
   (``torch.equal``).  The bare ``ops/cuda_syndrome.syndrome_rows``
   against ``syndrome_rows_plain`` on min-normalised unrotated rows at the
   main paths' shapes (layered [F·1350, 4, 256] with G = 1350 and flooding
   [F·4050, 4, 256] with G = 4050, F = 16 and 128; the default table from
   the decoder's own cache, C = 993, nm = 32, bayes and presort on) and at
   odd shapes with padding slots (q = 16 / 64 / 256, dc = 3 / 4 / 6 / 12,
   nm = q, bayes and presort off, the median saturation, the full / 2dev /
   bordered tables), on continuous and "ties" inputs, timed against the
   plain version in turns at the layered and flooding F = 128 shapes
   beside the bound.  The fused super-layer step
   ``cuda_syndrome.syndrome_layer`` against ``syndrome_layer_plain``
   everywhere (frozen frames, untouched rows and the padding column and
   edge included) and against the pre-fusion route (torch gathers,
   normalisation, freeze and scatters around ``syndrome_rows``) on the
   real columns and edges, on the real code's three layer plans at F = 16
   and 128 and on odd random layers with padded slots (the odd shapes'
   tables), from decoder-like and "ties" states with about a quarter of
   the frames frozen; then timed at F = 128 in turns with the pre-fusion
   route, its plain version and the bare entry on the same rows, beside
   its bound (``--only-3c``: phases 1, 2 and 3c alone, no result line);
3d. demap kernel (K8, ``ops/cuda_demap``) against its plain version
   (``models/channels.demap_2d_plain`` / ``demap_4d_plain``), on one set of
   draws made on the card and modulated, within 1e-6 of the row's largest
   cost (the kernel rounds as the plain version does, so the run expects
   0): at [128, 8100, 256] 256-QAM ``ref`` / ``gray`` / ``v2`` / rotated
   under AWGN, Rayleigh, SSD, erasure 0.1 and Rayleigh + erasure 0.1, and
   the 4-D channel under AWGN, SSD and SSD + erasure 0.1; at [128, 10800,
   64] 64-QAM and 64-APSK ``ref`` / ``gray`` with Rayleigh; at [128,
   16200, 16] 16-QAM; at F = 5, N = 37 with q = 4, 16 and 256 (4-D); SNRs
   from 6 to 30 dB (costs up to O(10^4)).  Times K8, the plain version
   and, for 4-D, JAX's form (two ``torch.matmul`` against the table) in
   turns at [128, 8100, 256] (D = 2 and 4) and [128, 10800, 64] (APSK),
   beside the bound, with each route's live peak (``--only-3d``: phases
   1, 2 and 3d alone, no result line);
3e. bubble kernel (K9) against plain, both entries, bit for bit
   (``torch.equal``), both variants (8-bubble, L-bubble).  The bare
   ``ops/cuda_bubble.bubble_rows`` against ``ops/bubble_cn.
   bubble_rows_plain`` at the main paths' shapes with the real code's
   tables (layered [128·1350, 4, 256] with G = 1350, output saturation
   on; flooding [128·4050, 4, 256] with G = 4050, off), nm = 32,
   nbOper = 64, on continuous inputs (and "ties" at the layered shape),
   and at odd shapes with padding slots and ``valid`` (q = 16 / 64 / 256,
   dc = 3 / 4 / 5 / 6 / 12, nm = 1 and nm = q, nbOper < nm so that merges
   leave unfilled tails, a negative offset, where the saturation is not a
   no-op), on continuous and "ties" inputs; times it (both variants, and
   the 8-bubble with nbOper = 0: the lists and the dense write without a
   bubble step) and the plain version (8-bubble) in turns at the two main
   shapes beside the bound.  The fused super-layer step
   ``cuda_bubble.bubble_layer`` against ``bubble_layer_plain`` everywhere
   (frozen frames, untouched rows and the padding column and edge
   included) and against the pre-fusion route (torch gathers,
   normalisation, freeze and scatters around ``bubble_rows``) on the real
   columns and
   edges, on the real code's three layer plans at F = 128 and on odd
   random layers with padded slots (the odd shapes' settings), from
   decoder-like and "ties" states with about a quarter of the frames
   frozen; then timed at F = 128 in turns with the L-bubble, nbOper = 0,
   the old route and its plain version, beside its bound (``--only-3e``:
   phases 1, 2 and 3e alone, no result line);
3f. list kernel (K3, ``ops/cuda_list.list_layer``) against its plain
   version ``listcn.list_layer_plain``, bit for bit (``torch.equal``)
   everywhere but the padding column and edge, where the plain version
   scatters its padded slots and the kernel writes nothing (checked
   untouched), frozen frames untouched: on the real code's three layer
   plans at full width (F = 128, nm = 32, nbOper = 64; nm = 25, nbOper =
   24 on one plan), at f32 and bf16, from random compressed states
   ("decoder" and "ties": lists with repeated GF ids and unfilled tails)
   and from the states two plain steps of the decoder made, about a
   quarter of the frames frozen, and on one plan from a "flat" state
   (every value of a message ties: only the GF ids order the keys); on odd
   random layers with padded slots (``LIST_ODD``: q = 2 / 16 / 64 / 256,
   dc = 1 / 2 / 3 / 4 / 5 / 6 / 20 / 120, nm = 1..64, 33 the first past the
   32-key selection, nbOper from 1 to every candidate, a negative
   offset);
   times K3 and its plain version in turns at F = 128 on an f32 and a bf16
   state, beside each bound; first, the library's ``list_path`` refuses
   what the wrapper's ``limits_error`` refuses over a grid of shapes, and
   puts the bench row on the fast step and its exact mode on the fast
   step's exact form (``--only-3f``: phases 1, 2 and 3f alone, no result
   line; with ``--only-3g`` as well, 3f then 3g);
3g. K3's exact mode and general step against ``list_layer_plain`` as 3f:
   the exact merge (nbOper = 0, the fast step's exact form) on the real
   code's three layer plans at F = 128, nm = 32, f32 and bf16, from
   "decoder", "ties", "flat" and decoded states; the same plans at F = 4
   with nm = q (4l's settings, the general step's dense form) from
   "decoder", "ties" and decoded states, and with nm = 128 (its exact
   list form) from "decoder" states; odd padded layers
   (``LIST_GENERAL``: nm 1 to q = 256 on both merges, the exact form's
   edges nm = 33, 63 and 64, half the slots padded so that merges of
   neutral lists have fewer than nm GF ids below BIG (the tail), q = 2 to
   256, dc = 1 to 400, rows from the workspace at dc = 120 (exact) and
   dc = 400 (staircase), a negative offset); a decode from the workspace
   (20 rows of degree 34, nm = q, exact) under the device loop against the
   host loop (6's checks) and through K3 against its plain version; then
   timed at F = 128 beside the bound: the exact mode at nm = 32 in turns
   with its plain version on both dtypes, at nm = q on both dtypes and
   at nm = 128 on bf16 (the plain version does not fit: not timed), the
   staircase at nm = 65 (nbOper 64) and nm = 128 (nbOper 256) with its
   plain version, and the workspace form (a random layer of 20 rows of
   degree 34, nm = q, exact, f32) (``--only-3g``: phases 1, 2 and 3g
   alone, no result line);
3h. the decisions kernel (K4, ``ops/cuda_decide.decide_rows``) against
   ``decide_rows_plain`` bit for bit, on f32 and bf16 APPs, q = 4 to 256,
   at F = 5, N = 37 and F = 7, N = 8100 and at the cells' shapes
   (F = 1024 f32, F = 2048 bf16; N = 8100, q = 256), from decoder-like
   APPs with ties, NaNs, +inf and -0 beside +0, under masks of every
   frame (and none: the reset's form), no frame, one, ~30% and ~1%, with
   the launches and rows K4 counts on the card; then K4 timed at the
   cells' shapes with 100%, ~30% and ~1% of the frames active, the reset
   form, the plain version and ``torch.argmin`` alone, beside the bytes
   bound (``--only-3h``: phases 1, 2 and 3h alone, no result line; with
   ``--cells`` as well, each benchmark cell's pool through the program's
   batch step, with K4's launches and rows over it and the share of an
   all-frames pass it skipped);
3b / 3c / 3e at bf16: each fused entry (``spa_layer``, ``syndrome_layer``,
   ``bubble_layer`` with both variants) on a bf16 state against its bf16
   plain version, on the real code's three layer plans at F = 128 and on
   the odd padded layers of the f32 checks, from decoder-like and "ties"
   states rounded to bf16 and seeded with the sentinels 1e9 and 1e5 (as a
   bf16 state holds them) and saturated rows, about a quarter of the
   frames frozen: K7 and K9 bit for bit everywhere; K2 (f32 arithmetic
   that agrees with its plain version to f32 rounding only) within one
   bf16 ulp or 1e-3 where the plain cost is <= 8 and exp(-cost) within
   ``SPA_BF16_PROB_ATOL``, frozen frames, untouched rows and padding bit
   for bit, with the entries that differ counted; then each entry timed on
   the bf16 and the f32 state in turns at F = 128 beside both bounds
   (``--only-bf16``: phases 1, 2 and these alone, no result line);
4. EMS chain at full width: ``MonteCarlo``, F = 128, 256 frames, 2.0 dB,
   layered EMS nm = 32 with ``cn_impl="pallas"`` (one ``ems_rows`` call
   per super-layer), the default ``loop="device"`` (one captured graph
   per decode, ``decoder/device_loop``); checks that one loop (one
   capture) served the timed run, which made no eager launch, that the
   kernel counted on the card the loop's launches per step (3) times the
   decoder steps, that the generated codewords satisfy the syndrome,
   avg_it < 10 and FER <= 0.25;
5. EMS determinism: one batch of 16 frames decoded (host loop) with the
   kernel and with the plain torch CN (``plain``) gives identical
   decisions and iteration counts, K1 3 launches a step, none plain;
4b. SPA chain at full width (the SPA row of ``bench.py``): layered SPA,
   20 iterations, dense f32, 1.8 dB, F = 128, 256 frames, under the device
   loop and the host loop in turns (device, host, host, device, each loop
   with a MonteCarlo of its own); checks SPA kernel launches = 3 per step
   (counted on the card), all of them ``spa_layer``, the same counts under
   both loops, avg_it < 20, FER <= 0.25;
5b. SPA decode both ways: one batch of 16 frames through the kernel
   (``spa_layer``, 3 launches per step) and through the plain version (no
   launch): identical decisions and convergence, iteration counts within
   1 (differences printed);
4i. the SPA chain at dense bf16 (4b's settings with ``dtype="bfloat16"``,
   device loop): as 4b, with ``spa_layer`` = 3 a step counted on the card
   and none eager; then 6 at bf16 on 16 frames of its batch (the device
   loop against the host loop, and the kernel decode against the plain
   decode on the card: identical decisions and convergence, iterations
   within 1, the differing frames printed) and the device loop against
   the host loop at F = 128 with its memory; with ``--profile`` one traced
   batch, with ``spa_row_kernel``'s and K4's shares of the kernel
   time;
4c. list-EMS chain at full width (the EMS row of ``bench.py``): nm = 32,
   nbOper = 64, compressed bf16 CtoV, 10 iterations, 1.8 dB, F = 128, 256
   frames, device loop; checks 3 ``list_layer`` (K3) a step counted on the
   card, none eager, no other kernel, avg_it < 10, FER <= 0.25; then 6 on
   its first batch (``list_layer`` 3 a step) and 5l; with ``--profile``
   traces one batch: 3 ``list_kernel`` a step, K3's and K4's shares;
5l. list-EMS decode both ways (host loop), at full width: 16 frames of
   the chain's first batch through K3 and through ``list_layer_plain`` on
   the card (``plain``, no launch), at 4c's settings, with nbOper = 0 and
   with nm = 65 (the exact form and the general step), and 4 frames at
   4l's settings (nm = q, nbOper = 0: the general step's dense form):
   identical decisions, iterations and convergence (the differing frames
   printed), 3 ``list_layer`` a step on the kernel side;
4j. list-EMS chain with the exact merge: 4c's settings with nbOper = 0
   (the CLI's default), device loop; checks 3 ``list_layer`` a step counted
   on the card, none eager, no other kernel, avg_it < 10, FER <= 0.25;
4l. list-EMS chain with nothing truncated: 4c's settings with nm = q =
   256 and nbOper = 0 (exact min-sum in list form, the reference a user
   holds nm = 32 against), device loop; K3's general step (the dense
   merges) on every super-layer; checks 3 ``list_layer`` a step counted on
   the card, none eager, no other kernel, avg_it < 10, FER <= 0.25;
4k. the CLI's default decoder as a chain: layered EMS with nm = 0 under
   ``cn_impl="auto"`` (no truncation: K1's dense min-convolution, lists of
   256), 10 iterations, dense f32, 2.0 dB, F = 128, 256 frames, device
   loop; checks 3 ``ems_rows`` a step counted on the card, none eager, no
   other kernel, avg_it < 10, FER <= 0.25;
4d. flooding EMS chain at full width: ``schedule="flooding"``, nm = 32,
   offset 0.3, ``cn_impl="pallas"``, 20 iterations, dense f32, 2.0 dB,
   F = 128, 256 frames, device loop; checks EMS kernel launches = 1 per
   step (one call on all F·M = 518,400 rows), no SPA launch, avg_it < 20,
   FER <= 0.25;
4e. syndrome chain at full width: layered ``cn="syndrome"`` with the
   ``DecoderConfig`` defaults (nm = 0, i.e. 32; n_cv = 45; trapeze (40, 15,
   5) capped at 1000 configs, C = 993; bayes; presort; the k-th
   saturation), offset 0.3, 10 iterations, dense f32, 1.8 dB, F = 128, 256
   frames, device loop; checks syndrome kernel launches = 3 per step
   (counted on the card, none eager), all of them ``syndrome_layer``, no
   other kernel, avg_it < 10, FER <= 0.25;
5g. syndrome decode both ways (host loop): 16 frames through the kernel
   (3 ``syndrome_layer`` launches per step) and through its plain version
   (``plain``, no launch): identical decisions, iterations and
   convergence;
4f. QAM chain at full width: ``ChannelSpec(kind="qam", rayleigh=True,
   sigma_convention="snr")`` (256-QAM, ``ref`` labeling) at ``QAM_SNR``,
   layered SPA, 20 iterations, dense f32, F = 128, 256 frames, device
   loop; checks K8 once a batch (on the card and eager: generation is
   eager), 3 ``spa_layer`` a step, avg_it < 20, FER <= 0.25; with
   ``--profile`` traces one batch: one ``demap_kernel``, its share of the
   batch, and no torch op on an [F, N, q, 2] tensor;
4g. 4-D chain at full width: ``ChannelSpec(kind="qam256_4d", ssd=True,
   erasure_prob=0.1, sigma_convention="snr")`` (the reference's
   ``ModelChannel_AWGN_256QAM_4D``) at ``D4_SNR``, layered EMS nm = 32,
   offset 0.3, ``cn_impl="pallas"``, 10 iterations, F = 128, device loop;
   checks K8 once a batch, 3 ``ems_rows`` a step, avg_it < 10, FER <= 0.25;
5h. demapper both ways, after 4f and after 4g: 16 frames of the chain's
   first batch, one set of draws, through K8 and through its plain version
   on the card: equal intrinsics, and identical decisions, iterations and
   convergence from the two host-loop decodes;
4h. bubble chain at full width: layered EMS nm = 32, nbOper = 64,
   offset 0.3, ``cn_impl="bubble"`` (the 8-bubble of the C reference's
   buildable program), 10 iterations, dense f32, ``BUBBLE_DB``, F = 128,
   256 frames, device loop; checks 3 ``bubble_layer`` a step (counted on
   the card, none eager), no other kernel, avg_it < 10, FER <= 0.25; with
   ``--profile`` traces one batch: only the fused step's kernel, and less
   than 3% of the kernel time in torch's index kernels;
5j. bubble decode both ways (host loop), at full width: 16 frames of the
   chain's first batch (F cut from 128 for the plain side's sake) through
   K9 (3 ``bubble_layer`` launches a step) and through its plain version
   on the card
   (``plain``, no launch), both variants: identical decisions, iterations
   and convergence;
5k. against the C++ core (``native.decode_batch``, csrc/nbldpc_core.cpp
   built with g++, f64, no CtoV normalisation): the chain's first 32
   frames, the same intrinsics as f64: the share of frames decided
   identically, identical decisions on every frame both call converged,
   both FERs;
5i. small codes, card against CPU: random_regular(96, 48, 16) with 16-QAM
   and erasures 0.1 at 9 dB, random_regular(960, 480, 64) with 64-APSK
   and Rayleigh at 13 dB, 64 frames drawn on the card and copied to the
   CPU: the intrinsics of K8 on the card and of the plain version on the
   CPU, and the layered EMS decodes (K1 on the card), equal;
6. the device loop against the host loop at full width, after each chain
   on one batch of its intrinsics (F = 128): layered EMS through K1,
   layered SPA through ``spa_layer``, list-EMS through ``list_layer``,
   flooding EMS
   through K1 and flooding SPA through the bare K2 (on the flooding
   chain's batch), layered syndrome (through ``syndrome_layer``) and
   flooding syndrome (20 iterations, through the bare ``syndrome_rows``)
   on the syndrome chain's batch, and layered and flooding (20 iterations)
   8-bubble and L-bubble (layered through ``bubble_layer``, flooding
   through the bare ``bubble_rows``) on the bubble chain's.  A fresh loop decodes (its capture), then decodes
   again after every table cache was emptied and the freed memory
   refilled (the graph reads the tables its loop keeps), then the host
   loop: decisions, iterations and convergence bit-equal; at dense bf16
   (16 frames) also layered EMS through K1, flooding EMS through K1,
   layered syndrome and layered 8-bubble and L-bubble, each with the
   kernel decode against the plain decode (host loop: K1 against the
   plain torch CN, the others against their plain versions on the card)
   identical; the loop's
   launches per step 3, 3, 3, 1, 1, 3, 1, and 3, 3, 1, 1 (bubble); the
   replay makes no eager launch
   and the kernels count per step x steps on the card, as under the host
   loop; prints one decode's wall time under each loop, and the memory
   each loop's decode holds: its live peak and the allocator's reserved
   growth (the graph pool's reserved bytes apart);
5d. flooding EMS decode both ways (host loop): one batch of 16 frames
   through the kernel (launches = 1 per step) and through the plain torch
   CN (no launch): identical decisions, iterations and convergence;
5e. flooding SPA decode both ways: the same 16 frames through the SPA
   kernel's bare entry (launches = 1 per step) and through its plain
   version
   (``plain``): identical decisions and convergence, iteration counts
   within 1 (differences printed);
5f. every EMS / min-sum ``cn_impl`` through K1 on the card:
   random_regular(96, 48, 16), 64 frames at 1.5 dB, one set of
   intrinsics, decoded by flooding and layered ``cn="minsum"`` (nm = 0,
   the exact min-sum CN: K1's dense min-convolution), layered and flooding
   ``cn_impl="dense"`` (nm = 8: truncation, then lists of all q), layered
   ``"auto"`` at nm = 12 (> q/2: dense) and nm = 8 (top-k), flooding
   ``"auto"``, layered ``"topk"``, layered ``storage="compressed",
   cn_impl="topk"`` at f32 and bf16 (K1's bare entry), and flooding and
   layered ``cn="minsum", cn_impl="pallas"`` (nm = 8), each on the card
   and on the CPU (plain versions there; the compressed decoder at bf16
   against its plain route on the card, as torch's CPU and card bf16
   arithmetic round apart): identical decisions, iterations and
   convergence; K1 launches 1 per flooding step, 1 per super-layer;
6b. odd batches, F = 5, layered SPA and flooding EMS, each against the
   host loop as in 6: uniform random costs (no frame converges: the budget
   ends the loop, 20 steps) and the noiseless all-zero word (every frame
   converges at init: no step runs, no launch);
7. the CLI at full width: the code written as a UBS file with
   ``models/tools.write_ubs``, then ``cli.main`` with the SPA row's
   settings (``--cn spa --iters 20 --batch 128 --max-frames 256 --ebn0
   1.8``, defaults otherwise: device loop, on the card), with
   ``--cn syndrome --iters 10`` (the syndrome chain's), with the QAM
   chain's (``--channel qam --rayleigh --cn spa --iters 20`` at
   ``QAM_SNR``), with the bubble chain's (``--cn-impl bubble --nm 32
   --nboper 64 --iters 10`` at ``BUBBLE_DB``), with 4i's (``--dtype
   bfloat16 --cn spa --iters 20``), in the reference's positional form
   ``256 10 <file> 2.0 32 0.3 0`` (EMS nm = 32 through K1 under
   ``--cn-impl auto``), with ``--storage compressed --nm 32 --iters 10``
   at 1.8 dB and the default ``--nboper 0`` (K3's exact merge), and with
   ``--cn ems --iters 10`` at 2.0 dB and the defaults otherwise (nm = 0,
   ``--cn-impl auto``: K1's dense min-convolution), each against
   ``MonteCarlo.run`` of the same config and seed on ``load`` of that
   file: frames, frame errors, bit errors and iteration sum equal; the
   launches of each CLI run, counted by the kernels on the card, all of
   the one check-node kernel its decoder runs (K8 aside, on QAM).
8a. iteration-budget snapshots (``sim/snapshots.run_snapshots``) of one
   batch (F = 128) at the EMS chain's settings, budgets (2, 5, 10): frame
   and bit errors do not rise with the budget and equal at 10 those of the
   host-loop decode of ``MonteCarlo``'s batch 0; K1 (``ems_rows``) 3
   launches a step, eager; prints the wall time;
8b. decoder statistics (``decoder/stats.decode_flooding_stats``: flooding
   EMS, nm = 32, offset 0.3, ``cn_impl="pallas"``, 20 iterations) on that
   batch: the convergence trace and the iteration counts equal, step for
   step, the flooding host loop's on the same intrinsic; one K1 launch a
   step; the winner-rank histogram sums to F·M·q·(dc − 1) with its
   largest count at rank 0, equals the histogram of that loop's last VtoC
   on the card and, on its first 2 frames, on the CPU; prints the
   histogram pass's time and its live peak above its input;
8c. two-phase decoding (``sim/twophase.run_twophase``, ``phase_a_iters=3``)
   against ``MonteCarlo.run`` on 256 frames of the SPA row (4b) and the
   EMS chain (4), in turns single, two, two, single: the five counters
   equal, a two-phase run captures exactly two graphs and its timed
   repeat none, the kernel counts 3 launches a step on the card; prints
   frames/s of both routes beside the card's name and power limit (a
   measurement, not a claim);
8d. frame sharding (``parallel/mesh``): a world of 1 on NCCL
   (``make_mesh(1)``) over the SPA row, 256 frames: ``run_sharded``'s six
   counters equal the sum of ``shard=0`` single-process steps on the same
   batches, K2 3 launches a step; prints the machine's card count (one
   card cannot measure scaling; none is claimed).  ``--only-8``: phases
   1, 2 and 8a-8d alone, no result line.

Each chain runs once to warm up (under the device loop: its capture),
then once timed with the launch counts set to 0 just before and read just
after; both sides of 5d and 5e are counted the same way.  Two counts are
kept: the wrappers' eager launches (``cuda_cn.launches``,
``cuda_spa.launches``, ``cuda_syndrome.launches``, ``cuda_demap.launches``,
``cuda_bubble.launches``, ``cuda_list.launches``)
and the launches each
kernel counts itself on the
card (``device_launches()``), which a graph's replays move too; a
host-loop run must show the same numbers in both.  After its timed run
each chain times two more batches untraced (``batch_split``): each
batch's host wall time, and its device time from CUDA events around gen,
decode and count with the batch queued behind a spin kernel; the card's
idle share is 1 - device time / wall.  Memory:
the allocator's live peak and its reserved peak (the graph pool, which
holds the replays' temporaries, inside the latter).  The last four lines
are a compact JSON record of each chain's timed runs (and its profile with
``--profile``, which traces a device-loop batch, counts its kernels
against the loop's launches per step times the batch's steps, and fails
the run if the EMS or flooding-EMS trace holds a ``torch.topk`` kernel,
or the SPA trace a kernel other than the fused SPA step's or none, or the
syndrome or bubble trace a kernel of its CN other than the fused step's,
none, or more than 3% of its kernel time in torch's index kernels),
the card's name and power limit, the kernels' JSON record (for each
kernel the paths it launched in and its launches in each, its per-call
times at the layered and flooding shapes, or for K8 at the 2-D, 4-D and
64-APSK shapes, for K9 the fused step at F = 128 (both variants, its old
route) and the bare entry at the layered and flooding shapes, beside its
plain version's and its bound; for K2, K7 and K9 the ``bf16_*`` fields of
the fused entry on a bf16 state; for K1 the ``dense_*`` fields of its
dense min-convolution at the layered shape (``dense_floor_ms``: its issue
floor) and ``ws_*`` from the workspace; for K3 the ``exact_*``,
``exact_nmq_*``, ``exact128_*``, ``stair65_*``, ``stair128_*`` and
``ws34_*`` fields of 3g beside ``list_layer`` at
F = 128 on the bf16 state of the bench row, and ``f32_*`` on an f32
one), and ``{"ok": true, "device": {...}}``.  The run prints its time.
No JAX is imported.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ems_nbldpc_torch import cli, native
from ems_nbldpc_torch.decoder import device_loop
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.flooding import (_cn_row_tables,
                                               _syndrome_tables, _vn_totals,
                                               decode_flooding_hostloop,
                                               make_flooding_stepper,
                                               syn_key, syndrome_ok)
from ems_nbldpc_torch.decoder.graph import (DeviceGraph, clear_tables,
                                            rotation_table, upload)
from ems_nbldpc_torch.decoder.layered import (_layer_plan,
                                              decode_layered_compressed,
                                              decode_layered_hostloop,
                                              decode_layered_list_hostloop,
                                              make_layered_list_stepper)
from ems_nbldpc_torch.decoder.stats import (decode_flooding_stats,
                                            hist_chunk,
                                            winner_rank_histogram)
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models import channels, tools
from ems_nbldpc_torch.models.channels import ChannelSpec
from ems_nbldpc_torch.models.code import from_parsed, load, random_regular
from ems_nbldpc_torch.models.encoder import gaussian_elimination
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import (cuda_bubble, cuda_cn, cuda_decide,
                                  cuda_demap, cuda_list, cuda_spa,
                                  cuda_syndrome, listcn)
from ems_nbldpc_torch.ops.bubble_cn import bubble_rows_plain
from ems_nbldpc_torch.ops.fht import (position_tables, spa_checknode_plain,
                                      transpose_perm_tables)
from ems_nbldpc_torch.ops.cuda_spa import spa_layer, spa_layer_plain
from ems_nbldpc_torch.ops.minconv import (ems_input_truncate,
                                          ems_output_saturate,
                                          fb_checknode_topk, mask_invalid)
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig, batch_generators
from ems_nbldpc_torch.sim.snapshots import run_snapshots
from ems_nbldpc_torch.sim.sweep import result_filename
from ems_nbldpc_torch.sim.twophase import run_twophase

SLICE_ROWS = 1350          # rows per super-layer of the full-width code
CODE_ROWS = 4050           # rows of the full-width code (one flooding call)
KERNEL_SHAPES = [          # (T, dc, q, nm) of the bare fb_checknode; the
    (16 * SLICE_ROWS, 4, 256, 32),      # first four are the main paths'
    (128 * SLICE_ROWS, 4, 256, 32),     # (layered 5 and 4, then flooding
    (16 * CODE_ROWS, 4, 256, 32),       # 5d and 4d)
    (128 * CODE_ROWS, 4, 256, 32),
    (1000, 3, 16, 5),
    (333, 5, 64, 12),
    (77, 12, 256, 32),
]
ROWS_ODD = [               # (T, G, dc, q, nm, truncate) of ems_rows beside
    (1000, 50, 3, 16, 5, True),         # the main paths' shapes; all with
    (333, 111, 5, 64, 12, True),        # padding slots and valid
    (77, 11, 12, 256, 32, True),
    (90, 9, 12, 16, 16, False),
    (96, 8, 6, 128, 128, True),
    (400, 20, 4, 256, 32, False),
]
KINDS = ("uniform", "ties")
OFFSET = 0.3
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12   # H100 SXM: HBM3, f32 outside
#                                           the tensor cores
SPA_SHAPES = [             # (T, G, dc, q, padding); the first three are the
    (16 * SLICE_ROWS, SLICE_ROWS, 4, 256, False),   # main paths' (layered 5b
    (128 * SLICE_ROWS, SLICE_ROWS, 4, 256, False),  # and 4b, flooding 5e),
    (16 * CODE_ROWS, CODE_ROWS, 4, 256, False),     # all timed
    (1000, 250, 3, 16, False),
    (333, 111, 5, 64, True),
    (77, 11, 12, 256, True),
]
SPA_KINDS = ("decoder", "uniform")
SPA_LAYER_ODD = [          # (F, G, dc, q, padded slots) of spa_layer on
    (8, 250, 3, 16, 5),                 # random layer tables
    (6, 111, 5, 64, 7),
    (4, 11, 12, 256, 4),
    (16, 9, 12, 16, 4),
    (5, 50, 2, 4, 3),
    (3, 40, 6, 128, 6),
    (7, 30, 4, 32, 2),
]
SPA_COST_ATOL, SPA_COST_MAX, SPA_PROB_ATOL = 1e-3, 8.0, 1e-5
SYN_ODD = [                # (T, G, dc, q, nm, table settings, bayes,
    # presort) of syndrome_rows beside the main paths' shapes; all with
    # padding slots and valid
    (1000, 50, 3, 16, 16, dict(shape="full", d1=8, d2=4, d3=2), True, True),
    (333, 111, 6, 64, 12, dict(n_cv=20, shape="bordered", d1=9, d2=4),
     False, True),
    (90, 9, 12, 16, 8, dict(shape="2dev", d1=7, sat_rule="median"), True,
     False),
    (96, 8, 6, 64, 64, dict(sat_rule="median"), False, False),
    (400, 20, 4, 256, 32, dict(), True, False),
    (77, 11, 12, 256, 32, dict(shape="bordered", d1=31, d2=15), True, True),
]
DEMAP_CASES = [            # (F, N, q, kind, modifiers, SNR dB) of 3d
    *[(128, 8100, 256, "qam", dict(lab, **mod), snr)
      for lab in (dict(), dict(labeling="gray"), dict(labeling="v2"),
                  dict(rotated=True))
      for mod, snr in ((dict(), 30.0), (dict(rayleigh=True), 18.0),
                       (dict(ssd=True), 12.0), (dict(erasure_prob=0.1), 30.0),
                       (dict(rayleigh=True, erasure_prob=0.1), 18.0))],
    (128, 8100, 256, "qam256_4d", dict(), 30.0),
    (128, 8100, 256, "qam256_4d", dict(ssd=True), 12.0),
    (128, 8100, 256, "qam256_4d", dict(ssd=True, erasure_prob=0.1), 12.0),
    (128, 10800, 64, "qam", dict(rayleigh=True), 14.0),
    (128, 10800, 64, "apsk64", dict(rayleigh=True), 14.0),
    (128, 10800, 64, "apsk64", dict(rayleigh=True, labeling="gray"), 30.0),
    (128, 16200, 16, "qam", dict(), 8.0),
    (128, 16200, 16, "qam", dict(rayleigh=True, erasure_prob=0.1), 30.0),
    (5, 37, 4, "qam", dict(erasure_prob=0.1), 6.0),
    (5, 37, 16, "qam", dict(ssd=True), 30.0),
    (5, 37, 256, "qam256_4d", dict(ssd=True, erasure_prob=0.1), 30.0),
]
DEMAP_TIMED = {            # label -> (F, N, q, kind, modifiers, SNR dB)
    "2-D": (128, 8100, 256, "qam", dict(rayleigh=True), 18.0),
    "4-D": (128, 8100, 256, "qam256_4d", dict(ssd=True, erasure_prob=0.1),
            12.0),
    "APSK": (128, 10800, 64, "apsk64", dict(rayleigh=True), 14.0),
}
DEMAP_RTOL = 1e-6          # K8 vs plain, relative to the largest cost
QAM_SPEC = ChannelSpec(kind="qam", rayleigh=True, sigma_convention="snr")
QAM_SNR = 17.0             # dB (Es/N0) of 4f, 5h and 7; see PERF.md §4
D4_SPEC = ChannelSpec(kind="qam256_4d", ssd=True, erasure_prob=0.1,
                      sigma_convention="snr")
D4_SNR = 12.0              # dB of 4g and 5h; see PERF.md §4
BUBBLE_ODD = [             # (T, G, dc, q, nm, nbOper, truncate, offset) of
    # bubble_rows beside the main paths' shapes; all with padding slots
    (1000, 50, 3, 16, 8, 12, True, OFFSET),
    (333, 111, 6, 64, 12, 24, True, OFFSET),
    (400, 20, 4, 256, 32, 64, True, OFFSET),
    (90, 9, 6, 16, 16, 40, False, OFFSET),      # nm = q
    (200, 20, 4, 16, 1, 4, True, OFFSET),       # nm = 1
    (150, 15, 5, 64, 16, 8, True, OFFSET),      # nbOper < nm: tails
    (77, 11, 12, 256, 32, 64, True, OFFSET),
    (120, 12, 4, 64, 12, 24, True, -0.2),       # saturation bites
]
BUBBLE_NM, BUBBLE_OPS = 32, 64
BUBBLE_DB = 2.0            # dB of 4h, 5j, 5k, 6 and 7; see PERF.md §4
LAYERS = 3
EMS_DEC = DecoderConfig(max_iters=10, schedule="layered", cn="ems", nm=32,
                        offset=0.3, cn_impl="pallas", storage="dense",
                        dtype="float32")      # the EMS chain's (4), at 2.0 dB
SPA_DEC = DecoderConfig(max_iters=20, schedule="layered", cn="spa", nm=0,
                        storage="dense", dtype="float32")  # 4b's, at 1.8 dB
DECIDE_ODD = [(5, 37), (7, 8100)]      # (F, N) of 3h's bit-exact cases
DECIDE_QS = (4, 8, 16, 32, 64, 128, 256)
DECIDE_TIMED = {           # APP dtype -> F at N = 8100, q = 256: the SPA
    "f32": (1024, torch.float32),      # cells' and the list cell's
    "bf16": (2048, torch.bfloat16)}
DECIDE_SHARES = (1.0, 0.3, 0.01)       # active frames of 3h's timings
DECIDE_CELLS = ("spa_row.1p8dB", "list_ems_row.1p8dB", "spa_row.3p0dB")
SUMMARY = {}               # chain -> its timed run's numbers, printed last
DEMAP_PATHS = {}           # chain -> K8 launches in its timed run


def kernel_input(t, dc, q, nm, kind, seed):
    """Rows as the decoder hands them to the bare CN: seeded, then
    truncated to each message's nm best.  "ties" draws integer levels 0..5,
    so equal values are common inside and at the edge of every nm-best
    list."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, (t, dc, q)).astype(np.float32)
    else:
        v = rng.random((t, dc, q), dtype=np.float32) * 9
    return ems_input_truncate(torch.as_tensor(v, device="cuda"), nm).contiguous()


def rows_input(t, dc, q, kind, seed):
    """Unrotated min-normalised rows, as the decoders hand them to
    ``ems_rows``, made on the card from ``seed`` ("ties": levels 0..5)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if kind == "ties":
        v = torch.randint(0, 6, (t, dc, q), generator=gen, device="cuda"
                          ).float()
    else:
        v = 9 * torch.rand((t, dc, q), generator=gen, device="cuda")
    return v - v.min(dim=-1, keepdim=True).values


def odd_tables(g, dc, q, seed):
    """uint8 rotation tables [G, dc, q] and valid [G, dc] for random
    coefficients with a few padding slots (coefficient 0)."""
    rng = np.random.default_rng(seed)
    coefs = rng.integers(1, q, (g, dc))
    coefs[0, -1] = 0
    coefs[rng.integers(0, g, 3), rng.integers(0, dc, 3)] = 0
    gf = get_gf(q)
    tabs = [torch.as_tensor(rotation_table(coefs, gf, d).reshape(g, dc, q)
                            .astype(np.uint8), device="cuda")
            for d in ("in", "out")]
    return tabs[0], tabs[1], torch.as_tensor(coefs != 0, device="cuda")


def old_route(x, rin, rout, valid, nm, offset, truncate):
    """The route before the fused kernel: torch truncation, rotations,
    mask, saturation and normalisation around the bare kernel."""
    t, dc, q = x.shape
    g = rin.shape[0]
    v = x.reshape(t // g, g, dc, q)
    if truncate:
        v = ems_input_truncate(v, nm)
    v = mask_invalid(torch.gather(v, -1, rin.expand_as(v)), valid)
    out = cuda_cn.fb_checknode(v.reshape(t, dc, q), nm).reshape(v.shape)
    out = torch.gather(out, -1, rout.expand_as(out))
    if truncate:
        out = ems_output_saturate(out, nm, offset)
    return (out - out.min(dim=-1, keepdim=True).values).reshape(t, dc, q)


def ems_bound_ms(t, g, dc, q, nm):
    """The least time of one ``ems_rows`` call on an H100: its bytes (rows
    in and out once, the uint8 tables once) at 3.35 TB/s against its
    candidates (one f32 add and one min each, 3 (dc - 2) merges of nm x q
    per row) at 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    nbytes = 2 * 4 * t * dc * q + 2 * g * dc * q
    ops = 2 * t * 3 * (dc - 2) * nm * q
    return bound(nbytes, ops)


def bound(nbytes, ops):
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase(name):
    print(f"== {name}", flush=True)


def check(ok, what):
    """Fail the run (non-zero exit, no ok line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi failed")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(graph):
    """3: the EMS kernel against its plain versions; returns the largest
    error (0 when bit-exact) and {(path, T): times} at the main shapes."""
    phase("3 EMS kernel against plain")
    worst = 0.0
    for i, (t, dc, q, nm) in enumerate(KERNEL_SHAPES):
        for kind in KINDS:
            vr = kernel_input(t, dc, q, nm, kind, seed=100 + i)
            got = cuda_cn.fb_checknode(vr, nm)
            want = fb_checknode_topk(vr, nm)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = torch.equal(got, want)
            print(f"fb_checknode T={t} dc={dc} q={q} nm={nm} {kind}: "
                  f"bit-exact={exact} max_abs_err={err}", flush=True)
            check(exact, f"kernel != plain at {(t, dc, q, nm)} {kind}")
            worst = max(worst, err)
            del vr, got, want
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    main = {"layered": (layer["rot_in8"], layer["rot_out8"], layer["valid"]),
            "flooding": (rows["rot_in"], rows["rot_out"], rows["valid"])}
    cases = [(path, f * main[path][0].shape[0], *main[path], 32, True)
             for path in ("layered", "flooding") for f in (16, 128)]
    for i, (t, g, dc, q, nm, truncate) in enumerate(ROWS_ODD):
        cases.append(("odd", t, *odd_tables(g, dc, q, seed=i), nm, truncate))
    for i, (path, t, rin, rout, valid, nm, truncate) in enumerate(cases):
        for kind in KINDS:
            _, dc, q = rin.shape
            x = rows_input(t, dc, q, kind, seed=300 + i)
            got = cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET, truncate)
            want = cuda_cn.ems_rows_plain(x, rin, rout, valid, nm, OFFSET,
                                          truncate)
            old = old_route(x, rin.long(), rout.long(), valid, nm, OFFSET,
                            truncate)
            torch.cuda.synchronize()
            err = max(float((got - want).abs().max()),
                      float((old - want).abs().max()))
            exact = torch.equal(got, want) and torch.equal(old, want)
            pad = 0 if valid is None else int((~valid).sum())
            print(f"ems_rows {path} T={t} G={rin.shape[0]} dc={dc} q={q} "
                  f"nm={nm} truncate={truncate} padding slots={pad} {kind}: "
                  f"bit-exact={exact} (old route too) max_abs_err={err}",
                  flush=True)
            check(exact, f"ems_rows != plain at {path} T={t} {kind}")
            worst = max(worst, err)
            del x, got, want, old
    times = {}
    for path, t, rin, rout, valid, nm, truncate in cases[:4]:
        x = rows_input(t, 4, 256, "uniform", seed=7)
        rin64, rout64 = rin.long(), rout.long()
        vr = kernel_input(t, 4, 256, nm, "uniform", seed=7)
        fns = {
            "fused": lambda: cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET,
                                              truncate),
            "old": lambda: old_route(x, rin64, rout64, valid, nm, OFFSET,
                                     truncate),
            "plain": lambda: cuda_cn.ems_rows_plain(x, rin, rout, valid, nm,
                                                    OFFSET, truncate),
            "bare": lambda: cuda_cn.fb_checknode(vr, nm),
        }
        reps = {"fused": 10, "bare": 10, "old": 3, "plain": 3}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "old", "fused", "bare", "bare", "fused", "old",
                     "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        g = rin.shape[0]
        b_ms, b_by = ems_bound_ms(t, g, 4, 256, nm)
        times[(path, t)] = dict(
            {k: sum(v) / 2 for k, v in got.items()}, bound=b_ms, bound_by=b_by)
        print(f"{path} T={t} G={g} dc=4 q=256 nm={nm}: fused "
              + " / ".join(f"{v:.4f}" for v in got["fused"])
              + " ms, old route " + " / ".join(f"{v:.4f}" for v in got["old"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + " ms, bare kernel "
              + " / ".join(f"{v:.4f}" for v in got["bare"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
              f"{100 * b_ms / times[(path, t)]['fused']:.2f}% of it",
              flush=True)
        del x, vr, rin64, rout64
    return worst, times


def spa_input(t, g, dc, q, kind, padding, seed):
    """(mvc [T, dc, q], coefs [G, dc] int32) on the card, from ``seed``.
    "decoder": each message has one low-cost symbol (0..1) and the rest
    2..40, as a decoder's extrinsics; "uniform": costs 0..9."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (t, dc, q)
    if kind == "decoder":
        mvc = 2 + 38 * torch.rand(shape, generator=gen, device="cuda")
        best = torch.randint(0, q, (t, dc, 1), generator=gen, device="cuda")
        low = torch.rand((t, dc, 1), generator=gen, device="cuda")
        mvc.scatter_(-1, best, low)
    else:
        mvc = 9 * torch.rand(shape, generator=gen, device="cuda")
    lo = 0 if padding else 1
    coefs = torch.randint(lo, q, (g, dc), generator=gen, device="cuda",
                          dtype=torch.int32)
    if padding:
        coefs[0, -1] = 0
    return mvc, coefs


def spa_tables(q):
    return tuple(torch.as_tensor(x, device="cuda")
                 for x in transpose_perm_tables(get_gf(q)))


def spa_state(f, n1, e1, q, cols, edges, seed):
    """A decoder-like layered state on the card, from ``seed``: CtoV
    [F, e1, q] 0..10 and APP [F, n1, q] = X + CtoV on the layer's slots
    (``cols``, ``edges``), X with one low-cost symbol (0..1) per column
    and the rest 2..40, so that APP - CtoV is a decoder's extrinsic (a
    decoder's APP holds the CtoV it subtracts); the padding column and
    edge (the last) 0; active [F] with about a quarter of the frames frozen
    (the first active, the last frozen)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    app = 2 + 38 * torch.rand((f, n1, q), generator=gen, device="cuda")
    best = torch.randint(0, q, (f, n1, 1), generator=gen, device="cuda")
    app.scatter_(-1, best, torch.rand((f, n1, 1), generator=gen,
                                      device="cuda"))
    ctov = 10 * torch.rand((f, e1, q), generator=gen, device="cuda")
    app[:, -1] = 0
    ctov[:, -1] = 0
    cols, edges = cols.long(), edges.long()
    app[:, cols] += ctov[:, edges]
    active = torch.rand(f, generator=gen, device="cuda") >= 0.25
    active[0], active[-1] = True, False
    return app, ctov, active


def odd_layer(g, dc, q, pads, seed):
    """Random layer tables (cols, edges, coefs [G, dc] int32 on the card)
    over N = G dc + 7 columns and E = G dc + 5 edges, ``pads`` slots
    padded (column N, edge E, coefficient 0); returns them with N + 1 and
    E + 1."""
    rng = np.random.default_rng(seed)
    n, e = g * dc + 7, g * dc + 5
    cols = rng.permutation(n)[:g * dc].reshape(g, dc)
    edges = rng.permutation(e)[:g * dc].reshape(g, dc)
    coefs = rng.integers(1, q, (g, dc))
    slots = rng.choice(g * dc, pads, replace=False)
    cols.flat[slots], edges.flat[slots], coefs.flat[slots] = n, e, 0
    up = [torch.as_tensor(x.astype(np.int32), device="cuda")
          for x in (cols, edges, coefs)]
    return (*up, n + 1, e + 1)


def spa_old_route(app, ctov, active, cols, edges, coefs, t_tab, tinv_tab):
    """The layered SPA super-layer before the fused kernel: torch gathers,
    normalisations, freeze and scatters around the bare kernel."""
    act = active[:, None, None, None]
    app_rows = app[:, cols]
    ctov_rows = ctov[:, edges]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = cuda_spa.spa_checknode(mvc.reshape(f * g, dc, q), coefs, t_tab,
                                 tinv_tab).reshape(mvc.shape)
    mcv = mcv - mcv.min(dim=-1, keepdim=True).values
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, edges] = mcv
    app[:, cols] = new_app


def spa_layer_bound_ms(f_active, g, dc, q, elem=4):
    """The least time of one ``spa_layer`` call on an H100: the APP and
    CtoV rows of the active frames read once and written once (``elem``
    bytes an element: 4 for an f32 state, 2 for bf16), the index tables and
    transform tables once, at 3.35 TB/s, against two log2(q) stage
    transforms and ~7 more operations (sub, exp, products, log, add) a
    symbol at 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    sym = f_active * g * dc * q
    nbytes = 4 * elem * sym + 3 * 4 * g * dc + 2 * q * q
    return bound(nbytes, sym * (2 * int(np.log2(q)) + 7))


def check_layer_case(label, state, tables, old=False):
    """One ``spa_layer`` call against ``spa_layer_plain`` (and, with
    ``old``, the pre-fusion route) on clones of ``state``; checks the
    stated tolerances and bit-equality where nothing may change; returns
    the cost error where the plain cost is <= SPA_COST_MAX."""
    app, ctov, active = state
    cols, edges, coefs, t_tab, tinv_tab = tables
    runs = {"fused": spa_layer, "plain": spa_layer_plain}
    if old:
        runs["old"] = lambda *a: spa_old_route(*a[:3], cols.long(),
                                               edges.long(), *a[5:])
    out = {}
    for name, fn in runs.items():
        a, c = app.clone(), ctov.clone()
        fn(a, c, active, cols, edges, coefs, t_tab, tinv_tab)
        out[name] = (a, c)
    torch.cuda.synchronize()
    real = coefs != 0
    cols_r, edges_r = cols[real].long(), edges[real].long()
    touched_c = torch.zeros(app.shape[1], dtype=torch.bool, device="cuda")
    touched_e = torch.zeros(ctov.shape[1], dtype=torch.bool, device="cuda")
    touched_c[cols_r], touched_e[edges_r] = True, True
    frozen = ~active
    _, c_p = out["plain"]
    want = c_p[active][:, edges_r]
    likely = want <= SPA_COST_MAX
    worst, line, ok = 0.0, [], True
    for name in runs:
        if name == "plain":
            continue
        a, c = out[name]
        same = (torch.equal(a[frozen], app[frozen])
                and torch.equal(c[frozen], ctov[frozen])
                and torch.equal(a[:, ~touched_c], app[:, ~touched_c])
                and torch.equal(c[:, ~touched_e], ctov[:, ~touched_e]))
        got = c[active][:, edges_r]
        diff = (got - want).abs()
        cost_err = float(diff[likely].max()) if bool(likely.any()) else 0.0
        prob_err = float((torch.exp(-got) - torch.exp(-want)).abs().max())
        app_err = float((a[active][:, cols_r] - out["plain"][0][active][
            :, cols_r]).abs()[likely].max()) if bool(likely.any()) else 0.0
        finite = bool(torch.isfinite(a).all() and torch.isfinite(c).all())
        line.append(f"{name}: cost err where plain <= 8 {cost_err:.3e}, "
                    f"exp(-cost) err {prob_err:.3e}, APP err {app_err:.3e}, "
                    f"frozen/untouched/padding bit-equal={same}")
        ok = ok and (finite and same and cost_err <= SPA_COST_ATOL
                     and prob_err <= SPA_PROB_ATOL
                     and app_err <= SPA_COST_ATOL)
        worst = max(worst, cost_err)
    f, g, dc, q = app.shape[0], *cols.shape, app.shape[2]
    pad = int((~real).sum())
    print(f"spa_layer {label} F={f} G={g} dc={dc} q={q} frozen "
          f"{int(frozen.sum())} padding slots={pad}: " + "; ".join(line),
          flush=True)
    check(ok, f"spa_layer != plain at {label}")
    return worst


def check_spa_layer(graph):
    """3b, the fused entry: ``spa_layer`` against ``spa_layer_plain`` on
    the real code's layer plans and on odd random tables; then the timings.
    Returns (largest cost error, {F: times})."""
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1 = code.n + 1, graph.n_edges + 1
    for f in (16, 128):
        for k, p in enumerate(plans):
            state = spa_state(f, n1, e1, code.q, p["cols"], p["edge_ids"],
                              seed=400 + f + k)
            worst = max(worst, check_layer_case(
                f"layer {k}", state,
                (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
                 p["tinv_tab"]), old=True))
            del state
    for i, (f, g, dc, q, pads) in enumerate(SPA_LAYER_ODD):
        cols, edges, coefs, n1o, e1o = odd_layer(g, dc, q, pads, seed=500 + i)
        state = spa_state(f, n1o, e1o, q, cols, edges, seed=600 + i)
        worst = max(worst, check_layer_case(
            "odd", state, (cols, edges, coefs, *spa_tables(q)), old=True))
    times = {}
    p = plans[0]
    tables = (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
              p["tinv_tab"])
    cols64, edges64 = p["cols"], p["edge_ids"]
    g, dc = p["cols32"].shape
    q = code.q
    for f in (16, 128):
        app, ctov, _ = spa_state(f, n1, e1, q, cols64, edges64, seed=7)
        active = torch.ones(f, dtype=torch.bool, device="cuda")
        copies = {k: (app.clone(), ctov.clone()) for k in ("fused", "old",
                                                          "plain")}
        mvc = app[:, cols64] - ctov[:, edges64]
        mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, dc, q)
        fns = {
            "fused": lambda: spa_layer(*copies["fused"], active, *tables),
            "old": lambda: spa_old_route(*copies["old"], active, cols64,
                                         edges64, *tables[2:]),
            "plain": lambda: spa_layer_plain(*copies["plain"], active,
                                             *tables),
            "bare": lambda: cuda_spa.spa_checknode(mvc, *tables[2:]),
        }
        reps = {"fused": 10, "bare": 10, "old": 3, "plain": 3}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "old", "fused", "bare", "bare", "fused", "old",
                     "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        b_ms, b_by = spa_layer_bound_ms(f, g, dc, q)
        fused = sum(got["fused"]) / 2
        times[f] = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                        bound_by=b_by)
        print(f"spa_layer F={f} G={g} dc={dc} q={q}: fused "
              + " / ".join(f"{v:.4f}" for v in got["fused"])
              + " ms, old route " + " / ".join(f"{v:.4f}" for v in got["old"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + " ms, bare kernel "
              + " / ".join(f"{v:.4f}" for v in got["bare"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
              f"{100 * b_ms / fused:.2f}% of it", flush=True)
        del app, ctov, copies, mvc, fns
        torch.cuda.empty_cache()
    return worst, times


def check_spa_kernel(graph):
    """3b: the SPA kernel's two entries against their plain versions;
    returns the largest cost error in the stated scope, {T: (bare kernel
    ms, plain ms, bound ms, bound by)} per call at the bare entry's main
    shapes, and the fused entry's {F: times}."""
    phase("3b SPA kernel against plain")
    worst = 0.0
    for i, (t, g, dc, q, padding) in enumerate(SPA_SHAPES):
        t_tab, tinv_tab = spa_tables(q)
        for kind in SPA_KINDS:
            mvc, coefs = spa_input(t, g, dc, q, kind, padding, seed=200 + i)
            got = cuda_spa.spa_checknode(mvc, coefs, t_tab, tinv_tab)
            t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
            want = spa_checknode_plain(mvc.reshape(t // g, g, dc, q), t_in,
                                       t_out).reshape(t, dc, q)
            torch.cuda.synchronize()
            pad = (coefs == 0).repeat(t // g, 1)          # [T, dc]
            real = ~pad
            diff = torch.where(real[..., None], (got - want).abs(), 0.0)
            bands = {c: float(diff.masked_fill(want > c, 0).max())
                     for c in (4.0, SPA_COST_MAX, 12.0, 1e9)}
            cost_err = bands[SPA_COST_MAX]
            prob_err = float((torch.exp(-got) - torch.exp(-want)).abs()
                             [real].max())
            pad_ok = bool((got[pad] == 0).all() and (want[pad] == 0).all())
            finite = bool(torch.isfinite(got).all())
            print(f"spa_checknode T={t} G={g} dc={dc} q={q} {kind}: cost "
                  f"err where plain "
                  f"<= 4 / 8 / 12 / any: " + " / ".join(
                      f"{v:.3e}" for v in bands.values())
                  + f"; exp(-cost) err {prob_err:.3e}; padding lanes "
                  f"{int(pad.sum())} zero={pad_ok}; finite={finite}",
                  flush=True)
            check(finite and pad_ok and cost_err <= SPA_COST_ATOL
                  and prob_err <= SPA_PROB_ATOL,
                  f"SPA kernel != plain at {(t, g, dc, q)} {kind}")
            worst = max(worst, cost_err)
            del mvc, got, want, diff, t_in, t_out
    times = {}
    for t, g, dc, q, padding in SPA_SHAPES[:3]:
        t_tab, tinv_tab = spa_tables(q)
        mvc, coefs = spa_input(t, g, dc, q, "decoder", padding, seed=7)
        t_in, t_out = position_tables(coefs, t_tab, tinv_tab)
        mvc4 = mvc.reshape(t // g, g, dc, q)

        def kern():
            return cuda_spa.spa_checknode(mvc, coefs, t_tab, tinv_tab)

        def plain():
            return spa_checknode_plain(mvc4, t_in, t_out)

        # plain, kernel, kernel, plain: compare within one call only
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 10)
        k2 = time_ms(kern, 10)
        p2 = time_ms(plain, 3)
        # bytes: rows in and out, the coefficients and both tables once;
        # operations: two log2(q)-stage transforms per message and ~4 more
        # per element (exp, log, product, normalisation)
        b_ms, b_by = bound(
            8 * mvc.numel() + 4 * coefs.numel() + t_tab.nbytes
            + tinv_tab.nbytes, t * dc * q * (2 * int(np.log2(q)) + 4))
        times[t] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by)
        print(f"spa_checknode F={t // g} T={t} G={g} dc={dc} q={q}: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per "
              f"call; bound {b_ms:.4f} ms ({b_by})", flush=True)
        del mvc, mvc4, t_in, t_out
    layer_err, layer_times = check_spa_layer(graph)
    return max(worst, layer_err), times, layer_times


def syn_ops(t, dc, q, table):
    """The operations one row batch of the syndrome CN needs with these
    tables: the config sums and XORs (C dc each), and per edge position
    about six integer steps per deviation-free config (its key, bucket
    minimum, saturation count, second minimum) and ten per bucket (bayes,
    key, rank), plus the rotations (2 dc q)."""
    c = table.shape[0]
    masked = int((table == 0).sum())
    return t * (2 * c * dc + 6 * masked + 10 * dc * q + 2 * dc * q)


def syn_bound_ms(t, g, dc, q, table):
    """The least time of one ``syndrome_rows`` call on an H100: its bytes
    (rows in and out once, the uint8 rotation tables, valid, the config
    table and its position lists once) at 3.35 TB/s against ``syn_ops`` at
    67 T/s.  Returns (ms, "bytes" or "operations")."""
    c = table.shape[0]
    masked = int((table == 0).sum())
    nbytes = (2 * 4 * t * dc * q + 2 * g * dc * q + g * dc + c * dc + 4 * dc
              + 2 * masked + 4 * (dc + 1))
    return bound(nbytes, syn_ops(t, dc, q, table))


def syn_layer_bound_ms(f_active, g, dc, q, table, elem=4):
    """The least time of one ``syndrome_layer`` call on an H100: the APP
    and CtoV rows of the active frames read once and written once
    (``elem`` bytes an element), the
    layer's index, rotation and valid tables and the CN's tables once, at
    3.35 TB/s, against ``syn_ops`` and the step's own four operations a
    symbol (extrinsic, its min and normalisation, APP sum) at 67 T/s.
    Returns (ms, "bytes" or "operations")."""
    t = f_active * g
    c = table.shape[0]
    masked = int((table == 0).sum())
    nbytes = (4 * elem * t * dc * q + 2 * 4 * g * dc + 2 * g * dc * q
              + g * dc + c * dc + 4 * dc + 2 * masked + 4 * (dc + 1))
    return bound(nbytes, syn_ops(t, dc, q, table) + 4 * t * dc * q)


def syn_state(f, n1, e1, q, cols, edges, kind, seed):
    """A layered state for ``syndrome_layer``: "decoder" as ``spa_state``;
    "ties": APP and CtoV of integer levels (0..5, APP = X + CtoV on the
    layer's slots), so that equal values are common in the lists, the
    buckets and the selections; the same frozen frames."""
    app, ctov, active = spa_state(f, n1, e1, q, cols, edges, seed)
    if kind == "ties":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        app = torch.randint(0, 6, (f, n1, q), generator=gen,
                            device="cuda").float()
        ctov = torch.randint(0, 6, (f, e1, q), generator=gen,
                             device="cuda").float()
        app[:, -1] = 0
        ctov[:, -1] = 0
        app[:, cols.long()] += ctov[:, edges.long()]
    return app, ctov, active


def syn_old_route(app, ctov, active, cols, edges, rin, rout, valid, *cn):
    """The layered syndrome super-layer before the fused kernel: torch
    gathers, normalisation, freeze and scatters around ``syndrome_rows``
    (padded slots write their CN output to the padding column and edge)."""
    act = active[:, None, None, None]
    app_rows = app[:, cols]
    ctov_rows = ctov[:, edges]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = cuda_syndrome.syndrome_rows(mvc.reshape(f * g, dc, q), rin, rout,
                                      valid, *cn).reshape(mvc.shape)
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, edges] = mcv
    app[:, cols] = new_app


def check_syn_layer_case(label, state, layer, cn, lists, kind):
    """One ``syndrome_layer`` call against ``syndrome_layer_plain`` and the
    pre-fusion route on clones of ``state``: the kernel equals the plain
    version bit for bit everywhere (frozen frames, untouched rows and the
    padding column and edge included), and both equal the pre-fusion
    route on the real columns and edges.  Returns the largest error."""
    app, ctov, active = state
    cols, edges, rin, rout, valid = layer
    out = {}
    for name, fn in (("fused", lambda *a: cuda_syndrome.syndrome_layer(
                          *a, lists)),
                     ("plain", cuda_syndrome.syndrome_layer_plain),
                     ("old", lambda *a: syn_old_route(
                          *a[:3], a[3].long(), a[4].long(), *a[5:]))):
        a, c = app.clone(), ctov.clone()
        fn(a, c, active, cols, edges, rin, rout, valid, *cn)
        out[name] = (a, c)
    torch.cuda.synchronize()
    (a_k, c_k), (a_p, c_p), (a_o, c_o) = out["fused"], out["plain"], \
        out["old"]
    real = torch.ones(cols.shape, dtype=torch.bool, device="cuda") \
        if valid is None else valid
    own_c, own_e = cols[real].long(), edges[real].long()
    exact = torch.equal(a_k, a_p) and torch.equal(c_k, c_p)
    old_same = (torch.equal(a_o[:, own_c], a_p[:, own_c])
                and torch.equal(c_o[:, own_e], c_p[:, own_e]))
    frozen = ~active
    kept = (torch.equal(a_k[frozen], app[frozen])
            and torch.equal(c_k[frozen], ctov[frozen])
            and bool((a_k[:, -1] == 0).all() and (c_k[:, -1] == 0).all()))
    err = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
    f, (g, dc), q = app.shape[0], cols.shape, app.shape[2]
    print(f"syndrome_layer {label} F={f} G={g} dc={dc} q={q} nm={cn[2]} "
          f"C={cn[0].shape[0]} bayes={cn[4]} presort={cn[5]} frozen "
          f"{int(frozen.sum())} padding slots={int((~real).sum())} {kind}: "
          f"bit-exact={exact} max_abs_err={err}; old route on real slots "
          f"{old_same}; frozen/padding untouched {kept}", flush=True)
    check(exact and old_same and kept,
          f"syndrome_layer != plain / old route at {label} {kind}")
    return err


def check_syn_layer(graph):
    """3c, the fused entry: ``syndrome_layer`` against its plain version
    and the pre-fusion route on the real code's three layer plans at F = 16
    and 128 (the default table) and on odd random layers with padded slots
    (SYN_ODD's shapes and tables), each from a decoder-like or "ties" state
    with about a quarter of the frames frozen; then its times at F = 128
    against the old route, the plain version and the bare entry on the
    same rows.  Returns (largest error, times)."""
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1 = code.n + 1, graph.n_edges + 1
    tabs = _syndrome_tables(4, 32, syn_key({}), "cuda")
    cn = (tabs["table"], tabs["kth"], 32, OFFSET, True, True)
    for f in (16, 128):
        for k, p in enumerate(plans):
            kind = KINDS[k % 2]
            state = syn_state(f, n1, e1, code.q, p["cols"], p["edge_ids"],
                              kind, seed=900 + f + k)
            worst = max(worst, check_syn_layer_case(
                f"layer {k}", state, (p["cols32"], p["edge_ids32"],
                                      p["rot_in8"], p["rot_out8"],
                                      p["valid"]), cn, tabs["lists"], kind))
            del state
    for i, (t, g, dc, q, nm, kw, bayes, presort) in enumerate(SYN_ODD):
        cols, edges, coefs, n1o, e1o = odd_layer(g, dc, q, 3, seed=950 + i)
        gf = get_gf(q)
        coefs_np = coefs.cpu().numpy()
        rin, rout = (torch.as_tensor(
            rotation_table(coefs_np, gf, d).reshape(g, dc, q)
            .astype(np.uint8), device="cuda") for d in ("in", "out"))
        t_odd = _syndrome_tables(dc, nm, syn_key(kw), "cuda")
        cn_odd = (t_odd["table"], t_odd["kth"], nm, OFFSET, bayes, presort)
        for kind in ("decoder", "ties"):
            state = syn_state(t // g, n1o, e1o, q, cols, edges, kind,
                              seed=960 + i)
            worst = max(worst, check_syn_layer_case(
                "odd", state, (cols, edges, rin, rout, coefs != 0), cn_odd,
                t_odd["lists"], kind))
    times = {}
    p = plans[0]
    layer = (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
             p["valid"])
    cols64, edges64 = p["cols"], p["edge_ids"]
    g, dc = p["cols32"].shape
    q = code.q
    f = 128
    app, ctov, _ = spa_state(f, n1, e1, q, cols64, edges64, seed=7)
    active = torch.ones(f, dtype=torch.bool, device="cuda")
    copies = {k: (app.clone(), ctov.clone()) for k in ("fused", "old",
                                                      "plain")}
    mvc = app[:, cols64] - ctov[:, edges64]
    mvc = (mvc - mvc.min(dim=-1, keepdim=True).values).reshape(-1, dc, q)
    fns = {
        "fused": lambda: cuda_syndrome.syndrome_layer(
            *copies["fused"], active, *layer, *cn, tabs["lists"]),
        "old": lambda: syn_old_route(*copies["old"], active, cols64, edges64,
                                     *layer[2:], *cn, tabs["lists"]),
        "plain": lambda: cuda_syndrome.syndrome_layer_plain(
            *copies["plain"], active, *layer, *cn),
        "bare": lambda: cuda_syndrome.syndrome_rows(
            mvc, *layer[2:], *cn, tabs["lists"]),
    }
    reps = {"fused": 10, "bare": 10, "old": 3, "plain": 2}
    got = collections.defaultdict(list)
    # in turns, compared within one call only
    for name in ("plain", "old", "fused", "bare", "bare", "fused", "old",
                 "plain"):
        got[name].append(time_ms(fns[name], reps[name]))
    b_ms, b_by = syn_layer_bound_ms(f, g, dc, q, tabs["table"])
    fused = sum(got["fused"]) / 2
    times = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                 bound_by=b_by)
    print(f"syndrome_layer F={f} G={g} dc={dc} q={q} C="
          f"{tabs['table'].shape[0]}: fused "
          + " / ".join(f"{v:.4f}" for v in got["fused"])
          + " ms, old route " + " / ".join(f"{v:.4f}" for v in got["old"])
          + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
          + " ms, bare syndrome_rows "
          + " / ".join(f"{v:.4f}" for v in got["bare"])
          + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
          f"{100 * b_ms / fused:.2f}% of it", flush=True)
    del app, ctov, copies, mvc, fns
    torch.cuda.empty_cache()
    return worst, times


def check_syndrome_kernel(graph):
    """3c: the syndrome kernel's two entries against their plain versions,
    bit for bit.  ``syndrome_rows`` at the main paths' shapes (layered and
    flooding, F = 16 and 128, with G = 1350 and 4050; the default table,
    nm = 32) and at odd shapes, then its times at the layered and flooding
    F = 128 shapes; ``syndrome_layer`` as ``check_syn_layer``.  Returns the
    largest error, {(path, T): times} and the fused entry's times."""
    phase("3c syndrome kernel against plain")
    worst = 0.0
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    main = {"layered": (layer["rot_in8"], layer["rot_out8"], layer["valid"]),
            "flooding": (rows["rot_in"], rows["rot_out"], rows["valid"])}
    cases = [(path, f * main[path][0].shape[0], *main[path], 32, {}, True,
              True) for path, f in (("layered", 16), ("layered", 128),
                                    ("flooding", 16), ("flooding", 128))]
    for i, (t, g, dc, q, nm, kw, bayes, presort) in enumerate(SYN_ODD):
        cases.append(("odd", t, *odd_tables(g, dc, q, seed=700 + i), nm, kw,
                      bayes, presort))
    for i, (path, t, rin, rout, valid, nm, kw, bayes, presort) in enumerate(
            cases):
        _, dc, q = rin.shape
        tabs = _syndrome_tables(dc, nm, syn_key(kw), "cuda")
        cn = (tabs["table"], tabs["kth"], nm, OFFSET, bayes, presort)
        for kind in KINDS:
            x = rows_input(t, dc, q, kind, seed=800 + i)
            got = cuda_syndrome.syndrome_rows(x, rin, rout, valid, *cn,
                                              tabs["lists"])
            want = cuda_syndrome.syndrome_rows_plain(x, rin, rout, valid, *cn)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = torch.equal(got, want)
            pad = 0 if valid is None else int((~valid).sum())
            print(f"syndrome_rows {path} T={t} G={rin.shape[0]} dc={dc} q={q} "
                  f"nm={nm} C={cn[0].shape[0]} {kw or 'default table'} "
                  f"bayes={bayes} presort={presort} padding slots={pad} "
                  f"{kind}: bit-exact={exact} max_abs_err={err}", flush=True)
            check(exact, f"syndrome_rows != plain at {path} T={t} {kind}")
            worst = max(worst, err)
            del x, got, want
        torch.cuda.empty_cache()
    times = {}
    tabs = _syndrome_tables(4, 32, syn_key({}), "cuda")
    cn = (tabs["table"], tabs["kth"], 32, OFFSET, True, True)
    for path, t, rin, rout, valid, *_ in (cases[1], cases[3]):
        x = rows_input(t, 4, 256, "uniform", seed=7)
        fns = {
            "kernel": lambda: cuda_syndrome.syndrome_rows(
                x, rin, rout, valid, *cn, tabs["lists"]),
            "plain": lambda: cuda_syndrome.syndrome_rows_plain(
                x, rin, rout, valid, *cn),
        }
        reps = {"kernel": 10, "plain": 2}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "kernel", "kernel", "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        g = rin.shape[0]
        b_ms, b_by = syn_bound_ms(t, g, 4, 256, tabs["table"])
        times[(path, t)] = dict({k: sum(v) / 2 for k, v in got.items()},
                                bound=b_ms, bound_by=b_by)
        print(f"syndrome_rows {path} T={t} G={g} dc=4 q=256 nm=32 "
              f"C={tabs['table'].shape[0]}: kernel "
              + " / ".join(f"{v:.4f}" for v in got["kernel"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{100 * b_ms / times[(path, t)]['kernel']:.2f}% of it",
              flush=True)
        del x, fns
        torch.cuda.empty_cache()
    layer_err, layer_times = check_syn_layer(graph)
    return max(worst, layer_err), times, layer_times


def modulated(gen, cw, spec, q, sigma):
    """One set of draws from ``gen`` for the codewords ``cw`` on the card,
    modulated: (y, att, table, inv, dims)."""
    dims = 4 if spec.kind == "qam256_4d" else 2
    z, u, erased = channels.channel_draws(gen, cw.shape, spec, dims)
    tab = torch.as_tensor(channels.table_for(spec, q), device="cuda")
    mod = channels.modulate_4d if dims == 4 else channels.modulate_2d
    y, att = mod(cw, tab, z, u, erased, sigma, spec.erasure_prob)
    return y, att, tab, channels.inv_two_sigma2(sigma), dims


def demap_inputs(f, n, spec, q, snr, seed):
    """``modulated`` for random symbols, [f, n] of them, at ``snr`` dB."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cw = torch.randint(0, q, (f, n), generator=gen, device="cuda")
    return modulated(gen, cw, spec, q, channels.sigma_for(spec, snr, 0.5))


def demap_routes(dims):
    """(K8, its plain version) of a table with ``dims`` columns."""
    if dims == 4:
        return cuda_demap.demap_4d, channels.demap_4d_plain
    return cuda_demap.demap_2d, channels.demap_2d_plain


def demap_4d_gemm(y, att, cand, inv):
    """JAX's own form of the 4-D demapper: its two products against the
    table as ``torch.matmul`` (K = 4, f32 with TF32 off) and the
    elementwise passes; timed for the record, used nowhere in the port."""
    cross = torch.matmul(att * y, cand.T)
    pw = torch.matmul(att * att, (cand * cand).T)
    cost = (pw - 2.0 * cross) * inv
    return cost - cost.min(dim=-1, keepdim=True).values


def demap_bound_ms(rows, q, dims):
    """The output written once and y, att read once, against 4 dims + 2
    (direct) or 4 dims + 3 (expanded) operations a cost."""
    ops = rows * q * (4 * dims + (2 if dims == 2 else 3))
    return bound(rows * q * 4 + 2 * rows * dims * 4, ops)


def live_peak(fn):
    """Bytes ``fn()`` allocates at its peak beyond what was live before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def check_demap_kernel():
    """3d: K8 against its plain version on the same draws (made once on
    the card); times K8, the plain version and, for 4-D, JAX's GEMM form
    in turns at the two q = 256 shapes (and 64-APSK's) beside the bound.
    Returns the largest error and {label: times}."""
    phase("3d demap kernel (K8) against plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for i, (f, n, q, kind, kw, snr) in enumerate(DEMAP_CASES):
        spec = ChannelSpec(kind=kind, sigma_convention="snr", **kw)
        y, att, tab, inv, dims = demap_inputs(f, n, spec, q, snr, 500 + i)
        kernel, plain = demap_routes(dims)
        got, want = kernel(y, att, tab, inv), plain(y, att, tab, inv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.max())
        exact = torch.equal(got, want)
        print(f"demap {kind} {kw} [{f}, {n}, {q}] D={dims} {snr} dB: "
              f"bit-exact={exact} max_abs_err={err} (row scale "
              f"{float(want.max()):.1f}, relative {rel:.2e}); erased "
              f"components {int((att == 0).sum())}", flush=True)
        check(bool(torch.isfinite(got).all())
              and bool((got.min(dim=-1).values == 0).all()),
              f"demap {kind} {kw} [{f}, {n}, {q}]: not min-normalised")
        check(rel <= DEMAP_RTOL, f"demap {kind} {kw} [{f}, {n}, {q}]: K8 "
              f"differs from plain by {err} ({rel:.2e} of the row scale)")
        worst = max(worst, err)
        del y, att, got, want
    times = {}
    for label, (f, n, q, kind, kw, snr) in DEMAP_TIMED.items():
        spec = ChannelSpec(kind=kind, sigma_convention="snr", **kw)
        y, att, tab, inv, dims = demap_inputs(f, n, spec, q, snr, 7)
        kernel, plain = demap_routes(dims)
        fns = {"kernel": lambda: kernel(y, att, tab, inv),
               "plain": lambda: plain(y, att, tab, inv)}
        reps = {"kernel": 20, "plain": 3, "gemm": 5}
        if dims == 4:
            fns["gemm"] = lambda: demap_4d_gemm(y, att, tab, inv)
            gemm_err = float((fns["gemm"]() - fns["plain"]()).abs().max())
        order = [k for k in ("kernel", "plain", "gemm") if k in fns]
        got = collections.defaultdict(list)
        for name in order + order[::-1]:
            got[name].append(time_ms(fns[name], reps[name]))
        peaks = {k: live_peak(fn) for k, fn in fns.items()}
        b_ms, b_by = demap_bound_ms(f * n, q, dims)
        t = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                 bound_by=b_by,
                 peak_gib={k: round(v / 2**30, 3) for k, v in peaks.items()})
        times[label] = t
        print(f"demap {label} [{f}, {n}, {q}] D={dims}: "
              + ", ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                          + " ms" for k, v in got.items())
              + f" per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{100 * b_ms / t['kernel']:.2f}% of it; live peak GiB "
              f"{t['peak_gib']}"
              + (f"; GEMM form vs plain max_abs_err {gemm_err:.3e}"
                 if dims == 4 else ""), flush=True)
        del y, att
    return worst, times


def bubble_case(label, x, tabs, nm, nb_oper, offset, truncate, saturate):
    """K9 against its plain version on rows ``x`` with ``tabs`` (rot_in,
    rot_out, valid), both variants, bit for bit; returns the largest
    error."""
    worst = 0.0
    for variant in ("8", "L"):
        args = (x, *tabs, nm, nb_oper, offset, truncate, saturate, variant)
        got = cuda_bubble.bubble_rows(*args)
        want = bubble_rows_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        exact = torch.equal(got, want)
        print(f"bubble_rows {label} variant {variant}: bit-exact={exact} "
              f"max_abs_err={err}", flush=True)
        check(exact, f"bubble_rows != plain at {label} variant {variant}")
        worst = max(worst, err)
        del got, want
    return worst


def check_bubble_kernel(graph):
    """3e: K9 against its plain version, bit for bit, at the main paths'
    shapes and at odd ones; times at the main shapes.  Returns the largest
    error (0 when bit-exact) and {path: times}."""
    phase("3e bubble kernel (K9) against plain")
    worst = 0.0
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    main = {"layered": (128 * SLICE_ROWS, (layer["rot_in8"], layer["rot_out8"],
                                          layer["valid"]), True),
            "flooding": (128 * CODE_ROWS, (rows["rot_in"], rows["rot_out"],
                                           rows["valid"]), False)}
    for path, (t, tabs, sat) in main.items():
        for kind in KINDS if path == "layered" else KINDS[:1]:
            x = rows_input(t, 4, 256, kind, seed=500 + t)
            worst = max(worst, bubble_case(
                f"{path} T={t} G={tabs[0].shape[0]} nm={BUBBLE_NM} nbOper="
                f"{BUBBLE_OPS} saturate={sat} {kind}", x, tabs, BUBBLE_NM,
                BUBBLE_OPS, OFFSET, True, sat))
            del x
    for i, (t, g, dc, q, nm, ops, trunc, off) in enumerate(BUBBLE_ODD):
        tabs = odd_tables(g, dc, q, seed=40 + i)
        for kind in KINDS:
            x = rows_input(t, dc, q, kind, seed=600 + i)
            sat = trunc and kind == "uniform"
            pad = int((~tabs[2]).sum())
            worst = max(worst, bubble_case(
                f"odd T={t} G={g} dc={dc} q={q} nm={nm} nbOper={ops} "
                f"truncate={trunc} saturate={sat} offset={off} padding "
                f"slots={pad} {kind}", x, tabs, nm, ops, off, trunc, sat))
    times = {}
    for path, (t, tabs, sat) in main.items():
        x = rows_input(t, 4, 256, "uniform", seed=7)
        args = (x, *tabs, BUBBLE_NM, BUBBLE_OPS, OFFSET, True, sat)
        # nbOper = 0: the lists and the dense write alone, no bubble step
        no_steps = (x, *tabs, BUBBLE_NM, 0, OFFSET, True, sat, "8")
        fns = {"kernel": lambda: cuda_bubble.bubble_rows(*args, "8"),
               "lbubble": lambda: cuda_bubble.bubble_rows(*args, "L"),
               "no_steps": lambda: cuda_bubble.bubble_rows(*no_steps),
               "plain": lambda: bubble_rows_plain(*args, "8")}
        reps = {"kernel": 10, "lbubble": 10, "no_steps": 10, "plain": 1}
        got = collections.defaultdict(list)
        for name in ("plain", "kernel", "lbubble", "no_steps", "no_steps",
                     "lbubble", "kernel", "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        g = tabs[0].shape[0]
        b_ms, b_by = ems_bound_ms(t, g, 4, 256, BUBBLE_NM)
        # at most 3 (dc - 2) merges of nbOper steps a row, each an 8-way
        # argmin and one add: far below the bytes, whatever the data
        ops = t * 3 * (4 - 2) * BUBBLE_OPS * 9
        check(ops / F32_OPS_S < b_ms / 1e3, "the bubble steps bound K9")
        times[path] = dict({k: sum(v) / len(v) for k, v in got.items()},
                           bound=b_ms, bound_by=b_by, rows=t)
        print(f"bubble_rows {path} T={t} G={g} dc=4 q=256 nm={BUBBLE_NM} "
              f"nbOper={BUBBLE_OPS}: kernel 8-bubble "
              + " / ".join(f"{v:.4f}" for v in got["kernel"])
              + " ms, L-bubble " + " / ".join(f"{v:.4f}" for v in
                                             got["lbubble"])
              + " ms, nbOper = 0 " + " / ".join(f"{v:.4f}" for v in
                                               got["no_steps"])
              + " ms, plain (8-bubble) " + " / ".join(f"{v:.4f}" for v in
                                                      got["plain"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{100 * b_ms / times[path]['kernel']:.2f}% of it", flush=True)
        del x, args, no_steps
    layer_err, layer_times = check_bubble_layer(graph)
    return max(worst, layer_err), dict(times, layer=layer_times)


def bub_old_route(app, ctov, active, cols, edges, rin, rout, valid, *cn):
    """The layered bubble super-layer before the fused kernel (the
    pre-fusion sweep): torch gathers, normalisation, freeze and scatters around the
    bare ``bubble_rows`` (padded slots write their CN output to the
    padding column and edge)."""
    act = active[:, None, None, None]
    app_rows = app[:, cols]
    ctov_rows = ctov[:, edges]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = cuda_bubble.bubble_rows(mvc.reshape(f * g, dc, q), rin, rout,
                                  valid, *cn).reshape(mvc.shape)
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, edges] = mcv
    app[:, cols] = new_app


def bub_layer_bound_ms(f_active, g, dc, q, nb_oper, elem=4):
    """The least time of one ``bubble_layer`` call on an H100: the APP and
    CtoV rows of the active frames read once and written once (``elem``
    bytes an element), the index,
    rotation and padding tables once, at 3.35 TB/s, against at most
    3 (dc - 2) merges of nb_oper steps a row (an 8-way argmin and one add
    each) at 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    nbytes = (4 * elem * f_active * g * dc * q + 2 * 4 * g * dc
              + 2 * g * dc * q)
    return bound(nbytes, f_active * g * 3 * (dc - 2) * nb_oper * 9)


def check_bub_layer_case(label, state, layer, cn, kind):
    """One ``bubble_layer`` call against ``bubble_layer_plain`` and the
    pre-fusion route on clones of ``state``: the kernel equals the plain version bit
    for bit everywhere (frozen frames, untouched rows and the padding
    column and edge included), and both equal the old route on the real
    columns and edges.  Returns the largest error."""
    app, ctov, active = state
    cols, edges, rin, rout, valid = layer
    out = {}
    for name, fn in (("fused", cuda_bubble.bubble_layer),
                     ("plain", cuda_bubble.bubble_layer_plain),
                     ("old", lambda *a: bub_old_route(
                          *a[:3], a[3].long(), a[4].long(), *a[5:]))):
        a, c = app.clone(), ctov.clone()
        fn(a, c, active, cols, edges, rin, rout, valid, *cn)
        out[name] = (a, c)
    torch.cuda.synchronize()
    (a_k, c_k), (a_p, c_p), (a_o, c_o) = out["fused"], out["plain"], \
        out["old"]
    real = torch.ones(cols.shape, dtype=torch.bool, device="cuda") \
        if valid is None else valid
    own_c, own_e = cols[real].long(), edges[real].long()
    exact = torch.equal(a_k, a_p) and torch.equal(c_k, c_p)
    old_same = (torch.equal(a_o[:, own_c], a_p[:, own_c])
                and torch.equal(c_o[:, own_e], c_p[:, own_e]))
    frozen = ~active
    kept = (torch.equal(a_k[frozen], app[frozen])
            and torch.equal(c_k[frozen], ctov[frozen])
            and bool((a_k[:, -1] == 0).all() and (c_k[:, -1] == 0).all()))
    err = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
    f, (g, dc), q = app.shape[0], cols.shape, app.shape[2]
    nm, nb_oper, offset, truncate, saturate, variant = cn
    print(f"bubble_layer {label} F={f} G={g} dc={dc} q={q} nm={nm} nbOper="
          f"{nb_oper} offset={offset} truncate={truncate} saturate="
          f"{saturate} variant {variant} frozen {int(frozen.sum())} padding "
          f"slots={int((~real).sum())} {kind}: bit-exact={exact} "
          f"max_abs_err={err}; old route on real slots {old_same}; "
          f"frozen/padding untouched {kept}", flush=True)
    check(exact and old_same and kept,
          f"bubble_layer != plain / old route at {label} {kind} variant "
          f"{variant}")
    return err


def check_bubble_layer(graph):
    """3e, the fused entry: ``bubble_layer`` against its plain version and
    the pre-fusion route on the real code's three layer plans at F = 128,
    both variants, from decoder-like and "ties" states with about a quarter of
    the frames frozen, and on odd random layers with padded slots
    (BUBBLE_ODD's shapes and settings); then its times at F = 128 with
    every frame active, in turns with nbOper = 0, the L-bubble, the old
    route and the plain version.  Returns (largest error, times)."""
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1 = code.n + 1, graph.n_edges + 1
    main = (BUBBLE_NM, BUBBLE_OPS, OFFSET, True, True)
    for k, p in enumerate(plans):
        kind = ("decoder", "ties")[k % 2]
        state = syn_state(128, n1, e1, code.q, p["cols"], p["edge_ids"],
                          kind, seed=1100 + k)
        for variant in ("8", "L"):
            worst = max(worst, check_bub_layer_case(
                f"layer {k}", state, (p["cols32"], p["edge_ids32"],
                                      p["rot_in8"], p["rot_out8"],
                                      p["valid"]), (*main, variant), kind))
        del state
    for i, (t, g, dc, q, nm, ops, trunc, off) in enumerate(BUBBLE_ODD):
        cols, edges, coefs, n1o, e1o = odd_layer(g, dc, q, 3, seed=1150 + i)
        gf = get_gf(q)
        rin, rout = (torch.as_tensor(
            rotation_table(coefs.cpu().numpy(), gf, d).reshape(g, dc, q)
            .astype(np.uint8), device="cuda") for d in ("in", "out"))
        for kind in ("decoder", "ties"):
            state = syn_state(t // g, n1o, e1o, q, cols, edges, kind,
                              seed=1160 + i)
            for variant in ("8", "L"):
                worst = max(worst, check_bub_layer_case(
                    "odd", state, (cols, edges, rin, rout, coefs != 0),
                    (nm, ops, off, trunc, trunc, variant), kind))
    p = plans[0]
    layer = (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
             p["valid"])
    g, dc = p["cols32"].shape
    q, f = code.q, 128
    app, ctov, _ = spa_state(f, n1, e1, q, p["cols"], p["edge_ids"], seed=7)
    active = torch.ones(f, dtype=torch.bool, device="cuda")
    names = ("fused", "lbubble", "no_steps", "old", "plain")
    copies = {k: (app.clone(), ctov.clone()) for k in names}
    no_steps = (BUBBLE_NM, 0, OFFSET, True, True, "8")
    fns = {
        "fused": lambda: cuda_bubble.bubble_layer(
            *copies["fused"], active, *layer, *main, "8"),
        "lbubble": lambda: cuda_bubble.bubble_layer(
            *copies["lbubble"], active, *layer, *main, "L"),
        "no_steps": lambda: cuda_bubble.bubble_layer(
            *copies["no_steps"], active, *layer, *no_steps),
        "old": lambda: bub_old_route(*copies["old"], active, p["cols"],
                                     p["edge_ids"], *layer[2:], *main, "8"),
        "plain": lambda: cuda_bubble.bubble_layer_plain(
            *copies["plain"], active, *layer, *main, "8"),
    }
    reps = {"fused": 10, "lbubble": 10, "no_steps": 10, "old": 3,
            "plain": 1}
    got = collections.defaultdict(list)
    # in turns, compared within one call only
    for name in names + names[::-1]:
        got[name].append(time_ms(fns[name], reps[name]))
    b_ms, b_by = bub_layer_bound_ms(f, g, dc, q, BUBBLE_OPS)
    check(b_by == "bytes", "the bubble steps bound bubble_layer")
    times = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                 bound_by=b_by, frames=f, rows=g)
    print(f"bubble_layer F={f} G={g} dc={dc} q={q} nm={BUBBLE_NM} nbOper="
          f"{BUBBLE_OPS}: fused 8-bubble "
          + " / ".join(f"{v:.4f}" for v in got["fused"])
          + " ms, L-bubble " + " / ".join(f"{v:.4f}" for v in got["lbubble"])
          + " ms, nbOper = 0 " + " / ".join(f"{v:.4f}" for v in
                                           got["no_steps"])
          + " ms, old route (the pre-fusion sweep) "
          + " / ".join(f"{v:.4f}" for v in got["old"])
          + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
          + f" ms per call; bound {b_ms:.4f} ms ({b_by}), fused at "
          f"{100 * b_ms / times['fused']:.2f}% of it", flush=True)
    del app, ctov, copies, fns
    torch.cuda.empty_cache()
    return worst, times



LIST_NM, LIST_OPS = 32, 64  # the bench row's list length and budget
LIST_ODD = [               # (F, G, dc, q, nm, nbOper, offset, padded slots)
    # of list_layer on random layer tables
    (16, 300, 4, 256, 32, 64, OFFSET, 7),
    (8, 60, 4, 256, 25, 24, OFFSET, 3),       # nbOper < nm: dup-marker tails
    (8, 100, 6, 64, 12, 24, OFFSET, 5),
    (8, 50, 3, 16, 8, 16, OFFSET, 3),
    (4, 40, 20, 256, 32, 64, OFFSET, 9),      # dc = 20, the Ahmed shape
    (6, 20, 5, 256, 64, 4096, OFFSET, 2),     # nm = 64, every candidate
    (8, 30, 2, 16, 4, 8, OFFSET, 2),          # dc = 2: the swap
    (8, 25, 1, 16, 4, 4, OFFSET, 1),          # dc = 1: the neutral list
    (8, 40, 4, 64, 16, 8, -0.2, 3),           # a negative offset
    (8, 40, 4, 256, 1, 1, OFFSET, 3),         # nm = 1
    (8, 40, 4, 256, 33, 64, OFFSET, 3),       # the first past 32 keys
    (8, 30, 3, 2, 2, 4, OFFSET, 2),           # q = 2
    (4, 8, 120, 256, 64, 200, OFFSET, 9),     # dc = 120: one warp a block
]


def decoder_rows(f, n, q, gen):
    """(X [F, n, q], active [F]) on the card from ``gen``: X with one
    low-cost symbol (0..1) per column and the rest 2..40, as ``spa_state``'s
    APP; about a quarter of the frames frozen (the first active, the last
    frozen)."""
    x = 2 + 38 * torch.rand((f, n, q), generator=gen, device="cuda")
    best = torch.randint(0, q, (f, n, 1), generator=gen, device="cuda")
    x.scatter_(-1, best, torch.rand((f, n, 1), generator=gen,
                                    device="cuda"))
    active = torch.rand(f, generator=gen, device="cuda") >= 0.25
    active[0], active[-1] = True, False
    return x, active


def list_state(f, n1, e1, q, nm, cols, edges, kind, seed, dtype):
    """A compressed layered state on the card, from ``seed``: CtoV lists
    (ascending values from 0, "ties": integer levels 0..5, else 0..10; ids
    drawn with repeats; about a third of the lists with an unfilled tail at
    the saturation, sat = last + offset), APP = X + the expanded CtoV on
    the layer's slots (X as ``spa_state``'s, or levels 0..5), the padding
    column and edge as a decoder holds them (0, ids 0..nm-1), rounded to
    ``dtype``; active [F] with about a quarter of the frames frozen.
    "flat": CtoV values and saturations 0 and X one level 0..5 a column,
    so that every value of a message ties and only the GF ids order the
    keys of each selection."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    app, active = decoder_rows(f, n1, q, gen)
    if kind == "ties":
        app = torch.randint(0, 6, (f, n1, q), generator=gen,
                            device="cuda").float()
        cv_v = torch.randint(0, 6, (f, e1, nm), generator=gen,
                             device="cuda").float()
    else:
        cv_v = 10 * torch.rand((f, e1, nm), generator=gen, device="cuda")
    if kind == "flat":
        app = torch.randint(0, 6, (f, n1, 1), generator=gen,
                            device="cuda").float().expand(f, n1, q).clone()
        cv_v = torch.zeros((f, e1, nm), device="cuda")
    cv_v = cv_v.sort(dim=-1).values
    cv_v = cv_v - cv_v[..., :1]
    cv_sat = cv_v[..., -1] + (0.0 if kind == "flat" else OFFSET)
    tail = (torch.rand((f, e1, 1), generator=gen, device="cuda") < 1 / 3) \
        & (torch.arange(nm, device="cuda") >= nm // 2)
    cv_sat = torch.where(tail.any(-1) & (kind != "flat"),
                         cv_v[..., nm // 2 - 1] + OFFSET, cv_sat)
    cv_v = torch.where(tail, cv_sat[..., None], cv_v)
    cv_g = torch.randint(0, q, (f, e1, nm), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    cv_v[:, -1] = 0
    cv_g[:, -1] = torch.arange(nm, device="cuda", dtype=torch.uint8)
    cv_sat[:, -1] = 0
    app[:, -1] = 0
    real = cols.long() < n1 - 1
    c, e = cols.long()[real], edges.long()[real]
    app[:, c] += listcn.expand_list(cv_v[:, e], cv_g[:, e], cv_sat[:, e], q)
    return (app.to(dtype), cv_v.to(dtype), cv_g, cv_sat.to(dtype), active)


def decoded_list_state(graph, f, dtype, seed, steps=2, nboper=LIST_OPS,
                       nm=LIST_NM):
    """A state the decoder itself made: ``steps`` steps of the list
    stepper (``nm``, ``nboper``) through its plain version on the card
    from a decoder-like intrinsic (``spa_state``'s APP), with about a
    quarter of the frames frozen afterwards."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x, active = decoder_rows(f, graph.code.n, graph.q, gen)
    intr = (x - x.min(dim=-1, keepdim=True).values).to(dtype)
    init, step = make_layered_list_stepper(graph, nm, OFFSET, nboper, dtype,
                                           plain=True)
    state = init(intr)
    for _ in range(steps):
        state = step(state)
    return (*state[:4], active)


def list_layer_bound_ms(f_active, g, dc, q, nm, nb_oper, elem):
    """The least time of one ``list_layer`` call on an H100: the APP rows
    and the compressed CtoV (``elem`` bytes a value, one a GF id) of the
    active frames read once and written once at 3.35 TB/s, against the
    operations (the VN extrinsic, its min and the two dense expansions,
    6 a symbol; 3 (dc - 2) merges of a sum and a min a candidate: the
    staircase's, or all nm^2 in the exact mode, nbOper <= 0) at 67
    TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    pairs = (nm * nm if nb_oper <= 0
             else cuda_list.staircase_pairs(nm, nb_oper))
    nbytes = 2 * f_active * g * dc * (q * elem + nm * (elem + 1) + elem)
    ops = f_active * g * (6 * dc * q + 3 * max(dc - 2, 0) * 2 * pairs)
    return bound(nbytes, ops)


def check_list_case(label, state, layer, cn):
    """One ``list_layer`` call against ``list_layer_plain`` on clones of
    ``state``: bit for bit everywhere but the padding column and edge
    (where the plain version scatters its padded slots), which the kernel
    leaves as they were; frozen frames untouched; the active frames'
    state changed.  Returns the largest error."""
    app, cv_v, cv_g, cv_sat, active = state
    out = {}
    for name, fn in (("kernel", cuda_list.list_layer),
                     ("plain", listcn.list_layer_plain)):
        s = [x.clone() for x in (app, cv_v, cv_g, cv_sat)]
        fn(*s, active, *layer, *cn)
        out[name] = s
    torch.cuda.synchronize()
    before = (app, cv_v, cv_g, cv_sat)
    exact = all(torch.equal(a[:, :-1], b[:, :-1])
                for a, b in zip(out["kernel"], out["plain"]))
    frozen = ~active
    kept = all(torch.equal(a[:, -1], x[:, -1]) and torch.equal(a[frozen],
                                                               x[frozen])
               for a, x in zip(out["kernel"], before))
    changed = not torch.equal(out["kernel"][0][active], app[active])
    err = max(float((a[:, :-1].float() - b[:, :-1].float()).abs().max())
              for a, b in zip(out["kernel"], out["plain"]))
    f, (g, dc), q = app.shape[0], layer[0].shape, app.shape[2]
    valid = layer[4]
    pads = 0 if valid is None else int((~valid).sum())
    print(f"list_layer {label} {app.dtype} F={f} G={g} dc={dc} q={q} "
          f"nm={cn[0]} nbOper={cn[1]} offset={cn[2]} frozen "
          f"{int(frozen.sum())} padded slots {pads}: bit-exact={exact} "
          f"max_abs_err={err}; padding column/edge and frozen frames "
          f"untouched {kept}; active frames changed {changed}", flush=True)
    check(exact and kept and changed,
          f"list_layer != plain at {label} {app.dtype}")
    return err


def check_list_limits(graph):
    """3f: the library refuses exactly the list CNs that the wrapper's
    ``limits_error`` (the plain version's limits) refuses, over a grid of
    shapes around the limits, LIST_ODD's and LIST_GENERAL's included; the
    bench row's shape runs the fast step, and the exact mode there the
    fast step's exact form."""
    lib = cuda_list._lib()
    shapes = {(dc, q, nm, ops) for dc in (1, 2, 3, 4, 5, 6, 20, 40, 100, 120,
                                          400)
              for q in (2, 16, 48, 64, 256, 512)
              for nm in (1, 4, 8, 12, 25, 32, 64, 65, 128, 256)
              for ops in (-1, 0, 1, 4, 24, 64, 4096)}
    shapes |= {(dc, q, nm, ops) for _, _, dc, q, nm, ops, _, _
               in LIST_ODD + LIST_GENERAL}
    bad = [k for k in sorted(shapes)
           if (lib.list_path(*k) != 0) != cuda_list.takes(*k[:3])]
    paths = collections.Counter(cuda_list.path(*k) for k in shapes)
    print(f"list_layer limits: {len(shapes)} shapes, {paths[None]} refused "
          f"by the library (paths {dict(paths)}), the wrapper's limits "
          f"agree on {len(shapes) - len(bad)}", flush=True)
    check(not bad, f"the library's limits differ from limits_error: "
                   f"{bad[:5]}")
    dc, q = graph.code.dc_max, graph.q
    check(cuda_list.path(dc, q, LIST_NM, LIST_OPS) == "fast"
          and cuda_list.path(dc, q, LIST_NM, 0) == "exact",
          "the bench row does not run the fast step, or its exact mode "
          "the fast step's exact form")


def check_list_kernel(graph):
    """3f: K3 (``cuda_list.list_layer``) against ``list_layer_plain`` at
    full width on the real code's three layer plans (F = 128, nm = 32,
    nbOper = 64, and nm = 25, nbOper = 24 on one plan), f32 and bf16,
    from random "decoder" and "ties" states and from states the decoder
    made, about a quarter of the frames frozen; then on odd random layers
    with padded slots (LIST_ODD); then timed in turns with the plain
    version at F = 128, every frame active, on both dtypes.  Returns (the
    largest error, {dtype: times})."""
    phase("3f list kernel (K3) against plain")
    check_list_limits(graph)
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1, q = code.n + 1, graph.n_edges + 1, code.q

    def tables(p):
        return (p["cols32"], p["edge_ids32"], p["rc_in"], p["rc_out"],
                p["valid"])

    main = (LIST_NM, LIST_OPS, OFFSET)
    for dtype in (torch.float32, BF16):
        for k, p in enumerate(plans):
            for kind in ("decoder", "ties"):
                state = list_state(128, n1, e1, q, LIST_NM, p["cols"],
                                   p["edge_ids"], kind, 1300 + k, dtype)
                worst = max(worst, check_list_case(
                    f"layer {k} {kind}", state, tables(p), main))
                del state
        state = list_state(128, n1, e1, q, 25, plans[1]["cols"],
                           plans[1]["edge_ids"], "decoder", 1310, dtype)
        worst = max(worst, check_list_case("layer 1 decoder", state,
                                           tables(plans[1]), (25, 24, OFFSET)))
        state = decoded_list_state(graph, 128, dtype, seed=1320)
        for k, p in enumerate(plans):
            worst = max(worst, check_list_case(f"layer {k} decoded", state,
                                               tables(p), main))
        state = list_state(128, n1, e1, q, LIST_NM, plans[0]["cols"],
                           plans[0]["edge_ids"], "flat", 1330, dtype)
        worst = max(worst, check_list_case("layer 0 flat", state,
                                           tables(plans[0]), main))
        del state
    for i, (f, g, dc, qo, nm, ops, off, pads) in enumerate(LIST_ODD):
        layer, n1o, e1o = odd_list_layer(g, dc, qo, pads, seed=1350 + i)
        for dtype in (torch.float32, BF16):
            for kind in ("decoder", "ties"):
                state = list_state(f, n1o, e1o, qo, nm, layer[0], layer[1],
                                   kind, 1360 + i, dtype)
                worst = max(worst, check_list_case(f"odd {kind}", state,
                                                   layer, (nm, ops, off)))
    p = plans[0]
    g, dc = p["cols32"].shape
    f = 128
    active = torch.ones(f, dtype=torch.bool, device="cuda")
    times = {}
    for dtype, elem in ((torch.float32, 4), (BF16, 2)):
        state = list_state(f, n1, e1, q, LIST_NM, p["cols"], p["edge_ids"],
                           "decoder", 7, dtype)[:4]
        copies = {k: [x.clone() for x in state] for k in ("kernel", "plain")}
        fns = {"kernel": lambda: cuda_list.list_layer(
                   *copies["kernel"], active, *tables(p), *main),
               "plain": lambda: listcn.list_layer_plain(
                   *copies["plain"], active, *tables(p), *main)}
        reps = {"kernel": 10, "plain": 2}
        got = collections.defaultdict(list)
        # in turns, compared within one call only
        for name in ("plain", "kernel", "kernel", "plain"):
            got[name].append(time_ms(fns[name], reps[name]))
        b_ms, b_by = list_layer_bound_ms(f, g, dc, q, LIST_NM, LIST_OPS, elem)
        check(b_by == "bytes", "the list merges bound list_layer")
        key = "bf16" if dtype == BF16 else "f32"
        times[key] = dict({k: sum(v) / len(v) for k, v in got.items()},
                          bound=b_ms, bound_by=b_by, frames=f, rows=g)
        print(f"list_layer {dtype} F={f} G={g} dc={dc} q={q} nm={LIST_NM} "
              f"nbOper={LIST_OPS}: kernel "
              + " / ".join(f"{v:.4f}" for v in got["kernel"])
              + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
              + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{100 * b_ms / times[key]['kernel']:.2f}% of it", flush=True)
        del state, copies, fns
    torch.cuda.empty_cache()
    return worst, times


LIST_GENERAL = [           # (F, G, dc, q, nm, nbOper, offset, padded
    # slots) of list_layer's exact mode and general step on random layer
    # tables
    (8, 60, 4, 256, 32, 0, OFFSET, 3),       # exact, the bench's nm
    (8, 40, 4, 256, 33, 0, OFFSET, 3),       # the first past 32 keys
    (8, 40, 4, 256, 63, 0, OFFSET, 3),
    (8, 40, 4, 256, 64, 0, OFFSET, 3),       # the exact form's last nm
    (8, 30, 4, 256, 32, 0, OFFSET, 60),      # half the slots padded: merges
    # of neutral lists, fewer than nm GF ids below BIG (the tail)
    (4, 40, 20, 64, 32, 0, OFFSET, 9),       # dc = 20 at q = 64
    (8, 50, 3, 16, 8, 0, OFFSET, 3),
    (8, 100, 6, 64, 12, 0, OFFSET, 5),
    (8, 40, 4, 256, 1, 0, OFFSET, 3),        # nm = 1
    (8, 30, 3, 2, 2, 0, OFFSET, 2),          # q = 2, nm = q
    (8, 30, 2, 16, 4, 0, OFFSET, 2),         # dc = 2: the swap
    (8, 25, 1, 16, 4, 0, OFFSET, 1),         # dc = 1: the neutral list
    (8, 40, 4, 64, 16, 0, -0.2, 3),          # a negative offset
    (8, 40, 3, 16, 16, 0, OFFSET, 12),       # nm = q, many neutral lists
    (6, 40, 4, 64, 64, 0, OFFSET, 3),        # nm = q = 64
    (2, 8, 4, 256, 256, 0, OFFSET, 2),       # nm = q = 256
    (4, 30, 4, 256, 256, 0, OFFSET, 60),     # dense: half the slots padded
    # (tails: the row again through the list form)
    (4, 30, 4, 256, 240, 0, OFFSET, 60),     # the list form's tails
    (4, 40, 4, 256, 65, 0, OFFSET, 3),       # exact, past the fast step
    (4, 40, 4, 256, 96, 0, OFFSET, 3),       # exact, the list form
    (4, 40, 4, 256, 128, 0, OFFSET, 3),
    (2, 20, 4, 256, 255, 0, OFFSET, 3),
    (4, 8, 120, 256, 64, 0, OFFSET, 9),      # dc = 120: the workspace
    (2, 4, 400, 64, 32, 64, OFFSET, 9),      # the staircase, workspace
    (8, 40, 4, 256, 65, 64, OFFSET, 3),      # the staircase, nm = 65
    (4, 40, 4, 256, 96, 64, OFFSET, 3),
    (4, 40, 4, 256, 128, 256, OFFSET, 3),
    (2, 20, 4, 256, 255, 1000, OFFSET, 3),
    (4, 20, 4, 256, 256, 64, OFFSET, 3),     # the staircase, nm = q
    (4, 20, 4, 256, 256, 4096, OFFSET, 3),
    (6, 20, 5, 256, 100, 300, -0.2, 2),
]


def odd_list_layer(g, dc, q, pads, seed):
    """``odd_layer``'s random tables as a list layer: (cols, edges, rc_in,
    rc_out, valid) and N + 1, E + 1."""
    cols, edges, coefs, n1, e1 = odd_layer(g, dc, q, pads, seed)
    if q == 2:  # GF(2), which gf.py leaves out: h^-1 = h (1, or 0)
        rc_in = rc_out = coefs[..., None].contiguous()
    else:
        gf = get_gf(q)
        rc_in, rc_out = (torch.as_tensor(
            listcn.mul_cols(gf, coefs.cpu().numpy(), inv), device="cuda")
            for inv in (False, True))
    return (cols, edges, rc_in, rc_out, coefs != 0), n1, e1


def check_list_general(graph):
    """3g: K3's exact mode (nbOper = 0, the fast step's exact form at nm
    <= 64) and general step (lists up to q = 256 on both merges; rows from
    the workspace) against
    ``list_layer_plain``, bit for bit: the real code's three layer plans at
    F = 128, nm = 32, nbOper = 0, f32 and bf16, from "decoder", "ties",
    "flat" and decoded states; the same plans at F = 4 (the plain
    version's exact merges hold [F, 1350, nm * nm] candidates) with nm =
    q (4l's settings: the general step's dense form) from "decoder",
    "ties" and decoded states, and with nm = 128 (its list form) from
    "decoder" states; the odd padded layers of LIST_GENERAL; a
    decode from the workspace (``check_workspace_decodes``); then timed at
    F = 128 on layer 0 beside the bound: the exact mode at nm = 32
    in turns with its plain version, at nm = q (the plain version's
    [F, G, 2, 65536] candidates do not fit the card: not timed), and the
    staircase at nm = 65 with its plain version.  Returns (the largest
    error, {label: times})."""
    phase("3g list kernel (K3): the exact mode, long lists, the workspace")
    worst = 0.0
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1, q = code.n + 1, graph.n_edges + 1, code.q

    def tables(p):
        return (p["cols32"], p["edge_ids32"], p["rc_in"], p["rc_out"],
                p["valid"])

    exact = (LIST_NM, 0, OFFSET)
    check(cuda_list.path(code.dc_max, q, LIST_NM, 0) == "exact",
          "the exact mode does not run the fast step's exact form")
    for dtype in (torch.float32, BF16):
        for k, p in enumerate(plans):
            for kind in ("decoder", "ties", "flat"):
                state = list_state(128, n1, e1, q, LIST_NM, p["cols"],
                                   p["edge_ids"], kind, 1400 + k, dtype)
                worst = max(worst, check_list_case(
                    f"layer {k} {kind}", state, tables(p), exact))
                del state
        state = decoded_list_state(graph, 128, dtype, seed=1420, nboper=0)
        for k, p in enumerate(plans):
            worst = max(worst, check_list_case(f"layer {k} decoded", state,
                                               tables(p), exact))
        del state
    check(cuda_list.path(code.dc_max, q, q, 0) == "shared",
          "the real code's rows at nm = q do not run the general step from "
          "shared memory")
    for dtype in (torch.float32, BF16):
        for k, p in enumerate(plans):
            for nm, kinds in ((q, ("decoder", "ties")), (128, ("decoder",))):
                for kind in kinds:
                    state = list_state(4, n1, e1, q, nm, p["cols"],
                                       p["edge_ids"], kind, 1430 + k, dtype)
                    worst = max(worst, check_list_case(
                        f"layer {k} {kind} nm={nm}", state, tables(p),
                        (nm, 0, OFFSET)))
                    del state
        state = decoded_list_state(graph, 4, dtype, seed=1440, nboper=0, nm=q)
        for k, p in enumerate(plans):
            worst = max(worst, check_list_case(f"layer {k} decoded nm={q}",
                                               state, tables(p), (q, 0, OFFSET)))
        del state
        torch.cuda.empty_cache()
    for i, (f, g, dc, qo, nm, ops, off, pads) in enumerate(LIST_GENERAL):
        layer, n1o, e1o = odd_list_layer(g, dc, qo, pads, seed=1450 + i)
        where = cuda_list.path(dc, qo, nm, ops)
        check(where != "fast", f"LIST_GENERAL {i} runs the fast step")
        for dtype in (torch.float32, BF16):
            for kind in ("decoder", "ties"):
                state = list_state(f, n1o, e1o, qo, nm, layer[0], layer[1],
                                   kind, 1460 + i, dtype)
                worst = max(worst, check_list_case(
                    f"odd {where} {kind}", state, layer, (nm, ops, off)))
                del state
    check_workspace_decodes()
    f = 128
    active = torch.ones(f, dtype=torch.bool, device="cuda")
    # the real code's first layer, and a random one of 20 rows of degree 34
    # whose rows at nm = q run from the workspace
    layers = {"layer 0": (tables(plans[0]), n1, e1),
              "dc 34": odd_list_layer(20, 34, q, 0, seed=34)}
    check(cuda_list.path(34, q, q, 0) == "workspace",
          "the dc = 34 layer at nm = q does not run from the workspace")
    times = {}
    for label, where, nm, ops, dtypes, plain in (
            ("exact", "layer 0", LIST_NM, 0,
             ((torch.float32, 4), (BF16, 2)), True),
            ("exact_nmq", "layer 0", q, 0, ((BF16, 2), (torch.float32, 4)),
             False),
            ("exact128", "layer 0", 128, 0, ((BF16, 2),), False),
            ("stair65", "layer 0", 65, LIST_OPS, ((BF16, 2),), True),
            ("stair128", "layer 0", 128, 256, ((BF16, 2),), True),
            ("ws34", "dc 34", q, 0, ((torch.float32, 4),), False)):
        layer, ln1, le1 = layers[where]
        g, dc = layer[0].shape
        for dtype, elem in dtypes:
            state = list_state(f, ln1, le1, q, nm, layer[0], layer[1],
                               "decoder", 8, dtype)[:4]
            copies = {k: [x.clone() for x in state]
                      for k in ("kernel", "plain")}
            fns = {"kernel": lambda: cuda_list.list_layer(
                       *copies["kernel"], active, *layer, nm, ops, OFFSET),
                   "plain": lambda: listcn.list_layer_plain(
                       *copies["plain"], active, *layer, nm, ops, OFFSET)}
            order = (("plain", "kernel", "kernel", "plain") if plain
                     else ("kernel", "kernel"))
            got = collections.defaultdict(list)
            reps = {"kernel": 10, "plain": 2}
            for name in order:
                got[name].append(time_ms(fns[name], reps[name]))
            b_ms, b_by = list_layer_bound_ms(f, g, dc, q, nm, ops, elem)
            key = f"{label}_{'bf16' if dtype == BF16 else 'f32'}"
            times[key] = dict({k: sum(v) / len(v) for k, v in got.items()},
                              bound=b_ms, bound_by=b_by, nm=nm, nboper=ops)
            times[key].setdefault("plain", None)
            print(f"list_layer {label} {dtype} F={f} G={g} dc={dc} q={q} "
                  f"nm={nm} nbOper={ops} ({cuda_list.path(dc, q, nm, ops)} "
                  f"path): kernel "
                  + " / ".join(f"{v:.4f}" for v in got["kernel"])
                  + " ms, plain "
                  + (" / ".join(f"{v:.4f}" for v in got["plain"])
                     if plain else "not measured")
                  + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
                  f"{100 * b_ms / times[key]['kernel']:.2f}% of it",
                  flush=True)
            del state, copies, fns
            torch.cuda.empty_cache()
    return worst, times


def decide_app(f, n, q, dtype, seed):
    """A decoder-like APP [f, n + 1, q] of ``dtype`` on the card: costs in
    [0, 20) less their row's minimum, a third of the rows on quarter steps
    (ties), made 128 frames at a time; in each frame row 0 of one value,
    row 1 with two NaNs, row 2 all +inf, row 3 with -0 before +0 (n > 3)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    app = torch.empty((f, n + 1, q), dtype=dtype, device="cuda")
    for lo in range(0, f, 128):
        x = torch.rand((min(128, f - lo), n + 1, q), generator=gen,
                       device="cuda") * 20
        tie = torch.rand(x.shape[:2] + (1,), generator=gen,
                         device="cuda") < 1 / 3
        x = torch.where(tie, (4 * x).floor() / 4, x)
        app[lo:lo + 128] = x - x.amin(-1, keepdim=True)
        del x, tie
    if n > 3:
        app[:, 0] = 3.0
        app[:, 1, q // 3] = float("nan")
        app[:, 1, q - 1] = float("nan")
        app[:, 2] = float("inf")
        app[:, 3] = 1.0
        app[:, 3, q // 2] = 0.0
        app[:, 3, q // 4] = -0.0
    return app


def decide_masks(f, seed):
    """3h's masks: None (the reset form), every frame, none, one, and
    random draws of ~30% and ~1% (at least one frame)."""
    gen = torch.Generator().manual_seed(seed)
    masks = {"reset": None, "all": torch.ones(f, dtype=torch.bool),
             "none": torch.zeros(f, dtype=torch.bool),
             "one": torch.arange(f) == f // 2}
    for share in (0.3, 0.01):
        m = torch.zeros(f, dtype=torch.bool)
        m[torch.randperm(f, generator=gen)[:max(1, round(share * f))]] = True
        masks[f"{share:.0%}"] = m
    return {k: None if v is None else v.cuda() for k, v in masks.items()}


def decide_case(app, n, mask):
    """K4 against ``decide_rows_plain`` on one mask, from latched
    decisions of -7: (bit-exact, the launches and rows K4 counted, as
    expected)."""
    f = app.shape[0]
    got = torch.full((f, n), -7, dtype=torch.int64, device="cuda")
    want = got.clone()
    cuda_decide.reset_device_launches()
    cuda_decide.decide_rows(app, got, mask)
    counted = (cuda_decide.device_launches(), cuda_decide.device_rows())
    cuda_decide.decide_rows_plain(app, want, mask)
    decided = f if mask is None else int(mask.sum())
    return torch.equal(got, want), counted == (1, n * decided)


def decide_bound_ms(active, n, q, elem):
    """K4's bytes at 3.35 TB/s: the active frames' APP rows read once and
    their int64 decisions written once."""
    return active * n * (q * elem + 8) / HBM_BYTES_S * 1e3


def check_decide_kernel():
    """3h: K4 (``cuda_decide.decide_rows``) against its plain version bit
    for bit, on f32 and bf16 APPs, every q of ``DECIDE_QS`` at
    ``DECIDE_ODD``'s shapes and at the cells' (``DECIDE_TIMED``), under
    every mask of ``decide_masks``, with the launches and rows it counts;
    then timed at the cells' shapes with 100%, ~30% and ~1% of the frames
    active, in turns with the plain version and ``torch.argmin`` alone,
    beside the bound.  Returns {dtype: timings}."""
    phase("3h decisions kernel (K4) against plain")
    for dtype in (torch.float32, torch.bfloat16):
        for q in DECIDE_QS:
            for f, n in DECIDE_ODD:
                app = decide_app(f, n, q, dtype, seed=q + f)
                res = {k: decide_case(app, n, m)
                       for k, m in decide_masks(f, seed=q).items()}
                ok = all(a for a, _ in res.values())
                counted = all(b for _, b in res.values())
                print(f"decide_rows {dtype} q={q} F={f} N={n}: bit-exact="
                      f"{ok}; counts as expected {counted} "
                      f"({sorted(res)})", flush=True)
                check(ok and counted, f"decide_rows {dtype} q={q} F={f} "
                      f"N={n}: {res}")
    times = {}
    for key, (f, dtype) in DECIDE_TIMED.items():
        n, q = 8100, 256
        app = decide_app(f, n, q, dtype, seed=f)
        masks = decide_masks(f, seed=f)
        res = {k: decide_case(app, n, m) for k, m in masks.items()}
        print(f"decide_rows {dtype} F={f} N={n} q={q}: bit-exact="
              f"{all(a for a, _ in res.values())}; counts as expected "
              f"{all(b for _, b in res.values())}", flush=True)
        check(all(a and b for a, b in res.values()),
              f"decide_rows {dtype} F={f}: {res}")
        decide = torch.zeros((f, n), dtype=torch.int64, device="cuda")
        t = {"frames": f, "dtype": key}
        for share in DECIDE_SHARES:
            mask = masks["all"] if share == 1.0 else masks[f"{share:.0%}"]
            active = int(mask.sum())
            runs = {"kernel": [], "plain": []}
            for _ in range(2):
                runs["kernel"].append(time_ms(
                    lambda: cuda_decide.decide_rows(app, decide, mask), 10))
                if share == 1.0:
                    runs["plain"].append(time_ms(
                        lambda: cuda_decide.decide_rows_plain(app, decide,
                                                              mask), 5))
            bound = decide_bound_ms(active, n, q, app.element_size())
            kern = min(runs["kernel"])
            t[f"{share:.0%}"] = {"active": active, "kernel": runs["kernel"],
                                 "bound": bound,
                                 "share_of_bound": bound / kern}
            print(f"decide_rows {dtype} F={f} N={n} q={q}, {active} active "
                  f"({share:.0%}): kernel "
                  f"{' / '.join(f'{x:.4f}' for x in runs['kernel'])} ms; "
                  f"bound {bound:.4f} ms (bytes), kernel at "
                  f"{100 * bound / kern:.1f}% of it", flush=True)
            if share == 1.0:
                t["plain"] = runs["plain"]
        t["reset"] = [time_ms(lambda: cuda_decide.decide_rows(app, decide),
                              10) for _ in range(2)]
        t["library"] = [time_ms(lambda: app[:, :n].argmin(dim=-1), 5)
                        for _ in range(2)]
        print(f"decide_rows {dtype} F={f}: reset form (no mask) "
              f"{' / '.join(f'{x:.4f}' for x in t['reset'])} ms; plain "
              f"(argmin + where) "
              f"{' / '.join(f'{x:.4f}' for x in t['plain'])} ms; "
              f"torch.argmin alone "
              f"{' / '.join(f'{x:.4f}' for x in t['library'])} ms per call",
              flush=True)
        times[key] = t
        del app, decide, masks
        gc.collect()
        torch.cuda.empty_cache()
    return times


def check_decide_cells(names=DECIDE_CELLS):
    """3h on the benchmark's cells (``simbench``): each cell's pool of
    batches through the program's batch step after one warm-up batch
    outside it, with K4's counts read over the pool: its launches equal
    the steps plus one reset a batch, its rows N x (iterations + frames);
    prints the share of the all-frames pass (N x F x (steps + 1) a batch)
    that K4 skipped."""
    from simbench import harness, spec
    from simbench.codes import make as make_matrix

    phase("3h decisions kernel (K4) on the benchmark's cells")
    out = {}
    for name in names:
        cell = spec.cell(name)
        prog = harness.imported_program()
        rows, coefs = make_matrix(cell["config"]["code"])
        code = harness.make_code(prog, cell, rows, coefs)
        traffic = cell["traffic"]
        pool_seed = int(traffic["pool_seed"])
        pool = int(traffic["pool_batches"])
        step, mc = harness.stepper(prog, code, cell, pool_seed, "cuda")
        step(pool).cpu()                       # the capture, outside the pool
        cuda_decide.reset_device_launches()
        counters = np.array([step(b).cpu().numpy() for b in range(pool)])
        launched = cuda_decide.device_launches()
        decided = cuda_decide.device_rows()
        f, n = int(counters[0, 0]), code.n
        steps, iters = counters[:, 5], counters[:, 4]
        every = n * f * int((steps + 1).sum())
        skipped = 1 - decided / every
        out[name] = {"steps": steps.tolist(), "iter_sum": int(iters.sum()),
                     "rows": decided, "all_frames_rows": every,
                     "skipped": skipped}
        print(f"{name}: pool steps {steps.tolist()}, iterations "
              f"{int(iters.sum())} over {f * pool} frames; K4 launches "
              f"{launched} (steps + resets {int(steps.sum()) + pool}), rows "
              f"{decided} (N x (iterations + frames) "
              f"{n * (int(iters.sum()) + f * pool)}); an all-frames pass "
              f"{every}: skipped share {skipped:.4f}", flush=True)
        check(launched == int(steps.sum()) + pool
              and decided == n * (int(iters.sum()) + f * pool),
              f"{name}: K4 counted {launched} launches, {decided} rows")
        del step, mc, code
        device_loop.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_workspace_decodes():
    """3g: a list-EMS decode whose rows run from K3's workspace (a code of
    20 rows of degree 34 over 120 GF(256) columns, nm = q = 256, the
    exact merge: 135,168 B a warp of mvc and dense lists, of which a
    block's shared memory holds fewer than four), under the device loop
    (the workspace
    is allocated inside the graph's capture) against the host loop, and
    the host loop through K3 against ``list_layer_plain`` on the card:
    identical decisions, iterations and convergence."""
    rng = np.random.default_rng(5)
    n, m, dc, q = 120, 20, 34, 256
    rows = [np.sort(rng.choice(n, dc, replace=False)) for _ in range(m)]
    code = from_parsed(ParsedMatrix(n, m, q, rows,
                                    [rng.integers(1, q, dc) for _ in rows]))
    graph = DeviceGraph.from_code(code)
    check(cuda_list.path(dc, q, q, 0) == "workspace",
          "the workspace decode does not run from the workspace")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    x, _ = decoder_rows(4, n, q, gen)
    intr = x - x.min(dim=-1, keepdim=True).values
    dec = DecoderConfig(max_iters=3, schedule="layered", cn="ems", nm=q,
                        offset=OFFSET, nboper=0, storage="compressed",
                        dtype="float32")
    n_layers = len(code.layers)
    check_loops("list-EMS workspace", graph, intr, dec,
                {"list_layer": n_layers})
    outs = {}
    for plain in (False, True):
        reset_launches()
        outs[plain] = tuple(x.cpu() for x in decode_layered_list_hostloop(
            graph, intr, dec.max_iters, dec.nm, dec.offset, dec.nboper,
            torch.float32, plain=plain)) + (
            read_host_launches("3g workspace"),)
    same = all(torch.equal(a, b) for a, b in zip(outs[False][:3],
                                                  outs[True][:3]))
    steps = int(outs[False][1].max())
    print(f"list-EMS workspace F=4 N={n} M={m} dc={dc} nm={q} nbOper=0, "
          f"kernel vs plain decode (host loop): identical decisions/"
          f"iterations/convergence {same}; steps {steps}; launches kernel "
          f"{outs[False][3]['list_layer']}, plain "
          f"{sum(outs[True][3].values())}", flush=True)
    check(same and outs[False][3]["list_layer"] == n_layers * steps > 0
          and outs[False][3]["decide_rows"] == steps + 1
          and sum(outs[True][3].values()) == 0,
          "the workspace decode differs from its plain version")
    device_loop.clear()


# (T, G, dc, q, nm, truncate, dense) of ems_rows on K1's further rows:
# from its workspace (dense rows where fewer than four warps' fit a block,
# from dc = 20 at q = 256; 32-entry lists where one warp's does not, from
# dc = 66) and of dc <= 2
ROWS_WS = [
    (1200, 40, 34, 256, 200, True, True),
    (800, 40, 40, 256, 256, False, True),
    (600, 30, 66, 256, 32, True, False),
    (300, 30, 70, 256, 32, True, False),
    (2000, 50, 2, 256, 32, True, False),
    (2000, 50, 2, 256, 200, True, True),
    (999, 37, 1, 16, 4, True, False),
    (999, 37, 1, 16, 16, False, True),
    (640, 64, 2, 16, 16, False, True),
]


# (T, G, dc, q, nm, truncate) of ems_rows(..., dense=True) on the rows
# the dense merge's layout could break: PER = 2 and 4 (q = 64, 128) and
# q = 8 (PER = 1, 8 live lanes) at the layered call's row count; an odd
# number of middle merges (dc = 3, 5); the largest dense row that runs
# from shared memory at q = 256 (dc = 19) and the smallest from the
# workspace (dc = 20).  Padding slots and valid on every one.
ROWS_DENSE = [
    (128 * SLICE_ROWS, SLICE_ROWS, 4, 64, 64, False),
    (128 * SLICE_ROWS, SLICE_ROWS, 4, 128, 100, True),
    (128 * SLICE_ROWS, SLICE_ROWS, 4, 8, 8, False),
    (2000, 50, 3, 256, 200, True),
    (2000, 50, 5, 256, 256, False),
    (1000, 40, 5, 64, 64, False),
    (400, 20, 19, 256, 256, False),
    (400, 20, 20, 256, 200, True),
]
# (T, dc, q) of the bare fb_checknode at nm = q (the dense merge) on bf16
# rows (round_bf16) and on rows with negative values (the float minima)
BARE_DENSE = [(16 * SLICE_ROWS, 4, 256), (1000, 5, 64), (999, 3, 16),
              (500, 19, 256), (300, 40, 256)]


def issue_floor_ms(t, dc, q):
    """The least time of K1's dense mode on this card by instruction
    issue: each of its t * 3 (dc - 2) * q^2 candidates is one f32 add and
    one minimum, two instructions, and an SM issues at most 128 lanes' a
    clock (4 schedulers of 32), at the card's largest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.split()[0]) if out.returncode == 0 else 1980.0
    cands = t * 3 * max(dc - 2, 0) * q * q
    return 2 * cands / (sms * 128 * mhz * 1e6) * 1e3


def check_kernel_modes(graph):
    """3: K1's modes against their plain versions, bit for bit: the
    dense min-convolution (``ems_rows(..., dense=True)``, lists of all q
    entries) against ``ems_rows_plain(..., dense=True)``
    (``fb_checknode_dense``) at the layered shape (G = 1350, F = 16) and
    the flooding one (G = 4050, F = 16), with truncation at nm = 200 (ties
    with the nm-th kept) and without, and on ROWS_ODD's padded shapes;
    ROWS_WS's padded rows from K1's workspace (dc = 34 to 70 at q = 256,
    dense and top-k) and of dc <= 2; the bare entry on bf16 rows against
    ``fb_checknode_topk`` on the same bf16 rows; then the dense mode timed
    at the layered shape F = 128 in turns with its plain version, the
    workspace at dc = 40 (dense) likewise, and the bare entry on bf16 rows
    in turns with it on f32 rows at the layered shape, each beside its
    bound.  Returns (the largest error, times)."""
    phase("3 EMS kernel (K1): the dense min-convolution, the workspace, "
          "dc <= 2 and bf16 rows")
    worst = 0.0
    layer = _layer_plan(graph, "cuda")[0]
    rows = _cn_row_tables(graph, "cuda")
    main = {"layered": (layer["rot_in8"], layer["rot_out8"], layer["valid"]),
            "flooding": (rows["rot_in"], rows["rot_out"], rows["valid"])}
    cases = [(path, 16 * main[path][0].shape[0], *main[path], nm, truncate)
             for path in ("layered", "flooding")
             for nm, truncate in ((200, True), (256, False))]
    cases = [case + (True,) for case in cases]
    for i, (t, g, dc, q, nm, truncate) in enumerate(ROWS_ODD):
        cases.append(("odd", t, *odd_tables(g, dc, q, seed=i), max(1, nm),
                      truncate and nm < q, True))
    for i, (t, g, dc, q, nm, truncate, dense) in enumerate(ROWS_WS):
        cases.append(("workspace" if dc > 2 else f"dc={dc}", t,
                      *odd_tables(g, dc, q, seed=40 + i), nm, truncate,
                      dense))
    for i, (t, g, dc, q, nm, truncate) in enumerate(ROWS_DENSE):
        cases.append(("dense rows", t, *odd_tables(g, dc, q, seed=60 + i),
                      nm, truncate, True))
    for i, (path, t, rin, rout, valid, nm, truncate, dense) in enumerate(
            cases):
        for kind in KINDS + (("negative",) if path == "dense rows" else ()):
            _, dc, q = rin.shape
            x = rows_input(t, dc, q, "uniform" if kind == "negative" else kind,
                           seed=500 + i)
            if kind == "negative":
                x[::3] -= 1.5   # a third of the rows: no integer minima
            got = cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET, truncate,
                                   dense=dense)
            want = cuda_cn.ems_rows_plain(x, rin, rout, valid, nm, OFFSET,
                                          truncate, dense=dense)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = torch.equal(got, want)
            print(f"ems_rows {'dense' if dense else 'top-k'} {path} T={t} "
                  f"G={rin.shape[0]} dc={dc} q={q} nm={nm} "
                  f"truncate={truncate} {kind}: bit-exact={exact} "
                  f"max_abs_err={err}", flush=True)
            check(exact, f"ems_rows != plain at {path} T={t} dc={dc} "
                         f"dense={dense} {kind}")
            worst = max(worst, err)
            del x, got, want
    for i, (t, dc, q, nm) in enumerate(KERNEL_SHAPES[:1] + KERNEL_SHAPES[4:]
                                       + [(500, 2, 256, 32), (300, 1, 16, 4),
                                          (200, 40, 256, 32)]):
        for kind in KINDS:
            vr = kernel_input(t, dc, q, nm, kind, seed=600 + i).to(BF16)
            got = cuda_cn.fb_checknode(vr, nm)
            want = fb_checknode_topk(vr, nm)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            exact = torch.equal(got, want) and got.dtype == BF16
            print(f"fb_checknode bf16 T={t} dc={dc} q={q} nm={nm} {kind}: "
                  f"bit-exact={exact} max_abs_err={err}", flush=True)
            check(exact, f"fb_checknode bf16 != plain at {(t, dc, q, nm)}")
            worst = max(worst, err)
            del vr, got, want
    # the bare entry at nm = q (the dense merge, no truncation): bf16 rows
    # (each merge rounded), f32 rows with negative values in some rows
    for i, (t, dc, q) in enumerate(BARE_DENSE):
        for kind in ("bf16 ties", "bf16 uniform", "negative"):
            vr = kernel_input(t, dc, q, q, kind.split()[-1]
                              if kind != "negative" else "uniform",
                              seed=700 + i)
            if kind == "negative":
                vr[1::3] -= 2.0
            else:
                vr = vr.to(BF16)
            got = cuda_cn.fb_checknode(vr, q)
            want = fb_checknode_topk(vr, q)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            exact = torch.equal(got, want) and got.dtype == vr.dtype
            print(f"fb_checknode dense (nm = q) {kind} T={t} dc={dc} q={q}: "
                  f"bit-exact={exact} max_abs_err={err}", flush=True)
            check(exact, f"fb_checknode nm = q != plain at {(t, dc, q)} "
                         f"{kind}")
            worst = max(worst, err)
            del vr, got, want
    t = 128 * SLICE_ROWS
    rin, rout, valid = main["layered"]
    x = rows_input(t, 4, 256, "uniform", seed=9)
    fns = {"kernel": lambda: cuda_cn.ems_rows(x, rin, rout, valid, 256,
                                              OFFSET, False, dense=True),
           "plain": lambda: cuda_cn.ems_rows_plain(x, rin, rout, valid, 256,
                                                   OFFSET, False,
                                                   dense=True)}
    got = collections.defaultdict(list)
    for name in ("plain", "kernel", "kernel", "plain"):
        got[name].append(time_ms(fns[name], 5 if name == "kernel" else 1))
    b_ms, b_by = ems_bound_ms(t, SLICE_ROWS, 4, 256, 256)
    floor = issue_floor_ms(t, 4, 256)
    times = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                 bound_by=b_by, rows=t, floor=floor)
    print(f"ems_rows dense layered T={t} G={SLICE_ROWS} dc=4 q=256 (the "
          f"dense mode): kernel "
          + " / ".join(f"{v:.4f}" for v in got["kernel"])
          + " ms, plain (fb_checknode_dense) "
          + " / ".join(f"{v:.4f}" for v in got["plain"])
          + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
          f"{100 * b_ms / times['kernel']:.2f}% of it; issue floor "
          f"{floor:.4f} ms (an add and a minimum a candidate), kernel at "
          f"{100 * floor / times['kernel']:.2f}% of it", flush=True)
    del x, fns
    # the workspace: dense rows of dc = 40, 20 tables' worth of padded rows
    t, g, dc = 4000, 40, 40
    rin, rout, valid = odd_tables(g, dc, 256, seed=77)
    x = rows_input(t, dc, 256, "uniform", seed=10)
    fns = {"kernel": lambda: cuda_cn.ems_rows(x, rin, rout, valid, 200,
                                              OFFSET, True, dense=True),
           "plain": lambda: cuda_cn.ems_rows_plain(x, rin, rout, valid, 200,
                                                   OFFSET, True,
                                                   dense=True)}
    got = collections.defaultdict(list)
    for name in ("plain", "kernel", "kernel", "plain"):
        got[name].append(time_ms(fns[name], 3 if name == "kernel" else 1))
    b_ms, b_by = ems_bound_ms(t, g, dc, 256, 256)
    floor = issue_floor_ms(t, dc, 256)
    times["ws"] = dict({k: sum(v) / 2 for k, v in got.items()}, bound=b_ms,
                       bound_by=b_by, rows=t, dc=dc, floor=floor)
    print(f"ems_rows dense workspace T={t} G={g} dc={dc} q=256 nm=200: "
          f"kernel " + " / ".join(f"{v:.4f}" for v in got["kernel"])
          + " ms, plain " + " / ".join(f"{v:.4f}" for v in got["plain"])
          + f" ms per call; bound {b_ms:.4f} ms ({b_by}), kernel at "
          f"{100 * b_ms / times['ws']['kernel']:.2f}% of it; issue floor "
          f"{floor:.4f} ms, kernel at "
          f"{100 * floor / times['ws']['kernel']:.2f}% of it", flush=True)
    del x, fns
    # the bare entry on bf16 rows (converted to f32 and back around the
    # kernel) in turns with it on the same rows in f32, layered shape
    t, dc, q, nm = KERNEL_SHAPES[1]
    vr = kernel_input(t, dc, q, nm, "uniform", seed=11)
    vb = vr.to(BF16)
    fns = {"bf16": lambda: cuda_cn.fb_checknode(vb, nm),
           "f32": lambda: cuda_cn.fb_checknode(vr, nm)}
    got = collections.defaultdict(list)
    for name in ("f32", "bf16", "bf16", "f32"):
        got[name].append(time_ms(fns[name], 5))
    b_ms, b_by = bound(2 * 2 * t * dc * q, 2 * t * 3 * (dc - 2) * nm * q)
    times["bare"] = dict({k: sum(v) / 2 for k, v in got.items()},
                         bf16_bound=b_ms, bf16_bound_by=b_by, rows=t)
    print(f"fb_checknode bare T={t} dc={dc} q={q} nm={nm}: bf16 rows "
          + " / ".join(f"{v:.4f}" for v in got["bf16"]) + " ms, f32 rows "
          + " / ".join(f"{v:.4f}" for v in got["f32"]) + " ms per call; "
          f"bf16 bound {b_ms:.4f} ms ({b_by})", flush=True)
    del vr, vb, fns
    torch.cuda.empty_cache()
    return worst, times


BF16 = torch.bfloat16
# K2 on a bf16 state (3b): its f32 arithmetic agrees with the plain
# version's to f32 rounding only, so a store may land one bf16 ulp apart
# where the two f32 values straddle a rounding boundary.  Held where the
# plain cost is <= SPA_COST_MAX (past ~12 the f32 costs are themselves
# rounding noise): within one bf16 ulp (of the larger value) or within the
# f32 check's SPA_COST_ATOL (near 0, where bf16 keeps f32's tiny
# differences: 1e-6 against 0 is thousands of ulps); everywhere exp(-cost)
# within SPA_PROB_ATOL plus what one ulp moves a probability (exp(-c)
# ulp(c) <= c exp(-c) 2^-7 <= 2^-7 / e); frozen frames, untouched rows and
# padding bit for bit.
SPA_BF16_PROB_ATOL = SPA_PROB_ATOL + 2.0 ** -7 / np.e
BF16_PHASES = {"spa_layer": "3b", "syndrome_layer": "3c",
               "bubble_layer": "3e"}


def bf16_state(state, cols, edges, seed):
    """A layered f32 ``state`` (``syn_state``) rounded to bf16, as a bf16
    decoder holds it, with entries seeded on the layer's real slots that a
    bf16 state can hold: the sentinels INF_COST = 1e9 and BIG = 1e5 (in
    bf16 998,244,352 and 99,840) in APP rows, in CtoV rows and in both rows
    of a slot, and saturated CtoV rows (the best symbol 0, the others at one
    level) whose APP rows hold that level plus 1.5."""
    app, ctov, active = state
    app, ctov = app.to(BF16), ctov.to(BF16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f, n1, q = app.shape
    real = cols.long() < n1 - 1
    c, e = cols.long()[real], edges.long()[real]

    def pick(k):
        return (torch.randint(0, f, (k,), generator=gen, device="cuda"),
                torch.randint(0, len(c), (k,), generator=gen, device="cuda"),
                torch.randint(0, q, (k,), generator=gen, device="cuda"))

    for v in (1e9, 1e5):
        fr, s, sy = pick(16)
        app[fr, c[s], sy] = v
        fr, s, sy = pick(16)
        ctov[fr, e[s], sy] = v
        fr, s, sy = pick(16)
        app[fr, c[s], sy] = v
        ctov[fr, e[s], sy] = v / 2
    fr, s, best = pick(16)
    sat = (1 + 9 * torch.rand((16, 1), generator=gen, device="cuda")
           ).expand(16, q).clone()
    sat[torch.arange(16, device="cuda"), best] = 0
    ctov[fr, e[s]] = sat.to(BF16)
    app[fr, c[s]] = (sat + 1.5).to(BF16)
    return app, ctov, active


def bf16_ulps(a, b):
    """|a - b| of two bf16 tensors in bf16 ulps of the larger magnitude
    (f32)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def check_bf16_case(entry, label, state, cols, edges, valid, fused, plain,
                    exact):
    """One fused entry on a bf16 ``state`` against its plain version on
    clones: frozen frames, rows the layer does not own and the padding
    column and edge keep their bits; with ``exact`` (K7, K9) the two are
    equal bit for bit everywhere, else (K2) the rule written at
    ``SPA_BF16_PROB_ATOL`` holds.  Returns (largest error: of exp(-cost)
    (K2) or absolute (exact), entries that differ, entries written)."""
    app, ctov, active = state
    out = {}
    for name, fn in (("fused", fused), ("plain", plain)):
        a, c = app.clone(), ctov.clone()
        fn(a, c, active)
        out[name] = (a, c)
    torch.cuda.synchronize()
    (a_k, c_k), (a_p, c_p) = out["fused"], out["plain"]
    real = (torch.ones(cols.shape, dtype=torch.bool, device="cuda")
            if valid is None else valid) & (cols < app.shape[1] - 1)
    cols_r, edges_r = cols[real].long(), edges[real].long()
    own_c = torch.zeros(app.shape[1], dtype=torch.bool, device="cuda")
    own_e = torch.zeros(ctov.shape[1], dtype=torch.bool, device="cuda")
    own_c[cols_r], own_e[edges_r] = True, True
    frozen = ~active
    kept = (torch.equal(a_k[frozen], app[frozen])
            and torch.equal(c_k[frozen], ctov[frozen])
            and torch.equal(a_k[:, ~own_c], app[:, ~own_c])
            and torch.equal(c_k[:, ~own_e], ctov[:, ~own_e]))
    ga, gc = a_k[active][:, cols_r], c_k[active][:, edges_r]
    wa, wc = a_p[active][:, cols_r], c_p[active][:, edges_r]
    differing = int((ga != wa).sum()) + int((gc != wc).sum())
    written = ga.numel() + gc.numel()
    finite = bool(torch.isfinite(a_k.float()).all()
                  and torch.isfinite(c_k.float()).all())
    f, (g, dc), q = app.shape[0], cols.shape, app.shape[2]
    head = (f"{entry} bf16 {label} F={f} G={g} dc={dc} q={q} frozen "
            f"{int(frozen.sum())} padding slots={int((~real).sum())}")
    if exact:
        same = torch.equal(a_k, a_p) and torch.equal(c_k, c_p)
        err = max(float((a_k.float() - a_p.float()).abs().max()),
                  float((c_k.float() - c_p.float()).abs().max()))
        print(f"{head}: bit-exact={same} max_abs_err={err}; frozen/"
              f"untouched/padding bit-equal={kept}", flush=True)
        check(same and kept, f"{entry} bf16 != plain at {label}")
        return err, differing, written
    likely = wc.float() <= SPA_COST_MAX
    band, outside = 0.0, 0
    for g_, w_ in ((ga, wa), (gc, wc)):
        ulps = bf16_ulps(g_, w_)[likely]
        diff = (g_.float() - w_.float()).abs()[likely]
        if ulps.numel():
            band = max(band, float(ulps.max()))
            outside += int(((ulps > 1) & (diff > SPA_COST_ATOL)).sum())
    anywhere = max(float(bf16_ulps(ga, wa).max()),
                   float(bf16_ulps(gc, wc).max()))
    prob_err = float((torch.exp(-gc.float()) - torch.exp(-wc.float()))
                     .abs().max())
    print(f"{head}: where plain cost <= {SPA_COST_MAX:g} at most {band:.3g} "
          f"ulps, entries past one ulp and {SPA_COST_ATOL:g} {outside} "
          f"(anywhere at most {anywhere:.3g} ulps); entries differing "
          f"{differing} of {written}; exp(-cost) err {prob_err:.3e}; frozen/"
          f"untouched/padding bit-equal={kept}; finite={finite}", flush=True)
    check(kept and finite and outside == 0
          and prob_err <= SPA_BF16_PROB_ATOL,
          f"{entry} bf16 outside its tolerance at {label}")
    return prob_err, differing, written


def time_bf16(entry, f32_call, bf16_call, bounds):
    """The fused entry on an f32 and on a bf16 state (copies of one state,
    all frames active) in turns, f32, bf16, bf16, f32 (compared within one
    call only), beside the two bounds; returns the means and bounds."""
    got = collections.defaultdict(list)
    for name in ("f32", "bf16", "bf16", "f32"):
        got[name].append(time_ms(f32_call if name == "f32" else bf16_call,
                                 10))
    ms = {k: sum(v) / 2 for k, v in got.items()}
    print(f"{entry} F=128: f32 state "
          + " / ".join(f"{v:.4f}" for v in got["f32"])
          + f" ms (bound {bounds['f32'][0]:.4f} ms, {bounds['f32'][1]}), "
          "bf16 state " + " / ".join(f"{v:.4f}" for v in got["bf16"])
          + f" ms (bound {bounds['bf16'][0]:.4f} ms, {bounds['bf16'][1]}, "
          f"at {100 * bounds['bf16'][0] / ms['bf16']:.2f}% of it) per call",
          flush=True)
    return {"f32_ms": ms["f32"], "bf16_ms": ms["bf16"],
            "bf16_bound_ms": bounds["bf16"][0],
            "bf16_bound_by": bounds["bf16"][1]}


def check_bf16_layers(graph, entry):
    """3b / 3c / 3e on a bf16 state: the fused entry (``entry``: spa_layer,
    syndrome_layer or bubble_layer, both variants) against its plain
    version on the real code's three layer plans at F = 128 and on the odd
    layers with padded slots of the f32 checks (SPA_LAYER_ODD, SYN_ODD,
    BUBBLE_ODD), from decoder-like and "ties" states seeded with sentinel
    and saturated entries (``bf16_state``), about a quarter of the frames
    frozen; then the entry timed on the f32 and the bf16 state in turns at
    F = 128.  Returns the worst error, the entries that differ and were
    written, and the times."""
    phase(f"{BF16_PHASES[entry]} {entry} on a bf16 state against its bf16 "
          "plain version")
    code = graph.code
    plans = _layer_plan(graph, "cuda")
    n1, e1 = code.n + 1, graph.n_edges + 1
    syn_main = _syndrome_tables(4, 32, syn_key({}), "cuda")

    def calls(layer, q, cn):
        """(fused, plain) of ``entry`` on one layer's tables."""
        cols, edges, coefs, rin, rout, valid = layer
        if entry == "spa_layer":
            t_tab, tinv_tab = spa_tables(q)
            args = (cols, edges, coefs, t_tab, tinv_tab)
            return ((lambda a, c, act: spa_layer(a, c, act, *args)),
                    (lambda a, c, act: spa_layer_plain(a, c, act, *args)))
        args = (cols, edges, rin, rout, valid)
        if entry == "syndrome_layer":
            tabs, rest = cn
            return ((lambda a, c, act: cuda_syndrome.syndrome_layer(
                        a, c, act, *args, *rest, tabs["lists"])),
                    (lambda a, c, act: cuda_syndrome.syndrome_layer_plain(
                        a, c, act, *args, *rest)))
        return ((lambda a, c, act: cuda_bubble.bubble_layer(
                    a, c, act, *args, *cn)),
                (lambda a, c, act: cuda_bubble.bubble_layer_plain(
                    a, c, act, *args, *cn)))

    def settings(i, q, dc):
        """The CN settings of odd case i (None: the main path's)."""
        if entry == "spa_layer":
            return [None]
        if entry == "syndrome_layer":
            if i is None:
                return [(syn_main, (syn_main["table"], syn_main["kth"], 32,
                                    OFFSET, True, True))]
            _, _, _, _, nm, kw, bayes, presort = SYN_ODD[i]
            t = _syndrome_tables(dc, nm, syn_key(kw), "cuda")
            return [(t, (t["table"], t["kth"], nm, OFFSET, bayes, presort))]
        if i is None:
            return [(BUBBLE_NM, BUBBLE_OPS, OFFSET, True, True, v)
                    for v in ("8", "L")]
        _, _, _, _, nm, ops, trunc, off = BUBBLE_ODD[i]
        return [(nm, ops, off, trunc, trunc, v) for v in ("8", "L")]

    cases = []
    for k, p in enumerate(plans):
        cases.append((f"layer {k}", 128, n1, e1, (
            p["cols32"], p["edge_ids32"], p["coefs"], p["rot_in8"],
            p["rot_out8"], p["valid"]), code.q, None, KINDS[k % 2]))
    odd = {"spa_layer": [(f, g, dc, q, pads) for f, g, dc, q, pads
                         in SPA_LAYER_ODD],
           "syndrome_layer": [(t // g, g, dc, q, 3) for t, g, dc, q, *_
                              in SYN_ODD],
           "bubble_layer": [(t // g, g, dc, q, 3) for t, g, dc, q, *_
                            in BUBBLE_ODD]}[entry]
    for i, (f, g, dc, q, pads) in enumerate(odd):
        cols, edges, coefs, n1o, e1o = odd_layer(g, dc, q, pads,
                                                 seed=1300 + i)
        rin, rout = (torch.as_tensor(
            rotation_table(coefs.cpu().numpy(), get_gf(q), d)
            .reshape(g, dc, q).astype(np.uint8), device="cuda")
            for d in ("in", "out"))
        for kind in KINDS:
            cases.append(("odd", f, n1o, e1o, (cols, edges, coefs, rin, rout,
                                               coefs != 0), q, i, kind))
    worst, differing, written = 0.0, 0, 0
    for j, (label, f, n1c, e1c, layer, q, i, kind) in enumerate(cases):
        cols, edges = layer[:2]
        state = bf16_state(syn_state(f, n1c, e1c, q, cols, edges,
                                     "decoder" if kind == "uniform"
                                     else kind, seed=1400 + j),
                           cols, edges, seed=1500 + j)
        for cn in settings(i, q, layer[0].shape[1]):
            fused, plain = calls(layer, q, cn)
            name = entry if entry != "bubble_layer" else \
                f"bubble_layer variant {cn[-1]}"
            err, d, w = check_bf16_case(name, f"{label} {kind}", state,
                                        cols, edges, layer[5], fused, plain,
                                        exact=entry != "spa_layer")
            worst, differing, written = (max(worst, err), differing + d,
                                         written + w)
        del state
    p = plans[0]
    layer = (p["cols32"], p["edge_ids32"], p["coefs"], p["rot_in8"],
             p["rot_out8"], p["valid"])
    g, dc = p["cols32"].shape
    app, ctov, _ = spa_state(128, n1, e1, code.q, p["cols"], p["edge_ids"],
                             seed=7)
    active = torch.ones(128, dtype=torch.bool, device="cuda")
    fused, _ = calls(layer, code.q, settings(None, code.q, dc)[0])
    f32, b16 = (app.clone(), ctov.clone()), (app.to(BF16), ctov.to(BF16))
    del app, ctov

    def bound_ms(elem):
        if entry == "spa_layer":
            return spa_layer_bound_ms(128, g, dc, code.q, elem)
        if entry == "syndrome_layer":
            return syn_layer_bound_ms(128, g, dc, code.q, syn_main["table"],
                                      elem)
        return bub_layer_bound_ms(128, g, dc, code.q, BUBBLE_OPS, elem)

    bounds = {"f32": bound_ms(4), "bf16": bound_ms(2)}
    times = time_bf16(entry, lambda: fused(*f32, active),
                      lambda: fused(*b16, active), bounds)
    what = "exp(-cost) err" if entry == "spa_layer" else "abs err"
    print(f"{entry} bf16: worst {what} {worst}; entries differing "
          f"{differing} of {written}", flush=True)
    del f32, b16
    torch.cuda.empty_cache()
    return dict(times, err=worst, differing=differing, written=written)


def bf16_fields(got):
    """A fused entry's bf16 figures for the kernels line: its time on a
    bf16 state and on the f32 state in the same turns at F = 128, the bf16
    bound, the worst error (K2: of exp(-cost); K7, K9: absolute, 0 when
    bit-exact) and the entries that differ."""
    return {"bf16_ms": got["bf16_ms"], "bf16_f32_ms": got["f32_ms"],
            "bf16_bound_ms": got["bf16_bound_ms"],
            "bf16_bound_by": got["bf16_bound_by"], "bf16_err": got["err"],
            "bf16_differing_entries": got["differing"],
            "bf16_written_entries": got["written"]}


def check_bubble_decodes(mc, dec):
    """5j: 16 frames of the bubble chain's first batch through K9 and
    through its plain version on the card (host loop), both variants:
    identical decisions, iterations and convergence; launches 3 a step on
    the kernel side, all of them ``bubble_layer``, none on the plain
    side."""
    phase("5j bubble kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    for impl in ("bubble", "lbubble"):
        outs = {}
        for plain in (False, True):
            reset_launches()
            d, it, conv = decode_layered_hostloop(
                mc.graph, intr16, dec.max_iters, nm=dec.nm,
                offset=dec.offset, cn=dec.cn, cn_impl=impl,
                nboper=dec.nboper, plain=plain)
            outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                           read_host_launches("5j"))
        (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
        same = (torch.equal(d_k, d_p) and torch.equal(it_k, it_p)
                and torch.equal(c_k, c_p))
        steps = int(it_k.max())
        print(f"{impl} F=16: identical decisions/iterations/convergence: "
              f"{same}; iters {it_k.tolist()}; launches kernel {l_k}, plain "
              f"{l_p}", flush=True)
        check(same, f"{impl}: kernel and plain decodes differ")
        check(l_k["bubble_checknode"] == l_k["bubble_layer"]
              == LAYERS * steps > 0
              and sum(cn_launches(l_k).values())
              == 2 * l_k["bubble_checknode"]
              and l_k["decide_rows"] == steps + 1
              and sum(l_p.values()) == 0,
              f"{impl} launches {l_k} (plain {l_p}) for {steps} steps")


def check_list_decodes(graph, intr, dec, n_layers):
    """5l: 16 frames of ``intr`` decoded (host loop) through K3 (3
    ``list_layer`` launches a step) and through ``list_layer_plain`` on the
    card (no launch), at ``dec``'s settings, then with nbOper = 0 (the
    exact merge, on the fast step's exact form), with nm = 65 (the
    staircase past the fast step, on the general step) and, on 4 frames
    (the plain version's exact merges hold [F, 1350, q * q] candidates),
    with nm = q and nbOper = 0 (4l's settings: the general step's dense
    form): identical decisions, iterations and convergence, the frames
    that differ printed.  Returns the kernel side's launches by label."""
    phase("5l list-EMS kernel vs plain decode at full width")
    intr = intr[:16].to(dec.torch_dtype()).contiguous()
    ran = {}
    for label, change, frames in (
            ("", {}, 16), ("nboper=0", dict(nboper=0), 16),
            ("nm=65", dict(nm=65), 16),
            ("nm=q", dict(nm=graph.q, nboper=0), 4)):
        cfg = dataclasses.replace(dec, **change)
        outs = {}
        for plain in (False, True):
            reset_launches()
            outs[plain] = tuple(x.cpu() for x in decode_layered_list_hostloop(
                graph, intr[:frames], cfg.max_iters, cfg.nm, cfg.offset,
                cfg.nboper, cfg.torch_dtype(), plain=plain)) + (
                read_host_launches(f"5l {label}"),)
        (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
        differ = ((d_k != d_p).any(dim=1) | (it_k != it_p) | (c_k != c_p))
        steps = int(it_k.max())
        where = cuda_list.path(graph.code.dc_max, graph.q, cfg.nm,
                               cfg.nboper)
        print(f"F={frames} nm={cfg.nm} nbOper={cfg.nboper} ({where} path): "
              f"frames whose decisions, iterations or convergence differ: "
              f"{differ.nonzero().flatten().tolist()}; iters "
              f"{it_k.tolist()}; converged {int(c_k.sum())}/{frames}; "
              f"launches kernel {l_k}, plain {l_p}", flush=True)
        check(not bool(differ.any()),
              f"list-EMS kernel and plain decodes differ {label}")
        check(l_k["list_layer"] == n_layers * steps > 0
              and sum(cn_launches(l_k).values()) == l_k["list_layer"]
              and l_k["decide_rows"] == steps + 1
              and sum(l_p.values()) == 0,
              f"list-EMS launches {l_k} (plain {l_p}) for {steps} steps "
              f"{label}")
        ran[label or "bench"] = l_k["list_layer"]
    return ran


def check_native(mc, dec, frames=32):
    """5k: the chain's first ``frames`` frames through K9 (the default
    device loop) and through the C++ core (f64 intrinsics): the share of
    frames decided identically, identical decisions on every frame both
    call converged, both FERs.  Returns the numbers."""
    phase("5k against the C++ core")
    lib, seconds = native.build()
    print(f"g++ nbldpc_core.cpp {seconds:.2f} s", flush=True)
    cw, intr = mc.gen(0)
    cw, intr = cw[:frames].contiguous(), intr[:frames].contiguous()
    d, it, conv = (x.cpu().numpy() for x in decode(mc.graph, intr, dec))
    t0 = time.perf_counter()
    nd, ni, nc = native.decode_batch(mc.code, intr.double().cpu().numpy(),
                                     dec.max_iters, dec.nm, dec.offset,
                                     dec.nboper)
    seconds = time.perf_counter() - t0
    cw = cw.cpu().numpy()
    same = (d == nd).all(axis=1)
    both = conv & nc
    agree = bool((d[both] == nd[both]).all())
    fer = (float((d != cw).any(axis=1).mean()),
           float((nd != cw).any(axis=1).mean()))
    out = {"frames": frames, "identical": int(same.sum()),
           "both_converged": int(both.sum()),
           "identical_where_both_converged": agree,
           "fer_port": fer[0], "fer_core": fer[1],
           "iters_port": round(float(it.mean()), 4),
           "iters_core": round(float(ni.mean()), 4),
           "core_s": round(seconds, 3)}
    print(f"F={frames}: decisions identical on {int(same.sum())}/{frames} "
          f"frames; both converged on {int(both.sum())} (port {int(conv.sum())}"
          f", core {int(nc.sum())}), identical there: {agree}; FER port "
          f"{fer[0]:.4f}, core {fer[1]:.4f}; mean iterations port "
          f"{out['iters_port']}, core {out['iters_core']} (the core's "
          f"decode {seconds:.2f} s on the host)", flush=True)
    check(agree, "K9 and the C core decide differently on a frame both "
          "call converged")
    check(both.sum() > 0, "no frame converged on both sides")
    return out


def profile_batch(mc, tag, out_dir="profile_out", big=None):
    """Trace one Monte-Carlo batch, after an untraced one (which holds the
    device loop's capture if the loop is new); print the device busy share
    and the device time by kernel (from the exported chrome trace).
    Returns them with the batch's decoder steps, the number of
    ``ems_rows_kernel``, ``spa_row_kernel``, ``syndrome_kernel`` and
    ``demap_kernel`` launches in the trace and K8's share of the kernel
    time.  With ``big`` (a shape), the trace records input shapes and
    returns the torch ops that took a tensor of that shape."""
    from torch.profiler import ProfilerActivity, profile

    phase(f"profile one batch: {tag}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_batch_{tag}.json")
    mc.step(0)[0].cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=big is not None) as prof:
        t0 = time.perf_counter()
        counters = mc.step(0)[0].cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    spans = []
    for e in kernels:
        by_name[e["name"][:90]] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(by_name.values())
    topk = sum(1 for e in kernels
               if "gatherTopK" in e["name"] or "bitonicSort" in e["name"])
    print(f"wall {wall_us / 1e3:.3f} ms; {len(kernels)} kernels; device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f}% of wall "
          f"(idle {100 - 100 * busy / wall_us:.2f}%); torch.topk kernels "
          f"(gatherTopK, bitonicSort) {topk}")
    for name, us in by_name.most_common(15):
        print(f"{us / 1e3:10.3f} ms {100 * us / total:6.2f}%  {name}")
    traced = {k: sum(1 for e in kernels if k in e["name"])
              for k in ("ems_rows_kernel", "spa_row_kernel",
                        "syndrome_kernel", "demap_kernel", "bubble_kernel",
                        "list_kernel")}
    demap_us = sum(us for name, us in by_name.items()
                   if "demap_kernel" in name)
    big_ops = sorted({e["name"] for e in events if e.get("cat") == "cpu_op"
                      and big is not None and list(big) in
                      e.get("args", {}).get("Input Dims", [])})
    # torch's index kernels (gathers, index_put scatters)
    index_us = sum(e["dur"] for e in kernels
                   if any(w in e["name"].lower()
                          for w in ("index", "gather", "scatter")))
    print(f"decoder steps {int(counters[5])}; kernels in the trace {traced}; "
          f"index/gather/scatter kernels {index_us / 1e3:.3f} ms = "
          f"{100 * index_us / max(total, 1):.2f}% of kernel time; demap "
          f"kernel {demap_us / 1e3:.3f} ms = "
          f"{100 * demap_us / max(total, 1):.2f}%"
          + (f"; torch ops on a {list(big)} tensor: {big_ops}"
             if big is not None else ""), flush=True)
    def share(*words):
        us = sum(e["dur"] for e in kernels
                 if any(w in e["name"] for w in words))
        return round(100 * us / max(total, 1), 2)

    return {"wall_ms": round(wall_us / 1e3, 3),
            "busy_pct": round(100 * busy / wall_us, 2), "topk_kernels": topk,
            "spa_pct": share("spa_row_kernel"),
            "list_pct": share("list_kernel"),
            "argmin_pct": share("ArgMin", "argmin"),
            "decide_pct": share("decide_kernel"),
            "steps": int(counters[5]), "traced": traced,
            "index_pct": round(100 * index_us / max(total, 1), 2),
            "demap_pct": round(100 * demap_us / max(total, 1), 2),
            "big_ops": big_ops,
            "spa_kernels": sorted({e["name"] for e in kernels
                                   if "spa_" in e["name"]}),
            "syn_kernels": sorted({e["name"] for e in kernels
                                   if "syndrome_kernel" in e["name"]}),
            "bub_kernels": sorted({e["name"] for e in kernels
                                   if "bubble_kernel" in e["name"]})}


def check_traced(prof, kernel, per_step, what):
    """The trace holds ``per_step`` launches of ``kernel`` per decoder step
    of its batch (the device loop's replays, seen by the tracer)."""
    check(prof["traced"][kernel] == per_step * prof["steps"] > 0,
          f"{what}: {prof['traced'][kernel]} {kernel} in the trace for "
          f"{prof['steps']} steps, expected {per_step} per step")


SPIN_CYCLES = 10 ** 8      # ~50 ms of one spinning thread on an H100


def batch_split(mc, batches=2):
    """Untraced, for batches 0..``batches``-1: the batch step's host wall
    time (gen, decode, count and the counters' copy to the host, called as
    ``MonteCarlo.step`` calls them), then its device time: the same step
    again behind a spin kernel that keeps the card busy while the host
    queues the batch, with CUDA events around its gen, decode and count,
    so that the spans hold no gap the host made.  That holds when the host
    queued the whole batch within the spin ("queued"), which a step with a
    host read inside (the host loop) cannot.  The card's idle share of a
    batch is then 1 - device time / wall, given per batch (the host's
    clock varies more than the card's).  Returns the means (ms), each
    batch's device time (ms) and idle share (%), and whether every batch
    was queued in time."""
    got = collections.defaultdict(list)
    queued = True
    for b in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc.step(b)[0].cpu()
        got["wall"].append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        cw, intr = mc.gen(b)
        ev[2].record()
        decide, iters, conv = decode(mc.graph, intr, mc.cfg.decoder)
        ev[3].record()
        counters, _ = mc.count(decide, cw, iters, conv)
        ev[4].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        counters.cpu()
        queued = queued and host_ms < ev[0].elapsed_time(ev[1])
        for i, part in enumerate(("gen", "decode", "count"), start=1):
            got[part].append(ev[i].elapsed_time(ev[i + 1]))
    ms = {k: sum(v) / len(v) for k, v in got.items()}
    device = [sum(got[k][b] for k in ("gen", "decode", "count"))
              for b in range(batches)]
    idle = [100 * (1 - d / w) for d, w in zip(device, got["wall"])]
    print("untraced batch: " + ", ".join(
        f"{k} " + " / ".join(f"{x:.3f}" for x in v) + " ms"
        for k, v in got.items())
        + "; device time " + " / ".join(f"{d:.3f}" for d in device)
        + " ms; idle share " + " / ".join(f"{x:.2f}" for x in idle)
        + f" % (queued within the spin: {queued})", flush=True)
    return dict({k: round(v, 3) for k, v in ms.items()},
                device=[round(d, 3) for d in device],
                idle_pct=[round(x, 2) for x in idle], queued=queued)


def run_chain(name, code, enc, dec, ebn0, mc=None, channel=ChannelSpec()):
    """Warm-up run (skipped when ``mc`` is given: a second timed run), then
    a timed run of 256 frames at F = 128 with every launch count set to 0
    just before it, then ``batch_split``.  Checks that the timed run made
    or replaced no device loop, and its launches: under the device loop
    none eager and, counted by the kernels on the card, the loop's
    launches per step times the decoder steps; under the host loop the
    same numbers eager and on the card; K8 (the demapper, in the batch's
    eager generation) once a batch on a non-BPSK ``channel`` and never on
    BPSK, eager and on the card alike.  Memory: the allocator's live and
    reserved peaks during the timed run (the device loop's graph pool is
    reserved memory).  K4 (``decide_rows``): one launch a layered step and
    one a batch's reset, which the device loop runs eagerly, outside its
    graph.  Returns (MonteCarlo, result, {check-node kernel: launches
    counted on the card}: ``cn_launches``, K4's checked here)."""
    if mc is None:
        cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=128, max_frames=256,
                        stop_errors=10**9, encode="device", decoder=dec,
                        channel=channel)
        t0 = time.perf_counter()
        mc = MonteCarlo(code, cfg, enc, device="cuda")
        print(f"generator upload {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        warm = mc.run()
        print(f"warm-up ({dec.loop} loop; {time.perf_counter() - t0:.2f} s, "
              f"capture included): {warm.frames} frames, FER "
              f"{warm.frame_errors}/{warm.frames}, avg_it "
              f"{warm.avg_iters:.3f}", flush=True)
    torch.cuda.synchronize()
    loop = device_loop.last()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = mc.run()
    launches, eager = read_launches(), read_eager()
    demap = (cuda_demap.device_launches(), cuda_demap.launches)
    k4 = (launches["decide_rows"], cuda_decide.device_rows())
    live = torch.cuda.max_memory_allocated()
    held = torch.cuda.max_memory_reserved()
    lp = device_loop.last()
    pool = lp.pool_bytes if lp is not None else 0
    lo, hi = res.fer_ci
    print(f"{name} timed: {res.frames} frames in {res.elapsed_s:.3f} s = "
          f"{res.frames_per_s:.3f} frames/s; avg_it {res.avg_iters:.4f}; "
          f"FER {res.frame_errors}/{res.frames} = {res.fer:.4f} "
          f"[{lo:.4f}, {hi:.4f}]; BER {res.ber:.3e}; decoder steps "
          f"{res.decoder_steps}; launches counted by the kernels {launches}, "
          f"eager {eager}; demap (K8) launches counted by the kernel / eager "
          f"{demap[0]} / {demap[1]}; decisions (K4) launches / rows "
          f"{k4[0]} / {k4[1]}; peak memory live {live / 2**30:.3f} GiB, "
          f"reserved {held / 2**30:.3f} GiB (graph pool "
          f"{pool / 2**30:.3f})", flush=True)
    split = batch_split(mc)
    SUMMARY.setdefault(name, []).append({
        "loop": dec.loop, "fps": round(res.frames_per_s, 3),
        "avg_it": round(res.avg_iters, 4),
        "fer": f"{res.frame_errors}/{res.frames}",
        "fer_ci": [round(lo, 4), round(hi, 4)],
        "steps": res.decoder_steps, "demap_launches": demap[0],
        "k4_launches": k4[0], "k4_rows": k4[1],
        "live_gib": round(live / 2**30, 3),
        "reserved_gib": round(held / 2**30, 3),
        "pool_gib": round(pool / 2**30, 3), "untraced": split})
    check(res.frames == 256, f"{name}: {res.frames} frames, expected 256")
    check(res.avg_iters < dec.max_iters,
          f"{name}: avg_it {res.avg_iters} reached the budget")
    check(res.fer <= 0.25, f"{name}: FER {res.fer} > 0.25")
    check(lp is loop, f"{name}: the timed run made a device loop")
    batches = res.frames // 128
    want = batches if mc.cfg.channel.kind != "bpsk" else 0
    check(demap == (want, want), f"{name}: demap launches (card, eager) "
          f"{demap} for {batches} batches, expected {want} each")
    if want:
        DEMAP_PATHS[name] = demap[0]
    # K4: one launch a layered step and one a batch's reset, N rows a
    # decided frame: each step's active frames and the reset's every frame
    layered = dec.schedule == "layered"
    check(k4 == ((res.decoder_steps + batches,
                  code.n * (res.iter_sum + res.frames)) if layered else (0, 0)),
          f"{name}: K4 launches / rows {k4} for {res.decoder_steps} steps, "
          f"{res.iter_sum} iterations, {batches} batches")
    if dec.loop == "device":
        resets = {"decide_rows": batches * int(layered)}
        check(eager == {k: resets.get(k, 0) for k in eager},
              f"{name}: eager launches {eager} under the device loop")
        check(launches == {k: v * res.decoder_steps + resets.get(k, 0)
                           for k, v in lp.per_step.items()},
              f"{name}: launches {launches}, per step {lp.per_step}, "
              f"{res.decoder_steps} steps")
    else:
        check(launches == eager, f"{name}: launches counted by the kernels "
              f"{launches}, eager {eager}")
    return mc, res, cn_launches(launches)


def reset_launches():
    """Set both kinds of launch counts to 0 (synchronises the card)."""
    cuda_cn.launches = cuda_spa.launches = cuda_spa.layer_launches = 0
    cuda_syndrome.launches = cuda_syndrome.layer_launches = 0
    cuda_demap.launches = cuda_bubble.launches = 0
    cuda_bubble.layer_launches = cuda_list.launches = 0
    cuda_decide.launches = 0
    cuda_demap.reset_device_launches()
    cuda_bubble.reset_device_launches()
    cuda_cn.reset_device_launches()
    cuda_spa.reset_device_launches()
    cuda_syndrome.reset_device_launches()
    cuda_list.reset_device_launches()
    cuda_decide.reset_device_launches()


def cn_launches(launches) -> dict:
    """``launches`` (as ``read_launches`` gives them) without K4's: the
    check-node kernels'."""
    return {k: v for k, v in launches.items() if k != "decide_rows"}


def k4_host(dec, steps) -> dict:
    """K4's launches in a host-loop decode of ``dec`` that ran ``steps``
    steps: one a layered step and one at the reset, none in flooding."""
    return {"decide_rows": (steps + 1) * int(dec.schedule == "layered")}


def read_launches() -> dict:
    """Kernel launches by kernel, counted by the kernels themselves on the
    card (a graph's replays included); "spa_layer", "syndrome_layer" and
    "bubble_layer" are the parts of the SPA, syndrome and bubble kernels'
    launches made by their fused entries; "decide_rows" is K4's, the
    decisions kernel."""
    spa, layer = cuda_spa.device_launches()
    syn, syn_layer = cuda_syndrome.device_launches()
    bub, bub_layer = cuda_bubble.device_launches()
    return {"fb_checknode": cuda_cn.device_launches(),
            "spa_checknode": spa, "spa_layer": layer,
            "syndrome_checknode": syn, "syndrome_layer": syn_layer,
            "bubble_checknode": bub, "bubble_layer": bub_layer,
            "list_layer": cuda_list.device_launches(),
            "decide_rows": cuda_decide.device_launches()}


def read_eager() -> dict:
    """The wrappers' eager launches, by kernel as in ``read_launches``."""
    return {"fb_checknode": cuda_cn.launches,
            "spa_checknode": cuda_spa.launches,
            "spa_layer": cuda_spa.layer_launches,
            "syndrome_checknode": cuda_syndrome.launches,
            "syndrome_layer": cuda_syndrome.layer_launches,
            "bubble_checknode": cuda_bubble.launches,
            "bubble_layer": cuda_bubble.layer_launches,
            "list_layer": cuda_list.launches,
            "decide_rows": cuda_decide.launches}


def read_host_launches(what) -> dict:
    """The launches of host-loop work, where every launch is eager:
    counted by the kernels on the card, and checked equal to the
    wrappers' counts."""
    launches, eager = read_launches(), read_eager()
    check(launches == eager, f"{what}: launches counted by the kernels "
          f"{launches}, eager {eager}")
    return launches


def check_small_card_decodes():
    """5f: every ``cn_impl`` of the EMS and min-sum CNs on dense storage
    and the compressed dense-CN decoder through K1 on the card (the dense
    min-convolution: lists of all q entries; the compressed decoder: the
    bare entry, at f32 and bf16) against the same decodes on the CPU
    (plain versions there), from one set of intrinsics made on the CPU;
    the compressed decoder at bf16 against its plain route on the card
    (``plain``: torch's bf16 arithmetic rounds apart on the CPU and on the
    card, ROADMAP Queue 3).  Returns each decode's K1 launches."""
    phase("5f every EMS / min-sum cn_impl, the dense min-conv CN and the "
          "compressed dense-CN decoder through K1, card vs CPU")
    code = random_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=64, encode="device")
    _, intr = MonteCarlo(code, cfg, device="cpu").gen(0)
    base = DecoderConfig(max_iters=15, cn="ems", nm=8, offset=0.3,
                         loop="host", storage="dense", dtype="float32")
    layers = len(code.layers)
    graph = DeviceGraph.from_code(code)
    ran = {}
    for name, dec, per_step in (
            ("flooding minsum", dataclasses.replace(
                base, schedule="flooding", cn="minsum", nm=0), 1),
            ("layered minsum", dataclasses.replace(base, cn="minsum", nm=0,
                                                   cn_impl="auto"), layers),
            ("layered dense", dataclasses.replace(base, cn_impl="dense"),
             layers),
            ("flooding dense", dataclasses.replace(
                base, schedule="flooding", cn_impl="dense"), 1),
            ("layered auto nm=12", dataclasses.replace(base, nm=12), layers),
            ("layered auto", base, layers),
            ("flooding auto", dataclasses.replace(base, schedule="flooding"),
             1),
            ("layered topk", dataclasses.replace(base, cn_impl="topk"),
             layers),
            ("layered compressed topk", dataclasses.replace(
                base, cn_impl="topk", storage="compressed"), layers),
            ("layered compressed topk bf16", dataclasses.replace(
                base, cn_impl="topk", storage="compressed",
                dtype="bfloat16"), layers),
            ("flooding minsum pallas", dataclasses.replace(
                base, schedule="flooding", cn="minsum", cn_impl="pallas"), 1),
            ("layered minsum pallas", dataclasses.replace(
                base, cn="minsum", cn_impl="pallas"), layers)):
        reset_launches()
        card = [x.cpu() for x in decode(code, intr.cuda(), dec)]
        launches = read_host_launches(name)
        if dec.dtype == "bfloat16":
            ref = "the plain route on the card"
            reset_launches()
            host = [x.cpu() for x in decode_layered_compressed(
                graph, intr.cuda().to(torch.bfloat16), dec.max_iters, dec.nm,
                dec.offset, torch.bfloat16, plain=True)]
            check(sum(read_host_launches(name).values()) == 0,
                  f"{name}: the plain route launched a kernel")
        else:
            ref = "the CPU"
            host = decode(code, intr, dec)
        same = all(torch.equal(a, b) for a, b in zip(card, host))
        steps = int(card[1].max())
        print(f"{name}: identical decisions/iterations/convergence to "
              f"{ref} {same}; "
              f"iters max {steps} mean "
              f"{float(card[1].float().mean()):.4f}, converged "
              f"{int(card[2].sum())}/64; launches {launches}", flush=True)
        check(same, f"{name}: the card's decode and {ref}'s differ")
        check(steps > 1, f"{name}: uninformative batch")
        check(launches == {"fb_checknode": per_step * steps,
                           "spa_checknode": 0, "spa_layer": 0,
                           "syndrome_checknode": 0, "syndrome_layer": 0,
                           "bubble_checknode": 0, "bubble_layer": 0,
                           "list_layer": 0, **k4_host(dec, steps)},
              f"{name}: launched {launches} in {steps} steps")
        ran[f"{name} (5f)"] = launches["fb_checknode"]
    return ran


def check_demap_decodes(mc, spec, dec, what):
    """5h: 16 frames of a chain's first batch, one set of draws, demapped
    by K8 and by its plain version on the card: equal intrinsics, and
    identical decisions, iterations and convergence from the two host-loop
    decodes."""
    phase(f"5h demapper both ways: {what}")
    kinfo, kchan = batch_generators(mc.cfg.seed, 0, "cuda")
    cw = mc._make_codeword(kinfo, mc._pmat)[:16].contiguous()
    y, att, tab, inv, dims = modulated(
        kchan, cw, spec, mc.code.q,
        channels.sigma_for(spec, mc.cfg.ebn0_db, mc.code.rate))
    kernel, plain = demap_routes(dims)
    reset_launches()
    intr = {"kernel": kernel(y, att, tab, inv), "plain": plain(y, att, tab,
                                                                 inv)}
    k8 = (cuda_demap.device_launches(), cuda_demap.launches)
    err = float((intr["kernel"] - intr["plain"]).abs().max())
    outs = {k: [x.cpu() for x in decode(mc.graph, v, dataclasses.replace(
        dec, loop="host"))] for k, v in intr.items()}
    same = all(torch.equal(a, b) for a, b in zip(outs["kernel"],
                                                 outs["plain"]))
    print(f"F=16: intrinsics bit-equal {torch.equal(*intr.values())} "
          f"(max_abs_err {err}); identical decisions/iterations/convergence "
          f"{same}; iters {outs['kernel'][1].tolist()}; converged "
          f"{int(outs['kernel'][2].sum())}/16; K8 launches (card, eager) "
          f"{k8}", flush=True)
    check(err <= DEMAP_RTOL * float(intr["plain"].max()),
          f"{what}: K8 and plain intrinsics differ by {err}")
    check(same, f"{what}: decodes from K8 and plain intrinsics differ")
    check(k8 == (1, 1), f"{what}: K8 launches {k8}, expected 1")
    return err


def check_small_channel_decodes():
    """5i: small codes, draws made on the card and copied to the CPU: the
    intrinsics from K8 on the card and from the plain version on the CPU,
    and the host-loop decodes of both (through K1 on the card, its plain
    version on the CPU)."""
    phase("5i small codes over QAM / 64-APSK, card vs CPU")
    for (n, m, q), spec, snr, nm in (
            ((96, 48, 16), ChannelSpec(kind="qam", erasure_prob=0.1,
                                       sigma_convention="snr"), 9.0, 8),
            ((960, 480, 64), ChannelSpec(kind="apsk64", rayleigh=True,
                                         sigma_convention="snr"), 13.0, 16)):
        code = random_regular(n, m, q, seed=0)
        cfg = SimConfig(ebn0_db=snr, frames_per_batch=64, channel=spec)
        mc = MonteCarlo(code, cfg, device="cuda")
        kinfo, kchan = batch_generators(cfg.seed, 0, "cuda")
        cw = mc._make_codeword(kinfo, mc._pmat)
        z, u, erased = channels.channel_draws(kchan, cw.shape, spec, 2)
        tab = channels.table_for(spec, q)
        sigma = channels.sigma_for(spec, snr, code.rate)
        reset_launches()
        card = channels.channel_2d_from_draws(
            cw, torch.as_tensor(tab, device="cuda"), z, u, erased, sigma,
            spec.erasure_prob)
        k8 = cuda_demap.device_launches()
        host = channels.channel_2d_from_draws(
            cw.cpu(), torch.as_tensor(tab), z.cpu(),
            None if u is None else u.cpu(),
            None if erased is None else erased.cpu(), sigma,
            spec.erasure_prob)
        err = float((card.cpu() - host).abs().max())
        dec = DecoderConfig(max_iters=10, cn="ems", nm=nm, offset=0.3,
                            cn_impl="pallas", loop="host")
        got = [x.cpu() for x in decode(code, card, dec)]
        want = decode(code, host, dec)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"random_regular({n}, {m}, {q}) {spec.kind} "
              f"erasure {spec.erasure_prob} rayleigh {spec.rayleigh} at "
              f"{snr} dB, F=64: intrinsics bit-equal "
              f"{torch.equal(card.cpu(), host)} (max_abs_err {err}); "
              f"identical decisions/iterations/convergence {same}; iters "
              f"max {int(got[1].max())} mean {float(got[1].float().mean()):.4f}"
              f", converged {int(got[2].sum())}/64; K8 launches {k8}",
              flush=True)
        check(err <= DEMAP_RTOL * float(host.max()),
              f"5i {spec.kind}: card and CPU intrinsics differ by {err}")
        check(same, f"5i {spec.kind}: card and CPU decodes differ")
        check(k8 == 1, f"5i {spec.kind}: K8 launches {k8}, expected 1")
        del mc


def free(mc):
    """Drop the device loops (state buffers and graph pools) and a
    MonteCarlo's 4.2 GB generator matrix from the card."""
    device_loop.clear()
    del mc._pmat
    gc.collect()
    torch.cuda.empty_cache()


def memory_mark():
    """(allocated, reserved) bytes now, with the peaks reset to them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def check_loops(path, graph, intr, dec, per_step):
    """6: one batch through a fresh ``loop="device"`` (its capture), again
    through the same loop after every table cache was emptied and the
    freed memory refilled, and through ``loop="host"``: decisions,
    iterations and convergence bit-equal; the loop's launches per step as
    expected; the replay makes no eager launch and its kernels count per
    step x steps on the card, as the host loop's do eagerly and on the
    card.  Prints the wall time of one decode under each loop (the
    replay's and the host loop's), and each loop's memory: the live peak
    and the reserved growth of its first decode (state, the step's
    temporaries, and for the device loop its graph pool, reserved bytes
    apart).  Returns the steps and the replay's launches as the kernels
    counted them on the card."""
    phase(f"6 device loop vs host loop: {path}")
    device_loop.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mem = {}
    a0, r0 = memory_mark()
    first = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="device"))]
    lp = device_loop.last()
    mem["device"] = (torch.cuda.max_memory_allocated() - a0,
                     torch.cuda.max_memory_reserved() - r0)
    state = sum(t.nbytes for t in lp.state)
    # the graph reads its tables by address: drop every cached table and
    # hand the freed memory out again before the replay
    clear_tables()
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << k,), -7, dtype=torch.int64, device="cuda")
            for k in range(8, 27, 2) for _ in range(4)]
    reset_launches()
    t0 = time.perf_counter()
    second = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="device"))]
    wall_device = time.perf_counter() - t0
    counts = {"device": (read_launches(), read_eager())}
    same_loop = device_loop.last() is lp
    del junk
    gc.collect()
    torch.cuda.empty_cache()
    a0, r0 = memory_mark()
    reset_launches()
    t0 = time.perf_counter()
    host = [x.cpu() for x in decode(graph, intr, dataclasses.replace(
        dec, loop="host"))]
    wall_host = time.perf_counter() - t0
    mem["host"] = (torch.cuda.max_memory_allocated() - a0,
                   torch.cuda.max_memory_reserved() - r0)
    counts["host"] = (read_launches(), read_eager())
    same = all(torch.equal(a, b) for dev in (first, second)
               for a, b in zip(dev, host))
    steps = int(host[1].max())
    # K4: one launch a layered step, and one at a decode's reset, which the
    # device loop runs eagerly, outside its graph
    layered = int(dec.schedule == "layered")
    per_step = {**per_step, "decide_rows": layered}
    want = {k: per_step.get(k, 0) * steps for k in counts["host"][0]}
    want["decide_rows"] += layered
    resets = {k: layered if k == "decide_rows" else 0 for k in want}
    gib = 2 ** 30
    print(f"F={intr.shape[0]}: bit-equal decisions/iterations/convergence "
          f"{same}; steps {steps}; converged {int(host[2].sum())}/"
          f"{intr.shape[0]}; launches per step {lp.per_step}; launches "
          f"counted by the kernels / eager: replay {counts['device'][0]} / "
          f"{counts['device'][1]}, host loop {counts['host'][0]} / "
          f"{counts['host'][1]}; one decode: device loop "
          f"{wall_device * 1e3:.3f} ms, host loop {wall_host * 1e3:.3f} ms",
          flush=True)
    print(f"memory of a first decode: device loop live peak "
          f"{mem['device'][0] / gib:.3f} GiB (its state "
          f"{state / gib:.3f}), reserved growth {mem['device'][1] / gib:.3f} "
          f"GiB of which graph pool {lp.pool_bytes / gib:.3f}; host loop "
          f"live peak {mem['host'][0] / gib:.3f} GiB, reserved growth "
          f"{mem['host'][1] / gib:.3f} GiB", flush=True)
    SUMMARY.setdefault("memory", {})[path] = {
        "device_live_gib": round(mem["device"][0] / gib, 3),
        "device_reserved_gib": round(mem["device"][1] / gib, 3),
        "state_gib": round(state / gib, 3),
        "pool_gib": round(lp.pool_bytes / gib, 3),
        "host_live_gib": round(mem["host"][0] / gib, 3),
        "host_reserved_gib": round(mem["host"][1] / gib, 3)}
    check(same, f"{path}: device and host loops differ")
    check(same_loop, f"{path}: the second decode made a new loop")
    check(lp.per_step == {k: per_step.get(k, 0) for k in lp.per_step},
          f"{path}: launches per step {lp.per_step}, expected {per_step}")
    check(counts["device"] == (want, resets)
          and counts["host"] == (want, want),
          f"{path}: launches {counts} for {steps} steps")
    return steps, counts["device"][0]


def plain_decode(graph, intr, dec, plain=True):
    """The host-loop decode of ``dec`` on ``intr`` (cast to its dtype)
    through the kernels (``plain=False``) or through their plain versions on
    the card (``plain``: the SPA, syndrome and bubble steps' plain versions
    and the plain torch CN in place of K1)."""
    run = (decode_layered_hostloop if dec.schedule == "layered"
           else decode_flooding_hostloop)
    return run(graph, intr.to(dec.torch_dtype()), dec.max_iters, nm=dec.nm,
               offset=dec.offset, cn=dec.cn, cn_impl=dec.cn_impl,
               nboper=dec.nboper, plain=plain)


def check_bf16_path(path, graph, intr, dec, per_step, iters_within=0):
    """6 at dense bf16: ``dec`` at ``dtype="bfloat16"`` on 16 frames of
    ``intr``: the device loop against the host loop (``check_loops``), then
    the host-loop decode through the kernels against the same decode
    through their plain versions on the card (``plain_decode``): identical
    decisions and convergence, iteration counts within ``iters_within``,
    the kernels' launches per step times the steps, none on the plain
    side.  Returns the frames whose decisions differ."""
    dec = dataclasses.replace(dec, dtype="bfloat16")
    intr = intr[:16].contiguous()
    check_loops(f"{path} bf16", graph, intr, dec, per_step)
    outs = {}
    for plain in (False, True):
        reset_launches()
        outs[plain] = tuple(x.cpu() for x in plain_decode(graph, intr, dec,
                                                          plain)) + (
            read_host_launches(f"6 {path} bf16"),)
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    differing = int((d_k != d_p).any(dim=1).sum())
    it_diff = int((it_k - it_p).abs().max())
    steps = int(it_k.max())
    print(f"{path} bf16 F=16, kernel vs plain decode: frames whose "
          f"decisions differ {differing}; identical convergence "
          f"{torch.equal(c_k, c_p)}; iterations differ by at most {it_diff}"
          f"; converged {int(c_k.sum())}/16; launches kernel {l_k}, plain "
          f"{l_p}", flush=True)
    check(differing == 0 and torch.equal(c_k, c_p)
          and it_diff <= iters_within,
          f"{path} bf16: the kernel and plain decodes differ")
    k4 = k4_host(dec, steps)
    check(l_k == {k: per_step.get(k, 0) * steps + k4.get(k, 0) for k in l_k}
          and steps > 0
          and sum(l_p.values()) == 0,
          f"{path} bf16: launches {l_k} (plain {l_p}) for {steps} steps")
    return differing


def check_odd_batches(code, decs):
    """6b: a batch in which no frame converges (uniform random costs: the
    budget ends the loop) and one in which every frame converges at init
    (the all-zero word without noise: no step runs), F = 5, through each
    of ``decs`` ({path: (config, launches per step)}) under both loops."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    noise = 10 * torch.rand((5, code.n, code.q), generator=gen,
                            device="cuda")
    noise -= noise.min(dim=-1, keepdim=True).values
    clean = torch.full((5, code.n, code.q), 10.0, device="cuda")
    clean[..., 0] = 0
    graph = DeviceGraph.from_code(code)
    for path, (dec, per_step) in decs.items():
        for label, intr, steps in (("no frame converges", noise,
                                    dec.max_iters),
                                   ("all converge at init", clean, 0)):
            got, _ = check_loops(f"6b {path}, {label}", graph, intr, dec,
                                 per_step)
            check(got == steps, f"6b {path} {label}: {got} steps, "
                  f"expected {steps}")
    device_loop.clear()


# the check-node kernels' launch counts (read_launches' keys), and the one
# each fused entry's launches are a part of
CN_TOPS = ("fb_checknode", "spa_checknode", "syndrome_checknode",
           "bubble_checknode", "list_layer")
TOP_OF = {"spa_layer": "spa_checknode", "syndrome_layer": "syndrome_checknode",
          "bubble_layer": "bubble_checknode"}


def check_cli(code, paths):
    """7: the CLI at full width on the code written as a UBS file, with the
    SPA row's settings, with the syndrome chain's (``--cn syndrome``, the
    ``DecoderConfig`` defaults), with the QAM chain's (4f: ``--channel
    qam --rayleigh``), with the bubble chain's (4h: ``--cn-impl bubble``),
    with the dense bf16 SPA chain's (4i: ``--dtype bfloat16``), in the
    reference's positional form (``256 10 <file> 2.0 32 0.3 0``: EMS nm =
    32 under ``--cn-impl auto``, K1's top-k route), with ``--storage
    compressed --nm 32`` and the default ``--nboper 0`` (K3's exact merge
    on an f32 state) and with ``--cn ems`` alone (the defaults: nm = 0
    under ``--cn-impl auto``, K1's dense min-convolution), each against
    ``MonteCarlo.run`` of the same config and seed on ``load`` of that
    file: frames, frame errors, bit errors and iteration sum equal.  Each
    CLI run's launches, counted by the kernels on the card, are all of the
    one check-node kernel (entry) its decoder runs; they go into ``paths``
    as "7 cli <label>"."""
    phase("7 CLI at full width")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "code_N8100_GF256.txt")
        tools.write_ubs(ParsedMatrix(
            code.n, code.m_rows, code.q,
            [code.row_cols[r, :d] for r, d in enumerate(code.row_deg)],
            [code.row_coefs[r, :d] for r, d in enumerate(code.row_deg)]),
            path)
        bubble = dict(nm=BUBBLE_NM, nboper=BUBBLE_OPS, cn_impl="bubble")
        for label, cn, iters, flags, spec, db, dec, kernel in (
                ("256 10 <file> 2.0 32 0.3 0", "ems", 10, None,
                 ChannelSpec(), 2.0, dict(nm=32, offset=0.3, nboper=0),
                 "fb_checknode"),
                ("--cn ems", "ems", 10, [], ChannelSpec(), 2.0, {},
                 "fb_checknode"),
                ("--storage compressed --nm 32", "ems", 10,
                 ["--storage", "compressed", "--nm", "32"], ChannelSpec(),
                 1.8, dict(nm=32, storage="compressed"), "list_layer"),
                ("--cn spa", "spa", 20, [], ChannelSpec(), 1.8, {},
                 "spa_layer"),
                ("--cn syndrome", "syndrome", 10, [], ChannelSpec(), 1.8,
                 {}, "syndrome_layer"),
                ("--channel qam --rayleigh --cn spa", "spa", 20,
                 ["--channel", "qam", "--rayleigh"], QAM_SPEC, QAM_SNR, {},
                 "spa_layer"),
                ("--cn-impl bubble", "ems", 10,
                 ["--cn-impl", "bubble", "--nm", str(BUBBLE_NM),
                  "--nboper", str(BUBBLE_OPS)], ChannelSpec(), BUBBLE_DB,
                 bubble, "bubble_layer"),
                ("--dtype bfloat16 --cn spa", "spa", 20,
                 ["--dtype", "bfloat16"], ChannelSpec(), 1.8,
                 {"dtype": "bfloat16"}, "spa_layer")):
            out = os.path.join(tmp, f"out_{len(label)}_{cn}")
            if flags is None:  # the reference's positional form
                argv = ["256", str(iters), path, str(db), "32", "0.3", "0",
                        "--batch", "128"]
            else:
                argv = ["--matrix", path, "--cn", cn, "--iters", str(iters),
                        "--batch", "128", "--max-frames", "256", "--ebn0",
                        str(db), *flags]
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--out", out, "--quiet"])
            seconds = time.perf_counter() - t0
            launches = read_launches()
            top = TOP_OF.get(kernel, kernel)
            ran = {k: launches[k] for k in CN_TOPS if launches[k]}
            with open(os.path.join(out, "results.jsonl")) as f:
                (rec,) = [json.loads(line) for line in f]
            device_loop.clear()
            gc.collect()
            torch.cuda.empty_cache()
            cfg = SimConfig(ebn0_db=db, frames_per_batch=128,
                            max_frames=256, channel=spec,
                            decoder=DecoderConfig(max_iters=iters, cn=cn,
                                                  **dec))
            loaded = load(path, name=path)
            mc = MonteCarlo(loaded, cfg, device="cuda")
            res = mc.run()
            text = os.path.exists(os.path.join(out, result_filename(loaded,
                                                                    cfg)))
            free(mc)
            cli_counts = (rec["frames"], rec["frame_errors"],
                          rec["bit_errors"],
                          round(rec["avg_iters"] * rec["frames"]))
            mc_counts = (res.frames, res.frame_errors, res.bit_errors,
                         res.iter_sum)
            print(f"cli {label}: rc {rc} in {seconds:.1f} s (load, "
                  f"encoder, capture and 256 frames): frames, frame errors, "
                  f"bit errors, iteration sum {cli_counts}; MonteCarlo.run "
                  f"{mc_counts}; text result file {text}; check-node "
                  f"launches counted by the kernels {ran} ({kernel} "
                  f"{launches[kernel]})", flush=True)
            check(rc == 0 and text and cli_counts == mc_counts,
                  f"the CLI's {label} run differs from MonteCarlo.run")
            check(launches[kernel] > 0 and ran == {top: launches[kernel]},
                  f"the CLI's {label} run launched {ran}, not {kernel} "
                  f"alone")
            paths[top][f"7 cli {label}"] = launches[kernel]


def check_modules(code, enc, graph, paths):
    """8a-8d: snapshots, decoder statistics, two-phase decoding and frame
    sharding at full width."""
    intr = check_snapshots(code, enc, graph, EMS_DEC, paths)
    check_decoder_stats(graph, intr, paths)
    del intr
    check_twophase(code, enc, (("SPA row", SPA_DEC, 1.8, "spa_layer"),
                               ("EMS chain", EMS_DEC, 2.0, "fb_checknode")),
                   paths)
    check_sharding(code, enc, SPA_DEC, paths)


def check_snapshots(code, enc, graph, dec, paths):
    """8a: ``run_snapshots`` of one batch at the EMS chain's settings,
    budgets (2, 5, 10); frame and bit errors fall with the budget, equal
    at 10 those of the host-loop decode of the same batch (``MonteCarlo``'s
    batch 0), and K1 launched 3 times a step (eager: the stepper is
    host-stepped)."""
    phase("8a iteration-budget snapshots at full width")
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=128, max_frames=128,
                    stop_errors=10**9, decoder=dec)
    budgets = (2, 5, 10)
    reset_launches()
    t0 = time.perf_counter()
    snap = run_snapshots(code, cfg, budgets, device="cuda", enc=enc)
    wall = time.perf_counter() - t0
    launches = read_host_launches("8a")
    mc = MonteCarlo(code, cfg, enc, device="cuda")
    cw, intr = mc.gen(0)
    decide, iters, conv = decode(graph, intr, dataclasses.replace(
        dec, loop="host"))
    counters = mc.count(decide, cw, iters, conv)[0].tolist()
    steps = int(iters.max())
    fe = [snap.frame_errors[b] for b in budgets]
    be = [snap.bit_errors[b] for b in budgets]
    print(f"snapshots of {snap.frames} frames in {wall:.3f} s (generator "
          f"upload and gen included): frame errors {dict(zip(budgets, fe))},"
          f" bit errors {dict(zip(budgets, be))}; host-loop decode of the "
          f"batch: frame errors {counters[1]}, bit errors {counters[2]}, "
          f"{steps} steps; launches {launches}", flush=True)
    check(fe == sorted(fe, reverse=True) and be == sorted(be, reverse=True),
          "snapshot errors rise with the budget")
    check((fe[-1], be[-1]) == (counters[1], counters[2]),
          "snapshots at budget 10 differ from the host-loop decode")
    check(launches["fb_checknode"] == LAYERS * steps > 0
          and sum(cn_launches(launches).values())
          == launches["fb_checknode"],
          f"snapshot launches {launches} for {steps} steps")
    paths["fb_checknode"]["snapshots (8a)"] = launches["fb_checknode"]
    SUMMARY["snapshots"] = {"wall_s": round(wall, 3), "frame_errors": fe,
                            "bit_errors": be, "steps": steps}
    free(mc)
    return intr


def check_decoder_stats(graph, intr, paths, cpu_frames=2):
    """8b: ``decode_flooding_stats`` (flooding EMS, nm 32, offset 0.3,
    ``cn_impl="pallas"``, 20 iterations) on a batch of F = 128 against the
    flooding host loop on the same intrinsic, step for step; its histogram
    against the one of the last VtoC of that loop, on the card and, for
    ``cpu_frames`` frames, on the CPU."""
    phase("8b decoder statistics at full width")
    e = graph.n_edges
    reset_launches()
    t0 = time.perf_counter()
    st = decode_flooding_stats(graph, intr, 20, 32, 0.3, "ems", "pallas")
    wall = time.perf_counter() - t0
    launches = read_host_launches("8b")
    init_fn, step_fn = make_flooding_stepper(graph, 32, 0.3, "ems", "pallas")
    edge_col = upload(graph, "cuda")["edge_col"]
    state = init_fn(intr)
    trace = [int(state[3].sum())]
    vt = None
    for _ in range(20):
        if bool(state[3].all()):
            break
        vt = None
        tot = _vn_totals(graph, state[0], state[1])
        vt = tot[:, edge_col] - state[1][:, :e]
        del tot
        vt = vt - vt.min(dim=-1, keepdim=True).values
        state = step_fn(state)
        trace.append(int(state[3].sum()))
    steps = len(trace) - 1
    padded = trace + [trace[-1]] * (21 - len(trace))
    base, _ = memory_mark()
    t1 = time.perf_counter()
    hist = winner_rank_histogram(graph, vt, 32)
    torch.cuda.synchronize()
    hist_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    part = winner_rank_histogram(graph, vt[:cpu_frames], 32)
    part_cpu = winner_rank_histogram(graph, vt[:cpu_frames].cpu(), 32)
    want = 128 * CODE_ROWS * graph.q * (graph.code.dc_max - 1)
    print(f"stats in {wall:.3f} s: conv_by_iter {st.conv_by_iter.tolist()}"
          f" (host loop {padded}), avg_it {st.avg_iters:.4f}, launches "
          f"{launches}; rank_hist {st.rank_hist.tolist()} (sum "
          f"{int(st.rank_hist.sum())}, expected {want}); histogram pass "
          f"{hist_s * 1e3:.1f} ms, live peak above its input "
          f"{peak / 2**30:.3f} GiB (chunks of {hist_chunk(graph, 32)} "
          f"frames)", flush=True)
    check(list(st.conv_by_iter) == padded
          and bool((np.diff(st.conv_by_iter) >= 0).all()),
          "the convergence trace differs from the flooding host loop")
    check(np.array_equal(st.iters, state[4].cpu().numpy()),
          "stats iterations differ from the flooding host loop")
    check(launches["fb_checknode"] == steps > 0
          and sum(launches.values()) == steps,
          f"stats launches {launches} for {steps} steps")
    check(int(st.rank_hist.sum()) == want and st.rank_hist.argmax() == 0,
          f"rank histogram sum {int(st.rank_hist.sum())}, argmax "
          f"{st.rank_hist.argmax()}")
    check(np.array_equal(hist.cpu().numpy(), st.rank_hist),
          "the histogram of the last VtoC differs from the stats'")
    check(torch.equal(part.cpu(), part_cpu),
          f"the card's histogram of {cpu_frames} frames differs from the "
          f"CPU's")
    paths["fb_checknode"]["decoder stats (8b)"] = launches["fb_checknode"]
    SUMMARY["decoder stats"] = {
        "wall_s": round(wall, 3), "steps": steps,
        "conv_by_iter": st.conv_by_iter.tolist(),
        "hist_ms": round(hist_s * 1e3, 3),
        "hist_peak_gib": round(peak / 2**30, 3)}
    device_loop.clear()


def check_twophase(code, enc, chains, paths):
    """8c: ``run_twophase`` (``phase_a_iters=3``) against ``MonteCarlo.run``
    on 256 frames of each chain, in turns single-phase, two-phase,
    two-phase, single-phase, each route warmed up (its captures) before its
    first timed run: the five counters equal; two graphs captured by a
    two-phase run and none by its timed runs; the launches counted on the
    card 3 a step."""
    phase("8c two-phase decoding against single-phase")
    card = card_line()
    fields = ("frames", "frame_errors", "bit_errors", "undetected_errors",
              "iter_sum")
    for name, dec, ebn0, kernel in chains:
        cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=128, max_frames=256,
                        stop_errors=10**9, decoder=dec)
        mc = MonteCarlo(code, cfg, enc, device="cuda")

        def run(route):
            return (mc.run() if route == "single"
                    else run_twophase(code, cfg, 3, device="cuda", enc=enc))

        runs = {"single": [], "two": []}
        for route in ("single", "two", "two", "single"):
            if route == "single" or not runs["two"]:
                device_loop.clear()
                device_loop.captures = 0
                run(route)
                captured = device_loop.captures
            reset_launches()
            res = run(route)
            launches = read_launches()
            check(device_loop.captures == captured,
                  f"{name}: a timed {route}-phase run captured a graph")
            check(route == "single" or captured == 2,
                  f"{name}: a two-phase run captured {captured} graphs, "
                  f"expected 2")
            check(launches[kernel] == LAYERS * res.decoder_steps > 0,
                  f"{name} {route}-phase launches {launches} for "
                  f"{res.decoder_steps} steps")
            runs[route].append((res, launches))
        free(mc)
        counts = {r: [[getattr(x, k) for k in fields] for x, _ in v]
                  for r, v in runs.items()}
        fps = {r: [x.frames_per_s for x, _ in v] for r, v in runs.items()}
        steps = {r: [x.decoder_steps for x, _ in v] for r, v in runs.items()}
        print(f"{name} ({card}): single-phase "
              + " / ".join(f"{x:.3f}" for x in fps["single"])
              + " frames/s, two-phase "
              + " / ".join(f"{x:.3f}" for x in fps["two"])
              + f" frames/s; counters {counts}; decoder steps {steps}",
              flush=True)
        check(all(c == counts["single"][0]
                  for c in counts["single"] + counts["two"]),
              f"{name}: two-phase counters differ from MonteCarlo.run's")
        key = "spa_checknode" if kernel == "spa_layer" else kernel
        paths[key][f"two-phase {name} (8c)"] = runs["two"][-1][1][key]
        SUMMARY[f"two-phase {name}"] = {
            "single_fps": [round(x, 3) for x in fps["single"]],
            "two_fps": [round(x, 3) for x in fps["two"]],
            "steps": steps, "counters": counts["single"][0]}


def check_sharding(code, enc, dec, paths):
    """8d: a world of 1 on NCCL (``make_mesh(1)``) over the SPA row, 256
    frames: ``run_sharded``'s counters equal the sum of ``shard=0``
    single-process steps on the same batches, and K2 launched 3 a step."""
    import torch.distributed as dist

    from ems_nbldpc_torch.parallel.mesh import (make_mesh, run_sharded,
                                                sharded_batch_step)

    phase("8d frame sharding: a world of 1 on NCCL")
    cards = torch.cuda.device_count()
    mesh = make_mesh(1)
    try:
        check(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
              f"the mesh runs {dist.get_backend()} on {mesh.device}")
        cfg = SimConfig(ebn0_db=1.8, frames_per_batch=128, max_frames=256,
                        stop_errors=10**9, decoder=dec)
        step = sharded_batch_step(code, cfg, mesh)
        step(0)                                        # its capture
        reset_launches()
        res = run_sharded(code, cfg, mesh, step=step)
        launches = read_launches()
    finally:
        mesh.close()
    mc = MonteCarlo(code, cfg, enc, device="cuda", shard=0)
    seq = sum(mc.step(b)[0].cpu().numpy() for b in range(2))
    free(mc)
    got = [res.frames, res.frame_errors, res.bit_errors,
           res.undetected_errors, res.iter_sum, res.decoder_steps]
    print(f"{cards} card(s) on this machine: one card cannot measure "
          f"scaling, and none is claimed; sharded run {got} at "
          f"{res.frames_per_s:.3f} frames/s, shard-0 steps {seq.tolist()}; "
          f"launches {launches}", flush=True)
    check(got == seq.tolist(), "sharded counters differ from the shard-0 "
          "single-process steps")
    check(launches["spa_layer"] == LAYERS * res.decoder_steps > 0,
          f"sharded launches {launches} for {res.decoder_steps} steps")
    paths["spa_checknode"]["sharded SPA (8d)"] = launches["spa_checknode"]
    SUMMARY["sharded SPA"] = {"cards": cards, "counters": got,
                              "fps": round(res.frames_per_s, 3)}


def main(argv) -> int:
    t_start = time.perf_counter()
    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    if "--profile" in argv:
        # start the tracer before any graph is instantiated: a graph made
        # before the first trace had most of its kernels missing from it
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    phase("2 build")
    t0 = time.perf_counter()
    mods = (cuda_cn, cuda_spa, cuda_syndrome, cuda_demap, cuda_bubble,
            cuda_list, cuda_decide, device_loop)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        builds = {mod.__name__.rsplit(".", 1)[-1]: pool.submit(mod.build,
                                                               verbose=True)
                  for mod in mods}
        for name, fut in builds.items():
            _, seconds, log = fut.result()
            print(f"nvcc {name} {seconds:.2f} s")
            for line in log.splitlines():
                if "ptxas" in line:
                    print(line.strip())
    print(f"all eight built in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--only-3h" in argv:
        check_decide_kernel()
        if "--cells" in argv:
            check_decide_cells()
        print("--only-3h: the other phases were not run", flush=True)
        return 0
    if "--only-3d" in argv:
        check_demap_kernel()
        print("--only-3d: the other phases were not run", flush=True)
        return 0

    t0 = time.perf_counter()
    code = random_regular(8100, 4050, 256, dv=2, seed=0)
    n_layers = len(code.layers)
    print(f"code N={code.n} M={code.m_rows} q={code.q} dc={code.dc_max} "
          f"layers={n_layers} sizes={[len(x) for x in code.layers]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(n_layers == LAYERS, f"{n_layers} super-layers, expected {LAYERS}")
    check(all(len(x) == SLICE_ROWS for x in code.layers)
          and code.m_rows == CODE_ROWS, "unexpected layer sizes")
    graph = DeviceGraph.from_code(code)

    if "--only-3" in argv:
        check_kernel(graph)
        check_kernel_modes(graph)
        print("--only-3: the other phases were not run", flush=True)
        return 0
    if "--only-3c" in argv:
        check_syndrome_kernel(graph)
        print("--only-3c: the other phases were not run", flush=True)
        return 0
    if "--only-3e" in argv:
        check_bubble_kernel(graph)
        print("--only-3e: the other phases were not run", flush=True)
        return 0
    if "--only-3f" in argv or "--only-3g" in argv:
        if "--only-3f" in argv:
            check_list_kernel(graph)
        if "--only-3g" in argv:
            check_list_general(graph)
        print("--only-3f / --only-3g: the other phases were not run",
              flush=True)
        return 0
    if "--only-8" in argv:
        t0 = time.perf_counter()
        check_modules(code, gaussian_elimination(code), graph,
                      {"fb_checknode": {}, "spa_checknode": {}})
        print(f"--only-8: the other phases were not run "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return 0
    if "--only-bf16" in argv:
        for entry in BF16_PHASES:
            check_bf16_layers(graph, entry)
        print("--only-bf16: the other phases were not run", flush=True)
        return 0
    max_err, k_times = check_kernel(graph)
    modes_err, dense_times = check_kernel_modes(graph)
    spa_err, spa_times, layer_times = check_spa_kernel(graph)
    syn_err, syn_times, syn_layer = check_syndrome_kernel(graph)
    demap_err, demap_times = check_demap_kernel()
    bub_err, bub_times = check_bubble_kernel(graph)
    list_err, list_times = check_list_kernel(graph)
    gen_err, gen_times = check_list_general(graph)
    decide_times = check_decide_kernel()
    b16 = {entry: check_bf16_layers(graph, entry) for entry in BF16_PHASES}
    syn_main = syn_times[("layered", 128 * SLICE_ROWS)]
    syn_flood = syn_times[("flooding", 128 * CODE_ROWS)]
    k_main = k_times[("layered", 128 * SLICE_ROWS)]
    k_flood = k_times[("flooding", 128 * CODE_ROWS)]
    spa_main = layer_times[128]                         # layered, F = 128
    spa_flood = spa_times[SPA_SHAPES[2][0]]             # flooding, F = 16

    phase("4 EMS chain")
    paths = {"fb_checknode": {}, "spa_checknode": {},
             "syndrome_checknode": {}, "bubble_checknode": {},
             "list_layer": {}}
    t0 = time.perf_counter()
    enc = gaussian_elimination(code)
    print(f"encoder {time.perf_counter() - t0:.1f} s", flush=True)
    dec = EMS_DEC
    mc, res, ems_launches = run_chain("EMS", code, enc, dec, 2.0)
    check(ems_launches["fb_checknode"] == n_layers * res.decoder_steps > 0
          and ems_launches["spa_checknode"] == 0,
          f"launches {ems_launches} for {res.decoder_steps} decoder steps")
    paths["fb_checknode"]["layered EMS"] = ems_launches["fb_checknode"]
    cw, intr = mc.gen(0)
    check(tuple(intr.shape) == (128, code.n, code.q),
          f"intrinsic shape {tuple(intr.shape)}")
    check(bool(torch.isfinite(intr).all()), "non-finite intrinsics")
    check(bool(syndrome_ok(graph, cw).all()), "a codeword fails H")
    print("all 128 codewords of batch 0 satisfy the syndrome", flush=True)
    check_loops("layered EMS", graph, intr, dec, {"fb_checknode": n_layers})

    phase("5 EMS kernel vs plain decode at full width")
    intr16 = intr[:16].contiguous()
    outs = {}
    for plain in (False, True):
        reset_launches()
        outs[plain] = tuple(x.cpu() for x in plain_decode(graph, intr16, dec,
                                                          plain)) + (
            read_host_launches("5"),)
    same = all(torch.equal(a, b) for a, b in zip(outs[False][:3],
                                                  outs[True][:3]))
    print(f"F=16: identical decisions/iterations/convergence: {same}; "
          f"iters {outs[False][1].tolist()}; launches kernel {outs[False][3]}"
          f", plain {outs[True][3]}", flush=True)
    check(same, "kernel and plain decodes differ")
    check(outs[False][3]["fb_checknode"]
          == n_layers * int(outs[False][1].max()) > 0
          and sum(outs[True][3].values()) == 0,
          f"EMS launches {outs[False][3]} (plain {outs[True][3]})")
    check_bf16_path("layered EMS", graph, intr, dec,
                    {"fb_checknode": n_layers})
    if "--profile" in argv:
        SUMMARY["EMS"][-1]["profile"] = profile_batch(mc, "ems")
        SUMMARY["EMS"][-1]["profile"].pop("spa_kernels")
        SUMMARY["EMS"][-1]["profile"].pop("syn_kernels")
        SUMMARY["EMS"][-1]["profile"].pop("bub_kernels")
        check(SUMMARY["EMS"][-1]["profile"]["topk_kernels"] == 0,
              "torch.topk kernels in the EMS chain's profile")
        check_traced(SUMMARY["EMS"][-1]["profile"], "ems_rows_kernel",
                     n_layers, "EMS trace")
    free(mc)
    del mc, cw, intr, intr16

    phase("4b SPA chain, device loop and host loop in turns")
    spa_dec = SPA_DEC
    spa_host = dataclasses.replace(spa_dec, loop="host")
    # device, host, host, device; a fresh MonteCarlo for each loop, so that
    # each peak holds its own loop's memory only
    mc, spa_res, spa_launches = run_chain("SPA", code, enc, spa_dec, 1.8)
    free(mc)
    mc, host_res, host_launches = run_chain("SPA", code, enc, spa_host, 1.8)
    run_chain("SPA", code, enc, spa_host, 1.8, mc=mc)
    free(mc)
    mc, spa_res2, _ = run_chain("SPA", code, enc, spa_dec, 1.8)
    check(spa_launches["spa_checknode"] == spa_launches["spa_layer"]
          == n_layers * spa_res.decoder_steps > 0
          and spa_launches["fb_checknode"] == 0
          and host_launches == spa_launches,
          f"launches {spa_launches} (host loop {host_launches}) for "
          f"{spa_res.decoder_steps} decoder steps")
    check((spa_res.frame_errors, spa_res.iter_sum, spa_res.decoder_steps)
          == (host_res.frame_errors, host_res.iter_sum,
              host_res.decoder_steps),
          "the SPA chain differs between the device and the host loop")
    paths["spa_checknode"]["layered SPA"] = spa_launches["spa_checknode"]
    check_loops("layered SPA", graph, mc.gen(0)[1], spa_dec,
                {"spa_checknode": n_layers, "spa_layer": n_layers})

    phase("5b SPA kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    outs = {}
    for plain in (False, True):
        reset_launches()
        d, it, conv = decode_layered_hostloop(graph, intr16, 20, cn="spa",
                                              plain=plain)
        outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                       read_host_launches("5b"))
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    it_diff = (it_k - it_p).abs()
    print(f"F=16: identical decisions {torch.equal(d_k, d_p)}, convergence "
          f"{torch.equal(c_k, c_p)}; iters kernel {it_k.tolist()}, plain "
          f"{it_p.tolist()}; frames whose iteration counts differ: "
          f"{int((it_diff > 0).sum())}; launches kernel {l_k}, plain {l_p}",
          flush=True)
    check(torch.equal(d_k, d_p) and torch.equal(c_k, c_p)
          and int(it_diff.max()) <= 1, "SPA kernel and plain decodes differ")
    check(l_k["spa_layer"] == l_k["spa_checknode"]
          == n_layers * int(it_k.max()) > 0 and l_k["fb_checknode"] == 0
          and sum(l_p.values()) == 0,
          f"layered SPA launches {l_k} (plain {l_p}) for {int(it_k.max())} "
          f"steps")
    if "--profile" in argv:
        prof = profile_batch(mc, "spa")
        prof.pop("syn_kernels")
        prof.pop("bub_kernels")
        names = prof.pop("spa_kernels")
        print(f"SPA kernels in the trace: {names}", flush=True)
        check(names and all("spa_row_kernel<8, true, float>" in n
                            for n in names),
              f"the SPA trace holds other SPA kernels than the fused step: "
              f"{names}")
        print(f"SPA trace under the device loop: idle "
              f"{100 - prof['busy_pct']:.2f}% of its wall", flush=True)
        check_traced(prof, "spa_row_kernel", n_layers, "SPA trace")
        SUMMARY["SPA"][-1]["profile"] = prof
    free(mc)
    del mc, intr16

    phase("4i SPA chain at dense bf16")
    spa_b16 = dataclasses.replace(spa_dec, dtype="bfloat16")
    mc, b16_res, b16_launches = run_chain("SPA bf16", code, enc, spa_b16,
                                          1.8)
    check(b16_launches["spa_checknode"] == b16_launches["spa_layer"]
          == n_layers * b16_res.decoder_steps > 0
          and sum(b16_launches.values()) == 2 * b16_launches["spa_layer"]
          and device_loop.last().per_step["spa_layer"] == n_layers,
          f"launches {b16_launches} for {b16_res.decoder_steps} decoder "
          f"steps")
    paths["spa_checknode"]["layered SPA bf16 (4i)"] = b16_launches[
        "spa_checknode"]
    intr = mc.gen(0)[1]
    spa_steps = {"spa_checknode": n_layers, "spa_layer": n_layers}
    SUMMARY["SPA bf16"][-1]["kernel_vs_plain_differing_frames"] = \
        check_bf16_path("layered SPA", graph, intr, spa_dec, spa_steps,
                        iters_within=1)
    check_loops("layered SPA bf16 F=128", graph, intr, spa_b16, spa_steps)
    if "--profile" in argv:
        prof = profile_batch(mc, "spa_bf16")
        prof.pop("syn_kernels")
        prof.pop("bub_kernels")
        names = prof.pop("spa_kernels")
        check(names and all("spa_row_kernel<8, true, __nv_bfloat16>" in n
                            for n in names),
              f"the SPA bf16 trace holds other SPA kernels than the fused "
              f"bf16 step: {names}")
        print(f"SPA bf16 trace: spa_row_kernel {prof['spa_pct']}% and "
              f"decisions (K4) {prof['decide_pct']}% (torch argmin "
              f"{prof['argmin_pct']}%) of the kernel time; idle "
              f"{100 - prof['busy_pct']:.2f}% of its wall", flush=True)
        check_traced(prof, "spa_row_kernel", n_layers, "SPA bf16 trace")
        SUMMARY["SPA bf16"][-1]["profile"] = prof
    free(mc)
    del mc, intr

    phase("4c list-EMS chain")
    list_dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                             nm=32, offset=0.3, nboper=64,
                             storage="compressed", dtype="bfloat16")
    mc, list_res, list_launches = run_chain("list-EMS", code, enc, list_dec,
                                            1.8)
    check(list_launches["list_layer"] == n_layers * list_res.decoder_steps > 0
          and sum(list_launches.values()) == list_launches["list_layer"],
          f"list-EMS launches {list_launches} for {list_res.decoder_steps} "
          f"decoder steps")
    paths["list_layer"]["list-EMS row (4c)"] = list_launches["list_layer"]
    intr = mc.gen(0)[1]
    _, replay = check_loops("layered list-EMS", graph, intr, list_dec,
                            {"list_layer": n_layers})
    paths["list_layer"]["list-EMS row (6)"] = replay["list_layer"]
    ran_5l = check_list_decodes(graph, intr, list_dec, n_layers)
    if "--profile" in argv:
        prof = profile_batch(mc, "list")
        for key in ("spa_kernels", "syn_kernels", "bub_kernels"):
            prof.pop(key)
        print(f"list-EMS trace: list_kernel {prof['list_pct']}% and "
              f"decisions (K4) {prof['decide_pct']}% (torch argmin "
              f"{prof['argmin_pct']}%) of the kernel time; idle "
              f"{100 - prof['busy_pct']:.2f}% of its wall", flush=True)
        check_traced(prof, "list_kernel", n_layers, "list-EMS trace")
        SUMMARY["list-EMS"][-1]["profile"] = prof
    free(mc)
    del mc, intr
    paths["list_layer"].update({f"5l {k}": v for k, v in ran_5l.items()})

    phase("4j list-EMS chain with the exact merge (nbOper = 0)")
    exact_dec = dataclasses.replace(list_dec, nboper=0)
    mc, ex_res, ex_launches = run_chain("list-EMS exact", code, enc,
                                        exact_dec, 1.8)
    check(ex_launches["list_layer"] == n_layers * ex_res.decoder_steps > 0
          and sum(ex_launches.values()) == ex_launches["list_layer"],
          f"list-EMS exact launches {ex_launches} for "
          f"{ex_res.decoder_steps} decoder steps")
    paths["list_layer"]["list-EMS exact (4j)"] = ex_launches["list_layer"]
    free(mc)
    del mc

    phase("4l list-EMS chain with nothing truncated (nm = q, nbOper = 0)")
    full_dec = dataclasses.replace(list_dec, nm=code.q, nboper=0)
    where = cuda_list.path(code.dc_max, code.q, code.q, 0)
    print(f"4l: K3's general step ({where} path, the exact merge as dense "
          f"min-convolutions) on every super-layer: frames/s, avg_it, FER, "
          f"memory and idle share of the list decoder with no list "
          f"truncated", flush=True)
    mc, nq_res, nq_launches = run_chain("list-EMS nm=q", code, enc,
                                        full_dec, 1.8)
    check(nq_launches["list_layer"] == n_layers * nq_res.decoder_steps > 0
          and sum(nq_launches.values()) == nq_launches["list_layer"],
          f"list-EMS nm=q launches {nq_launches} for "
          f"{nq_res.decoder_steps} decoder steps")
    paths["list_layer"]["list-EMS nm=q (4l)"] = nq_launches["list_layer"]
    free(mc)
    del mc

    phase("4k the CLI's default decoder (layered EMS, nm = 0, cn_impl auto)")
    default_dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                                nm=0, offset=0.3, cn_impl="auto",
                                storage="dense", dtype="float32")
    mc, df_res, df_launches = run_chain("default EMS (dense K1)", code, enc,
                                        default_dec, 2.0)
    check(df_launches["fb_checknode"] == n_layers * df_res.decoder_steps > 0
          and sum(df_launches.values()) == df_launches["fb_checknode"],
          f"default EMS launches {df_launches} for {df_res.decoder_steps} "
          f"decoder steps")
    paths["fb_checknode"]["default EMS (4k)"] = df_launches["fb_checknode"]
    free(mc)
    del mc

    phase("4d flooding EMS chain")
    fl_dec = DecoderConfig(max_iters=20, schedule="flooding", cn="ems", nm=32,
                           offset=0.3, cn_impl="pallas", storage="dense",
                           dtype="float32")
    mc, fl_res, fl_launches = run_chain("flooding EMS", code, enc, fl_dec,
                                        2.0)
    check(fl_launches["fb_checknode"] == fl_res.decoder_steps > 0
          and fl_launches["spa_checknode"] == 0,
          f"launches {fl_launches} for {fl_res.decoder_steps} decoder steps")
    paths["fb_checknode"]["flooding EMS"] = fl_launches["fb_checknode"]
    intr = mc.gen(0)[1]
    check_loops("flooding EMS", graph, intr, fl_dec, {"fb_checknode": 1})
    fl_spa = DecoderConfig(max_iters=20, schedule="flooding", cn="spa")
    check_loops("flooding SPA", graph, intr, fl_spa, {"spa_checknode": 1})
    device_loop.clear()
    del intr

    phase("5d flooding EMS kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    outs, fl_calls = {}, {}
    for impl, plain in (("pallas", False), ("topk", True)):
        reset_launches()
        d, it, conv = plain_decode(graph, intr16, fl_dec, plain)
        outs[impl] = (d.cpu(), it.cpu(), conv.cpu())
        fl_calls[impl] = read_host_launches("5d")
    same = all(torch.equal(a, b) for a, b in zip(outs["pallas"], outs["topk"]))
    steps16 = int(outs["pallas"][1].max())
    print(f"F=16: identical decisions/iterations/convergence: {same}; "
          f"iters {outs['pallas'][1].tolist()}; launches kernel "
          f"{fl_calls['pallas']}, plain {fl_calls['topk']}", flush=True)
    check(same, "flooding kernel and plain decodes differ")
    check(fl_calls["pallas"]["fb_checknode"] == steps16 > 0
          and fl_calls["pallas"]["spa_checknode"] == 0
          and sum(fl_calls["topk"].values()) == 0,
          f"flooding EMS launches {fl_calls} for {steps16} steps")
    check_bf16_path("flooding EMS", graph, intr16, fl_dec,
                    {"fb_checknode": 1})

    phase("5e flooding SPA kernel vs plain decode at full width")
    outs = {}
    for plain in (False, True):
        reset_launches()
        d, it, conv = decode_flooding_hostloop(graph, intr16, 20, cn="spa",
                                               plain=plain)
        outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                       read_host_launches("5e"))
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    it_diff = (it_k - it_p).abs()
    print(f"F=16: identical decisions {torch.equal(d_k, d_p)}, convergence "
          f"{torch.equal(c_k, c_p)}; iters kernel {it_k.tolist()}, plain "
          f"{it_p.tolist()}; frames whose iteration counts differ: "
          f"{int((it_diff > 0).sum())}; launches kernel {l_k}, plain {l_p}",
          flush=True)
    check(torch.equal(d_k, d_p) and torch.equal(c_k, c_p)
          and int(it_diff.max()) <= 1,
          "flooding SPA kernel and plain decodes differ")
    check(l_k["spa_checknode"] == int(it_k.max()) > 0
          and l_k["spa_layer"] == 0
          and l_k["fb_checknode"] == 0 and sum(l_p.values()) == 0,
          f"flooding SPA launches {l_k} (plain {l_p}) for "
          f"{int(it_k.max())} steps")
    paths["spa_checknode"]["flooding SPA"] = l_k["spa_checknode"]
    if "--profile" in argv:
        SUMMARY["flooding EMS"][-1]["profile"] = profile_batch(mc,
                                                               "flooding")
        SUMMARY["flooding EMS"][-1]["profile"].pop("spa_kernels")
        SUMMARY["flooding EMS"][-1]["profile"].pop("syn_kernels")
        SUMMARY["flooding EMS"][-1]["profile"].pop("bub_kernels")
        check(SUMMARY["flooding EMS"][-1]["profile"]["topk_kernels"] == 0,
              "torch.topk kernels in the flooding EMS profile")
        check_traced(SUMMARY["flooding EMS"][-1]["profile"],
                     "ems_rows_kernel", 1, "flooding EMS trace")
    free(mc)
    del mc, intr16

    phase("4e syndrome chain")
    syn_dec = DecoderConfig(max_iters=10, schedule="layered", cn="syndrome",
                            nm=0, offset=0.3, storage="dense",
                            dtype="float32")
    mc, syn_res, syn_launches = run_chain("syndrome", code, enc, syn_dec, 1.8)
    check(syn_launches["syndrome_checknode"] == syn_launches["syndrome_layer"]
          == n_layers * syn_res.decoder_steps > 0
          and sum(syn_launches.values())
          == 2 * syn_launches["syndrome_checknode"],
          f"launches {syn_launches} for {syn_res.decoder_steps} decoder steps")
    paths["syndrome_checknode"]["layered syndrome"] = syn_launches[
        "syndrome_checknode"]
    intr = mc.gen(0)[1]
    check_loops("layered syndrome", graph, intr, syn_dec,
                {"syndrome_checknode": n_layers, "syndrome_layer": n_layers})
    fl_syn = dataclasses.replace(syn_dec, schedule="flooding", max_iters=20)
    _, replay = check_loops("flooding syndrome", graph, intr, fl_syn,
                            {"syndrome_checknode": 1})
    paths["syndrome_checknode"]["flooding syndrome"] = replay[
        "syndrome_checknode"]
    device_loop.clear()
    del intr

    phase("5g syndrome kernel vs plain decode at full width")
    intr16 = mc.gen(0)[1][:16].contiguous()
    outs = {}
    for plain in (False, True):
        reset_launches()
        d, it, conv = decode_layered_hostloop(graph, intr16, 10, offset=0.3,
                                              cn="syndrome", plain=plain)
        outs[plain] = (d.cpu(), it.cpu(), conv.cpu(),
                       read_host_launches("5g"))
    (d_k, it_k, c_k, l_k), (d_p, it_p, c_p, l_p) = outs[False], outs[True]
    same = (torch.equal(d_k, d_p) and torch.equal(it_k, it_p)
            and torch.equal(c_k, c_p))
    print(f"F=16: identical decisions/iterations/convergence: {same}; iters "
          f"{it_k.tolist()}; launches kernel {l_k}, plain {l_p}", flush=True)
    check(same, "syndrome kernel and plain decodes differ")
    check(l_k["syndrome_checknode"] == l_k["syndrome_layer"]
          == n_layers * int(it_k.max()) > 0
          and sum(cn_launches(l_k).values())
          == 2 * l_k["syndrome_checknode"]
          and l_k["decide_rows"] == int(it_k.max()) + 1
          and sum(l_p.values()) == 0,
          f"syndrome launches {l_k} (plain {l_p}) for {int(it_k.max())} "
          f"steps")
    check_bf16_path("layered syndrome", graph, intr16, syn_dec,
                    {"syndrome_checknode": n_layers,
                     "syndrome_layer": n_layers})
    if "--profile" in argv:
        prof = profile_batch(mc, "syndrome")
        prof.pop("spa_kernels")
        names = prof.pop("syn_kernels")
        prof.pop("bub_kernels")
        print(f"syndrome kernels in the trace: {names}", flush=True)
        check(prof["topk_kernels"] == 0,
              "torch.topk kernels in the syndrome chain's profile")
        check(names and all("syndrome_kernel<8, true, float>" in n
                            for n in names),
              f"the syndrome trace holds other syndrome kernels than the "
              f"fused step: {names}")
        # the sweep gathered and scattered [F, 1350, 4, 256] f32 blocks
        # (21% of the batch); what is left is the decisions' and the
        # syndrome check's small gathers
        check(prof["index_pct"] < 3.0,
              f"the syndrome trace spends {prof['index_pct']}% in index "
              f"kernels: the sweep still gathers")
        check_traced(prof, "syndrome_kernel", n_layers, "syndrome trace")
        SUMMARY["syndrome"][-1]["profile"] = prof
    free(mc)
    del mc, intr16

    phase("4f QAM chain: 256-QAM, Rayleigh, layered SPA")
    mc, qam_res, qam_launches = run_chain("QAM", code, enc, spa_dec, QAM_SNR,
                                          channel=QAM_SPEC)
    check(qam_launches["spa_checknode"] == qam_launches["spa_layer"]
          == n_layers * qam_res.decoder_steps > 0
          and qam_launches["fb_checknode"] == 0,
          f"QAM chain launches {qam_launches} for {qam_res.decoder_steps} "
          f"decoder steps")
    paths["spa_checknode"]["QAM (4f)"] = qam_launches["spa_checknode"]
    print(f"QAM chain at {QAM_SNR} dB (Es/N0), {QAM_SPEC}", flush=True)
    demap_5h = check_demap_decodes(mc, QAM_SPEC, spa_dec, "QAM chain")
    if "--profile" in argv:
        prof = profile_batch(mc, "qam", big=(128, code.n, code.q, 2))
        prof.pop("syn_kernels")
        prof.pop("bub_kernels")
        prof.pop("spa_kernels")
        print(f"QAM trace: demap_kernel {prof['traced']['demap_kernel']} "
              f"launch(es), {prof['demap_pct']}% of the kernel time; torch "
              f"ops on a [F, N, q, 2] tensor: {prof['big_ops']}", flush=True)
        check(prof["traced"]["demap_kernel"] == 1,
              f"QAM trace: {prof['traced']['demap_kernel']} demap kernels, "
              f"expected 1")
        check(not prof["big_ops"], f"QAM trace: torch ops on [F, N, q, 2] "
              f"tensors: {prof['big_ops']}")
        check_traced(prof, "spa_row_kernel", n_layers, "QAM trace")
        SUMMARY["QAM"][-1]["profile"] = prof
    free(mc)
    del mc

    phase("4g 4-D chain: 256-QAM 4-D, SSD, erasures 0.1, layered EMS")
    mc, d4_res, d4_launches = run_chain("4-D", code, enc, dec, D4_SNR,
                                        channel=D4_SPEC)
    check(d4_launches["fb_checknode"] == n_layers * d4_res.decoder_steps > 0
          and d4_launches["spa_checknode"] == 0,
          f"4-D chain launches {d4_launches} for {d4_res.decoder_steps} "
          f"decoder steps")
    paths["fb_checknode"]["4-D (4g)"] = d4_launches["fb_checknode"]
    print(f"4-D chain at {D4_SNR} dB (Es/N0), {D4_SPEC}", flush=True)
    demap_5h = max(demap_5h, check_demap_decodes(mc, D4_SPEC, dec,
                                                 "4-D chain"))
    free(mc)
    del mc

    phase("4h bubble chain: layered EMS through the 8-bubble (K9)")
    bub_dec = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                            nm=BUBBLE_NM, offset=0.3, cn_impl="bubble",
                            nboper=BUBBLE_OPS, storage="dense",
                            dtype="float32")
    mc, bub_res, bub_launches = run_chain("bubble", code, enc, bub_dec,
                                          BUBBLE_DB)
    check(bub_launches["bubble_checknode"] == bub_launches["bubble_layer"]
          == n_layers * bub_res.decoder_steps > 0
          and sum(bub_launches.values())
          == 2 * bub_launches["bubble_checknode"],
          f"bubble chain launches {bub_launches} for "
          f"{bub_res.decoder_steps} decoder steps")
    paths["bubble_checknode"]["bubble chain (4h)"] = bub_launches[
        "bubble_checknode"]
    if "--profile" in argv:
        prof = profile_batch(mc, "bubble")
        prof.pop("spa_kernels")
        prof.pop("syn_kernels")
        names = prof.pop("bub_kernels")
        print(f"bubble kernels in the trace: {names}", flush=True)
        check(names and all("bubble_kernel<8, 8, true, float>" in n
                            for n in names),
              f"the bubble trace holds other bubble kernels than the fused "
              f"step: {names}")
        # the sweep gathered and scattered [F, 1350, 4, 256] f32 blocks
        # around the bare kernel (30% of the batch before the fusion)
        check(prof["index_pct"] < 3.0,
              f"the bubble trace spends {prof['index_pct']}% in index "
              f"kernels: the sweep still gathers")
        check_traced(prof, "bubble_kernel", n_layers, "bubble trace")
        SUMMARY["bubble"][-1]["profile"] = prof
    check_bubble_decodes(mc, bub_dec)
    SUMMARY["bubble"][-1]["native"] = check_native(mc, bub_dec)
    intr = mc.gen(0)[1]
    fused = {"bubble_checknode": n_layers, "bubble_layer": n_layers}
    for sched, impl, per_step in (("layered", "lbubble", fused),
                                  ("layered", "bubble", fused),
                                  ("flooding", "bubble",
                                   {"bubble_checknode": 1}),
                                  ("flooding", "lbubble",
                                   {"bubble_checknode": 1})):
        loop_dec = dataclasses.replace(
            bub_dec, schedule=sched, cn_impl=impl,
            max_iters=20 if sched == "flooding" else bub_dec.max_iters)
        _, replay = check_loops(f"{sched} {impl}", graph, intr, loop_dec,
                                per_step)
        if (sched, impl) != ("layered", "bubble"):
            paths["bubble_checknode"][f"{sched} {impl} (6)"] = replay[
                "bubble_checknode"]
    for impl in ("bubble", "lbubble"):
        check_bf16_path(f"layered {impl}", graph, intr,
                        dataclasses.replace(bub_dec, cn_impl=impl), fused)
    device_loop.clear()
    free(mc)
    del mc, intr
    check_small_channel_decodes()

    check_odd_batches(code, {
        "layered SPA": (spa_dec, {"spa_checknode": n_layers,
                                  "spa_layer": n_layers}),
        "flooding EMS": (fl_dec, {"fb_checknode": 1})})
    paths["fb_checknode"].update(check_small_card_decodes())
    check_cli(code, paths)
    check_modules(code, enc, graph, paths)

    print(f"smoke run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"chains": SUMMARY}, separators=(",", ":")))
    d2, d4, apsk = (demap_times[k] for k in ("2-D", "4-D", "APSK"))
    b_main, b_flood, b_layer = (bub_times[k] for k in ("layered",
                                                       "flooding", "layer"))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fb_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/fb_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/pallas_cn.py:138",
        "entry_points": ["ems_rows", "fb_checknode"],
        "launches": sum(paths["fb_checknode"].values()),
        "paths": list(paths["fb_checknode"]),
        "launches_by_path": paths["fb_checknode"],
        "max_abs_err": max(max_err, modes_err),
        "rows": 128 * SLICE_ROWS, "ms": k_main["fused"],
        "plain_ms": k_main["plain"], "old_route_ms": k_main["old"],
        "bare_ms": k_main["bare"], "bound_ms": k_main["bound"],
        "bound_by": k_main["bound_by"], "library_ms": None,
        "flooding_rows": 128 * CODE_ROWS, "flooding_ms": k_flood["fused"],
        "flooding_plain_ms": k_flood["plain"],
        "flooding_old_route_ms": k_flood["old"],
        "flooding_bare_ms": k_flood["bare"],
        "flooding_bound_ms": k_flood["bound"],
        "dense_rows": dense_times["rows"], "dense_ms": dense_times["kernel"],
        "dense_plain_ms": dense_times["plain"],
        "dense_bound_ms": dense_times["bound"],
        "dense_bound_by": dense_times["bound_by"],
        "dense_floor_ms": dense_times["floor"],
        "ws_rows": dense_times["ws"]["rows"], "ws_dc": dense_times["ws"]["dc"],
        "ws_ms": dense_times["ws"]["kernel"],
        "ws_plain_ms": dense_times["ws"]["plain"],
        "ws_bound_ms": dense_times["ws"]["bound"],
        "ws_floor_ms": dense_times["ws"]["floor"],
        "bare_bf16_ms": dense_times["bare"]["bf16"],
        "bare_f32_ms": dense_times["bare"]["f32"],
        "bare_bf16_bound_ms": dense_times["bare"]["bf16_bound"],
    }, {
        "name": "spa_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/spa_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/fht.py:249",
        "entry_points": ["spa_layer", "spa_checknode"],
        "launches": sum(paths["spa_checknode"].values()),
        "paths": list(paths["spa_checknode"]),
        "launches_by_path": paths["spa_checknode"], "max_abs_err": spa_err,
        "rows": 128 * SLICE_ROWS, "ms": spa_main["fused"],
        "plain_ms": spa_main["plain"], "old_route_ms": spa_main["old"],
        "bare_ms": spa_main["bare"], "bound_ms": spa_main["bound"],
        "bound_by": spa_main["bound_by"], "library_ms": None,
        "flooding_rows": SPA_SHAPES[2][0], "flooding_ms": spa_flood[0],
        "flooding_plain_ms": spa_flood[1], "flooding_bound_ms": spa_flood[2],
        **bf16_fields(b16["spa_layer"]),
    }, {
        "name": "syndrome_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/syndrome_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/syndrome_cn.py:240",
        "entry_points": ["syndrome_layer", "syndrome_rows"],
        "launches": sum(paths["syndrome_checknode"].values()),
        "paths": list(paths["syndrome_checknode"]),
        "launches_by_path": paths["syndrome_checknode"],
        "max_abs_err": syn_err, "rows": 128 * SLICE_ROWS,
        "ms": syn_layer["fused"], "plain_ms": syn_layer["plain"],
        "old_route_ms": syn_layer["old"], "bare_ms": syn_main["kernel"],
        "bare_plain_ms": syn_main["plain"],
        "bound_ms": syn_layer["bound"], "bound_by": syn_layer["bound_by"],
        "bare_bound_ms": syn_main["bound"],
        "library_ms": None, "flooding_rows": 128 * CODE_ROWS,
        "flooding_ms": syn_flood["kernel"],
        "flooding_plain_ms": syn_flood["plain"],
        "flooding_bound_ms": syn_flood["bound"],
        **bf16_fields(b16["syndrome_layer"]),
    }, {
        "name": "demap", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/demap.cu",
        "replaces": "ems_nbldpc_tpu/models/channels.py:251-258, :335-342",
        "entry_points": ["demap_2d", "demap_4d"],
        "launches": sum(DEMAP_PATHS.values()), "paths": list(DEMAP_PATHS),
        "launches_by_path": DEMAP_PATHS,
        "max_abs_err": max(demap_err, demap_5h),
        "rows": DEMAP_TIMED["2-D"][0] * DEMAP_TIMED["2-D"][1], "q": 256,
        "ms": d2["kernel"], "plain_ms": d2["plain"], "bound_ms": d2["bound"],
        "bound_by": d2["bound_by"], "library_ms": None,
        "peak_gib": d2["peak_gib"],
        "d4_ms": d4["kernel"], "d4_plain_ms": d4["plain"],
        "d4_gemm_ms": d4["gemm"], "d4_bound_ms": d4["bound"],
        "d4_peak_gib": d4["peak_gib"],
        "apsk64_ms": apsk["kernel"], "apsk64_plain_ms": apsk["plain"],
        "apsk64_bound_ms": apsk["bound"],
    }, {
        "name": "bubble_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/bubble_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/bubble_cn.py:34-195",
        "entry_points": ["bubble_layer", "bubble_rows"],
        "launches": sum(paths["bubble_checknode"].values()),
        "paths": list(paths["bubble_checknode"]),
        "launches_by_path": paths["bubble_checknode"],
        "max_abs_err": bub_err, "frames": b_layer["frames"],
        "rows": b_layer["rows"], "ms": b_layer["fused"],
        "lbubble_ms": b_layer["lbubble"], "no_steps_ms": b_layer["no_steps"],
        "plain_ms": b_layer["plain"], "old_route_ms": b_layer["old"],
        "bound_ms": b_layer["bound"], "bound_by": b_layer["bound_by"],
        "library_ms": None, "bare_rows": b_main["rows"],
        "bare_ms": b_main["kernel"], "bare_lbubble_ms": b_main["lbubble"],
        "bare_no_steps_ms": b_main["no_steps"],
        "bare_plain_ms": b_main["plain"], "bare_bound_ms": b_main["bound"],
        "flooding_rows": b_flood["rows"], "flooding_ms": b_flood["kernel"],
        "flooding_lbubble_ms": b_flood["lbubble"],
        "flooding_plain_ms": b_flood["plain"],
        "flooding_bound_ms": b_flood["bound"],
        **bf16_fields(b16["bubble_layer"]),
    }, {
        "name": "list_checknode", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/list_checknode.cu",
        "replaces": "ems_nbldpc_tpu/ops/listcn.py:79-378, "
                    "ems_nbldpc_tpu/decoder/layered.py:567-611",
        "entry_points": ["list_layer"],
        "launches": paths["list_layer"]["list-EMS row (4c)"],
        "paths": list(paths["list_layer"]),
        "launches_by_path": paths["list_layer"],
        "max_abs_err": max(list_err, gen_err),
        "frames": list_times["bf16"]["frames"],
        "rows": list_times["bf16"]["rows"], "ms": list_times["bf16"]["kernel"],
        "plain_ms": list_times["bf16"]["plain"],
        "bound_ms": list_times["bf16"]["bound"],
        "bound_by": list_times["bf16"]["bound_by"], "library_ms": None,
        "f32_ms": list_times["f32"]["kernel"],
        "f32_plain_ms": list_times["f32"]["plain"],
        "f32_bound_ms": list_times["f32"]["bound"],
        **{f"{key}_{field}": val for key, t in gen_times.items()
           for field, val in (("ms", t["kernel"]), ("plain_ms", t["plain"]),
                              ("bound_ms", t["bound"]), ("nm", t["nm"]),
                              ("nboper", t["nboper"]))},
    }, {
        "name": "decide", "route": "cuda",
        "source": "ems_nbldpc_torch/csrc/decide.cu",
        "replaces": "ems_nbldpc_tpu/decoder/layered.py:250, :328, :711 "
                    "(XLA argmin; no Pallas kernel)",
        "entry_points": ["decide_rows"], "bound_by": "bytes",
        **{f"{key}_{share}": t[share] for key, t in decide_times.items()
           for share in ("100%", "30%", "1%")},
        **{f"{key}_{field}": t[field] for key, t in decide_times.items()
           for field in ("reset", "plain", "library", "frames")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
