#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and no phase carries on:

1. Toolchain: torch / CUDA / nvcc versions and the card's name and power
   limit; build the kernels (one nvcc per source) and the native CSV
   tokenizer (g++), all in parallel.
2. Each level kernel against its plain version on the card, at the
   flagship width (F=10, B=126, int8 bins, 1M rows, levels d=0..5), one
   level at Lh=256 (depth bucket 10) and one int32-bin level at B=200.
   Then a depth-20 tree's deep levels (``deep_levels``): d = 15 whole and
   d = 19's histogram and routing, EXACT with dyadic stats.
   Small-integer ("dyadic") stats must match EXACTLY; real-valued stats
   within the stated tolerance, split flips only at near-ties; with
   real-valued stats ``tree_hist`` on the rows permuted (bins, nid and
   stats alike) gives bit-identical histograms (64-bit fixed point).
3. One ``grow_tree`` on the airlines bins with dyadic g/h, through the
   kernels and through the plain versions: the Trees must be equal.
4. The main path: a 5M-row airlines-schema frame, ``GBMEstimator(
   ntrees=10, max_depth=6, seed=1).train`` and ``predict``, with every
   launch count = 10 trees x 6 levels; training metrics, throughput and
   peak memory; the output checked against the CPU plain path on a small
   sample; then the binning pass alone and a 1-tree fit under
   torch.profiler (where the time goes).
5. Kernel timings at the main path's shapes (5M rows, d=0..5) with CUDA
   events (``time_ms``: device time with L2 flushed, host-paced time and
   the wrapper's host time), beside their plain versions, a library yardstick and the bound from
   bytes and operations, each output EXACT against its plain version;
   then the three level kernels at the DRF path's deeper levels d=6..9
   (L = 64..512) of the same rows with DRF's per-node mtries masks, and
   ``tree_split``'s floor (L = 1, F = 1, B = 3).
6. The DRF path on phase 4's frame: ``DRFEstimator(ntrees=10,
   max_depth=10, seed=1)`` with the default mtries (sqrt(F) columns per
   node, so ``tree_split`` takes [L, F] masks) and sample_rate 0.632;
   every level kernel launched 10 x 10 times; OOB AUC. Before it, one
   ``grow_tree`` with mtries through the kernels and through the plain
   versions from the same generator state: the Trees must be equal.
7. The ``histogram`` kernel (full histogram, no sibling subtraction)
   against its plain version on a 1M-row slice of the uplift data (F=12,
   B=65, int8 bins) at L = 1, 8, 64, 512 with 0/1 stats: EXACT; once
   with int32 bins; real-valued stats within the summation bound; one
   ``_grow_uplift_tree`` through the kernel and through the plain
   version: the Trees must be equal.
8. The uplift main path: 13,979,592 rows of the Criteo Uplift v2.1
   schema, ``UpliftDRFEstimator(ntrees=10, max_depth=10, ...).train``,
   ``_score_raw`` and ``model_performance``; ``histogram`` launched
   2 x 10 x 10 times and no level kernel; where the time goes (binning
   alone, the training metrics alone, a 1-tree fit under torch.profiler);
   AUUC and Qini checked against the CPU plain path on a 20K-row sample.
9. ``histogram`` timed at the uplift path's shapes (d=0..9), as phase 5.
10. The sharded tree level over W = 2 ranks (spawned processes, one
    rank each, joined by ``core.cloud.init``: gloo with both ranks on one
    card, NCCL with one card per rank where there are two), each rank
    ingesting only its own 2.5M of phase 4's rows through
    ``Frame.from_numpy_partitioned``. At d=0..5 with dyadic stats:
    ``shard_hist`` == ``hist_plain`` and ``shard_partition`` ==
    ``partition_plain`` on every rank, and ``shard_hist`` over the mesh
    (its int64 cells all-reduced) == the plain sum; the histogram, the
    splits (identical on every rank) and the concatenated routing ==
    one card's ``tree_hist``/``tree_split``/``tree_partition`` over all
    5M rows. All EXACT.
11. The main path over the W ranks: the flagship GBM on the partitioned
    frame, ``train`` → ``predict`` → ``model_performance``; per rank the
    train seconds, launches (``shard_hist``, ``tree_split``,
    ``shard_partition`` 60 each, every other kernel 0), the all-reduce
    count, bytes and seconds, and peak memory; every rank's forest equal;
    AUC within 5e-3 of phase 4's; whether its forest is phase 4's bit
    for bit is printed.
12. ``shard_hist`` and ``shard_partition`` timed at one rank's shapes
    (2.5M rows, d=0..5) on the card alone, as phase 5.
13. Multinomial GBM on the UCI Forest CoverType schema (581,012 rows, 54
    numeric features, 7 classes with the published counts; generated from
    a seed): ``GBMEstimator(ntrees=10, max_depth=6, seed=1).train`` →
    ``predict`` → ``model_performance``, each level kernel launched
    10 x 7 x 6 = 420 times; a refit bit-equal (forest, training logloss
    and AUC); the 20K-row fit within 5e-3 of the CPU plain
    fit in logloss and weighted-OVR AUC; then the level kernels timed at
    its shapes (F = 54), as phase 5.
14. Multinomial DRF on phase 13's frame (as phase 6): 10 x 7 x 10 = 700
    launches a level kernel, OOB logloss and AUC; the 20K-row forest
    without bagging (sample_rate=1, mtries=54) EXACTLY the CPU plain
    forest.
15. One GBM for each new family (poisson, gamma, tweedie(1.5), laplace,
    quantile(0.5), quantile(0.9), huber(0.9)) on the first 1M airlines
    rows with a response of the family's domain: 60 launches a level
    kernel a fit; the poisson GBM's refit bit-equal (forest, deviance);
    the level kernels held on the log-link families'
    exp-scaled hessians as phase 2 holds real-valued stats; on the
    20K-row sample the laplace and quantile(0.5) forests (statistics in
    halves and ones) EXACTLY the CPU plain forests, the others' mean
    residual deviance within 5e-3 relative.
16. The flagship GBM with early stopping (``ntrees=50,
    stopping_rounds=2, score_tree_interval=1``) on an 80/20 split of
    those rows: (trees kept) x 6 launches a level kernel, the scoring
    history and the validation AUC.
17. The training surface on phase 4's frame and settings: (a) monotone
    (DepTime up, Distance down) and interaction constraints: 60 launches
    a level kernel, p1 monotone on 200-point grids, no tree path mixing
    two interaction sets, one constrained ``grow_tree`` on dyadic stats
    through the kernels equal to the plain versions', the 20K-row fit
    within 5e-3 AUC of the CPU's; (b) an offset column 0.002 *
    (DepTime - 1200): 60 launches, the 20K-row f0 within 1e-6 relative of
    the CPU's and predict's AUC within 5e-3; (c) checkpoint restarts
    5 -> 10 trees: GBM keeps the donor's trees (how it compares with
    phase 4's forest is printed), DRF bit-equal to phase 6's forest and
    OOB AUC; (d) 5-fold CV: 6 x 60 launches and ONE ``bin_frame`` call;
    (e) Platt and isotonic calibration on a 1M-row frame, Platt's (a, b)
    equal to numpy's fit on the fetched p1; (f) ``max_runtime_secs``: a
    3600 s cap leaves DRF's and a sampled laplace GBM's forests bit-equal
    to the uncapped fits', a 0.05 s cap keeps a prefix of 1-9 trees, and
    the flagship refit under the loose cap is bit-equal to phase 4's
    forest and training AUC and logloss (every sum of a fit on the card
    is 64-bit fixed point, so fits are deterministic); the cost of the
    device wait after each tree is printed.
18. CSV ingest → the flagship GBM: phase 4's 5M rows written as CSV
    (numpy byte operations; categoricals as levels, the response as
    NO/YES), read by ``stream_import_csv`` at the default worker count
    and with ``workers=1`` (bit-identical frames) and by
    ``import_file``, each frame held against the written arrays; ingest
    seconds, MB/s and rows/s; the flagship trained on the streamed frame
    (60 launches a level kernel) with binning and forest bit-equal to
    the fit on ``Frame.from_numpy`` of the same values.

19. The XGBoost facade and DRF's histogram types on phase 4's frame:
    ``XGBoostEstimator`` with phase 4's settings in h2o-py's names (forest
    bit-equal to phase 4's GBM, 60 launches a level kernel) and again with
    ``reg_lambda`` and ``gamma`` set (AUC); DRF at phase 6's settings with
    ``histogram_type`` UniformAdaptive and Random: edges, nbins and bins
    EXACT against the CPU plain binning, 100 launches a level kernel, OOB
    AUC, the 20K-row unbagged forest (mtries = F) EXACTLY the CPU plain
    forest.
20. The isolation forests on phase 4's rows with 5,000 anomalies planted
    from a seed: one isolation tree (depth 8, a 256-row bag) grown from
    fixed draws on the card equal to the CPU plain version's, and every
    row's path length; ``IsolationForestEstimator`` at its defaults
    (ntrees=50, sample_size=256, max_depth=8): ``tree_partition`` launched
    50 x 8 times growing and as many again for the training metrics, 400
    for ``predict``, the planted rows at AUC >= 0.95, a same-seed refit
    bit-equal; ``tree_partition`` timed at its levels (d=0..7, B = 65);
    ``ExtendedIsolationForestEstimator`` at its defaults (ntrees=100,
    sample_size=256) on the 7 numeric columns with extension_level 0 and
    6 (no kernel), AUC >= 0.9; train and predict seconds.
21. The scoring surface of phase 4's GBM and phase 6's DRF over the 5M
    rows: ``predict_leaf_node_assignment`` and ``feature_frequencies``
    EXACT against the CPU plain versions on 20K rows, the leaf values at
    the assigned ids adding up to the margin (mean vote); GBM's
    ``staged_predict_proba``, its last stage equal to ``predict``;
    ``predict_contributions`` (TreeSHAP, plain torch on the card) with
    local accuracy on every row it covers (GBM all 5M rows, DRF 250K:
    the cut and its reason are printed; 1M before phase 22 came) and within 1e-5·max(1, |margin|) of
    the CPU plain version's (GBM on 20K rows, DRF on 2K); seconds and
    peak memory. No kernel runs on this path.
22. GLM (no kernel: the Gram is a cuBLAS SGEMM with TF32 held off, the
    solvers plain torch). (a) bench.py's GLM benchmark at its shape,
    nothing cut: 11,000,000 x 28 float32 from RandomState(3), binomial,
    standardize, lambda 0; IRLSM (max_iterations=8) and L-BFGS (40):
    train seconds, row-iterations/s, AUC and peak memory, each refit
    bit-equal; the IRLSM fit's de-standardized coefficients within 0.02
    of the generating beta, L-BFGS's AUC within 1e-3 of IRLSM's; the Gram
    at the fit within 2^-16·Σ|w x x| of a float64 Gram, inside the
    float32 summation bound (the error of a TF32 product printed beside
    it); one Gram pass timed
    against its bound, one IRLS iteration timed; on the first 1M rows the
    card and the CPU plain fits agree (metric and coefficients, the
    tolerances stated at GLM_TOL). (b) Elastic net with lambda search
    (alpha 0.5, 30 lambdas) on the first 1M airlines rows, the gaussian
    ``airlines_delay`` response, P = 263: path length, lambda_best,
    nonzero count, R2, seconds; a 20K-row head against the CPU plain fit.
    (c) Multinomial on phase 13's Covertype frame (K = 7, solver auto =
    IRLSM): logloss and seconds (the block IRLS diverges on this design
    as the reference's does: its logloss and largest coefficient are
    printed), its margins on 20K rows within the float32 dot bound of the
    CPU plain path's; L-BFGS beside it, its coefficients, probabilities
    and training logloss held against the CPU plain fit's on a 20K-row
    head, beside the same fit with the head's rows permuted on the CPU
    and on the card (the witness of float32 order). (d) On 10K airlines
    rows (cut from 100K when phase 27 came: the solvers are host-paced,
    a fit takes as long on the head): ``non_negative`` and
    ``beta_constraints`` (COD), p-values
    (gaussian, binomial), an ordinal fit, multinomial IRLSM on a 3-class
    response with a ridge (Cholesky) and with L1 (ADMM), interactions
    (DepTime x Distance, UniqueCarrier x Month), 3-fold CV with lambda
    search (10 lambdas), each against the CPU plain fit on the same rows
    (the multinomial fits' probabilities too); one COD and one ADMM IRLS
    iteration timed at P = 263.
23. DeepLearning (no kernel: cuBLAS products with TF32 off, bf16 GEMMs
    from a batch of 16,384, plain torch). (a) bench.py's DL benchmark at
    its shape, nothing cut: 1,000,000 x 784 pixels rand > 0.8 from
    RandomState(5) and a 10-class label, ``hidden=[200, 200]``,
    rectifier, 8 epochs (batch 8192, float32) after a 0.1-epoch warm-up
    fit: train seconds, samples/s beside the published 80K, peak memory,
    the training error and the early-stopping history; a refit
    bit-equal; one step timed (device, host-paced, host) and a 20-step
    chunk under torch.profiler (no scatter or atomic kernel). (b) On a
    8,192-row head (cut from 16,384 when phase 27 came), card vs CPU
    plain from the same initial weights,
    every step held from the card's state (``dl_card_vs_cpu``), then the
    same on its first quarter with TF32 on, which must fail. (c) bf16
    (``mini_batch_size=16384``) on (a)'s frame: the route of the product
    (it must be ``mm_out_dtype``), seconds and samples/s; on a
    32,768-row head (cut from 65,536) card vs CPU with bf16 on both
    sides, then on its
    first half with bf16-rounded products, which must fail. (d) On 10,000
    airlines rows (cut from 20,000 when phase 27 came)
    (P = 263): Tanh, Maxout (3
    classes), both with dropout, momentum SGD with Nesterov and a ramp
    under L1/L2, regression, the autoencoder and ``anomaly``, early
    stopping with a validation frame, a ``checkpoint=`` restart (dropout
    on: bit-equal to the straight fit) and 3-fold CV; each without
    dropout against the CPU plain fit on the same rows.
24. The unsupervised and count-based algorithms (no kernel: cuBLAS
    products with TF32 off, cuSOLVER factorizations, fixed-point
    segment sums, plain torch); each fit with train seconds, peak
    memory and a refit bit-equal, each held card vs CPU plain on a
    20K-row head (tolerances at N_UNSUP_CPU). (a) KMeans on phase
    22(a)'s HIGGS frame (11M x 28, nothing cut), k = 10, Furthest,
    standardized, 20 steps at most: steps, row-steps/s, tot_withinss,
    betweenss/totss; one Lloyd step timed against its byte bound; on 1M
    rows PlusPlus, Random, estimate_k, 3-fold CV and user_points; the
    host float64 ``cluster_size_constraints`` fit on 10,000 rows. (b)
    PCA at MNIST's width (500K x 784, cut from 1M when phase 27 came,
    from RandomState(13), a rank-60
    signal plus noise), k = 50, GramSVD and Randomized: the Gram timed
    against its bound, ``eigh`` timed, Randomized's subspace against
    GramSVD's; PCA (P = 262) and SVD (nv = 10, standardized) on 1M
    airlines rows. (c) GLRM on 1M airlines rows (P = 265, all levels,
    5% of the numeric cells NA): k = 10, standardized, quadratic
    regularizers (0.1), 50 steps at most: steps, objective, peak memory
    beside the reference's einsum form; the batched k x k solve timed;
    L1 and NonNegative on the head. (d) Naive Bayes on phase 4's 5M
    rows (laplace 1): AUC, train and predict seconds; the Covertype
    schema: logloss; 3-fold CV on 1M rows. (e) The Target Encoder on
    phase 4's 5M rows (Origin, Dest, UniqueCarrier; kfold over a 5-fold
    modulo column, blending, noise 0.01, seed 1234): fit and
    ``transform(as_training=True)`` seconds; ``none`` and ``loo`` on the
    head, every head EXACT card vs CPU.
25. GAM, RuleFit, ModelSelection and ANOVA-GLM, Isotonic Regression and
    Infogram; each fit with train seconds, peak memory, a refit
    bit-equal on the card and a head held card vs CPU plain at the
    tolerances of their CPU tests. (a) GAM on phase 22(a)'s HIGGS frame
    (11M x 28, nothing cut), binomial, x0..x2 as splines with 10 knots
    each (P = 25 + 33 + 1): the basis seconds, PIRLS steps, AUC, one
    Gram pass against its bound; a gaussian GAM on 1M rows with a
    planted sin(1.7x) + 0.5·lin (RMSE to the truth < 0.15, a GLM's >
    0.4). (b) RuleFit with the reference's defaults (GBM, rule length
    3, 50 trees, sample_rate 0.8, rules and linear terms, lambda search)
    on phase 4's first 500K rows (cut from 5M for the rule matrix, from
    1M when phase 27 came): the
    seconds of the trees, the rule frame and the GLM, the rule count,
    AUC and the top five rules; ``algorithm="drf"`` and
    ``model_type="linear"`` on a head; the head's rules EXACT card vs
    CPU at sample_rate 1. (c) ModelSelection ``maxr`` (3 predictors of
    28) on the first 1M HIGGS rows (cut for time): GLM fits, seconds a
    fit, the chosen sets against the generating beta; ``backward`` and
    ``allsubsets`` over x0..x6 on a head; ANOVA-GLM over x0..x6 with
    pairwise products (28 terms, 29 fits). (d) Isotonic Regression of
    phase 4's departure delay on DepTime (5M rows): thresholds, seconds,
    MSE, thresholds EXACT card vs CPU. (e) Infogram, core and fair
    (protected UniqueCarrier), on the first 1M airlines rows: the table,
    admissible features, GBM fits. GAM, the two wrappers and Isotonic
    launch no kernel; RuleFit's and Infogram's tree fits launch the
    three level kernels once a level of every tree.
26. CoxPH, PSVM, the Aggregator, Word2Vec, the device quantiles and
    the sort, no kernel; each fit with a refit bit-equal on the card and
    a head card vs CPU plain at the tolerances of their CPU tests. (a)
    CoxPH on 1M seeded survival rows (``cox_columns``: 10 numeric and a
    5-level covariate with a known beta, 4 strata, left truncation,
    whole days), Efron then Breslow: the tie groups, the host risk
    structure's seconds, Newton iterations, concordance, each
    coefficient against beta in standard errors (Efron within 4); the
    card's float32 ``cumsum`` and the port's float64 prefix sums against
    a float64 ``cumsum``. (b) PSVM on phase 13's Covertype rows, class
    "2" against the rest, at the defaults: ICF seconds, Newton steps, a
    step against its bound, the support vectors, AUC (> 0.7) beside a
    GLM's. (c) The Aggregator at its defaults on the first 1M HIGGS
    rows (cut from 11M for its host loop): sweeps, radius, exemplars
    (<= 5000, counts summing to the rows), the host loop's share. (d)
    Word2Vec at its defaults, one epoch (cut from 5), on a 500K-token
    Zipf(1.0) corpus over 30K types with two planted 8-word topics (the
    refit held bit-equal on its first 50K tokens): the
    vocabulary, pairs, steps/s, a step at batch 64 and 4096, the planted
    words' synonyms (2 of the top 3 in their topic). (e) The device
    quantiles of HIGGS x0 (11M rows) against ``np.quantile``,
    ``frame_quantiles`` of phase 4's 5M rows, a 4,194,304-row head card
    vs CPU EXACT. (f) ``device_sort`` of phase 4's 5M rows by
    (UniqueCarrier, DepTime descending) against ``np.lexsort``, and a
    5M × 1M ``device_join_index`` against a numpy join, EXACT.
27. The job and orchestration layer (no new kernel; the DKV is emptied
    at every phase's start, so each phase's models live only as long as
    its locals). (a) bench.py's grid config: 500K rows x 6 numeric, 16
    GBM combos (learn_rate x sample_rate x min_rows), ``ntrees=20,
    max_depth=6, seed=1``, the sequential walk: models/s, every level
    kernel launched 16 x 20 x 6 = 1,920 times, every grid model's forest
    and training AUC bit-equal to a standalone fit of its combo;
    RandomDiscrete with ``max_models=5, seed=42`` gives 5 models in the
    reference's combo order (``GRID_RANDOM_ORDER``, computed from
    ``h2o3_tpu/ml/grid.py``). (b) ``train_capped`` of a 400-tree GBM
    under a 0.5 s cap returns a truncated forest; a DeepLearning fit
    under a cap below its length is cancelled at a ``job.update`` and
    raises ``TimeoutError``. (c) bench.py's AutoML config: 500K airlines
    rows written as CSV and read by ``stream_import_csv``,
    ``H2OAutoML(max_models=20, seed=1, nfolds=3,
    max_runtime_secs=300)``, run last: wallclock, models trained (a
    ``SHORTFALL`` line under 10), each leaderboard row (step, algo, CV
    AUC and logloss, train seconds, peak memory), the timeouts, the
    leader's AUC on the frame, launches and peak memory; no ``error``
    event, every depth-15/20 step (GBM_5, DRF_1, XRT_1, XGBoost_2)
    trained, the leaderboard sorted by CV AUC, both StackedEnsembles
    where two or more families trained with CV, the leader predicts, the
    level kernels launched and the others not. (d) Two runs of
    ``H2OAutoML(max_models=4, seed=1, nfolds=3, include_algos=["glm",
    "gbm", "stackedensemble"])`` on the first 100K rows of (c)'s CSV (the
    default 3600 s budget does not bite): the same steps in the same
    order, bit-equal leaderboards and leader p1. (e) (d)'s best-of-family
    metalearner fit from the same level-one frame on the card and on the
    CPU: coefficients within ``SE_COEF_TOL`` of max(1, |c|), or twice the
    largest witness (the CPU fit on the rows permuted, five permutations)
    where float32 order alone moves them more. (f) A depth-20 GBM (2
    trees, kept as HeapTrees) on (d)'s rows: ``predict_contributions``
    with local accuracy on every row and within 1e-5·max(1, |margin|) of
    the CPU plain version on 2,000 rows. Later phases' host data is made
    on a background thread while the earlier phases run (``make_ahead``).

Launch counts are read per path: each path sets every count to 0 just
before it runs and reads them just after (phase 15's, over its seven
fits, are their sum). The line before the last is
the ``{"kernels": [...]}`` record (every kernel, each with its own
source, the TPU kernel it replaces, the path and levels it was timed at
and its launches on that path; ``ms`` is device time (the mean over the
levels of each level's median call, ``ms_min``/``ms_max`` the fastest
and slowest call), ``host_paced_ms``
and ``host_us`` as ``time_ms`` says; the three level kernels three
times, at the GBM, the DRF and the multinomial GBM levels,
``tree_split``'s with its floor; ``launches_by_path`` gives each
kernel's launches on every path, phase 17's as ``gbm_constraints``,
``gbm_offset``, ``gbm_checkpoint`` (donor and restart), ``drf_checkpoint``
and ``gbm_cv``, phase 18's as ``gbm_csv``, phase 19's as ``xgboost``,
``xgboost_reg``, ``drf_uniform`` and ``drf_random``, phase 20's as
``isofor`` (the fit), ``isofor_predict``, ``extisofor_0`` and
``extisofor_6``, phase 21's as ``tree_scoring``, phase 22's as
``glm_irlsm``, ``glm_lbfgs``, ``glm_lambda_search``, ``glm_multinomial``
and ``glm_surface``, phase 23's as ``deeplearning``,
``deeplearning_bf16`` and ``deeplearning_surface``, phase 24's as
``kmeans``, ``pca``, ``svd``, ``glrm``, ``naivebayes`` and
``targetencoder``, every kernel 0 on each, phase 25's as ``gam``,
``rulefit``, ``modelselection``, ``anovaglm``, ``isotonic`` and
``infogram``, phase 26's as ``coxph``, ``psvm``, ``aggregator``,
``word2vec``, ``quantiles`` and ``sort``, every kernel 0 on each,
phase 27's as ``grid``, ``automl``, ``automl_repeat`` (both runs of
(d)), ``stackedensemble`` (the card's metalearner fit of (e)) and
``gbm_depth20`` ((f)'s fit);
``tree_partition`` has a
fourth record, at the Isolation Forest levels); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
FLAGSHIP = dict(ntrees=10, max_depth=6, seed=1)
DRF = dict(ntrees=10, max_depth=10, seed=1)
DRF_DEPTHS = range(6, 10)        # the DRF levels GBM's depth 6 never reaches
# Criteo Uplift Prediction v2.1 (Diemert et al., arXiv:2111.10106): its
# rows and widths; ntrees cut from the reference default 50 to 10
N_UPLIFT = 13_979_592
UPLIFT = dict(treatment_column="treatment", ntrees=10, max_depth=10,
              nbins=64, min_rows=10, sample_rate=0.632, mtries=-2,
              uplift_metric="KL", seed=1)
N_MAIN = 5_000_000
N_KERNEL = 1_000_000
# the card-vs-CPU samples of phases 8, 13-15, 17 and 19 (cut from 50K
# when phase 27(c) took its fixed 300 s budget, for the run's time: the
# CPU plain fits take most of those phases; the EXACT checks hold at any
# size, the others keep their tolerances)
N_SAMPLE = 20_000
# phase 13: multinomial GBM on the Covertype schema (ntrees cut from the
# default 50, as phase 4 cuts it); phase 14 runs DRF (as phase 6) on it
MULTI_GBM = dict(ntrees=10, max_depth=6, seed=1)
# phase 15: one GBM a family on the first N_DIST airlines rows
N_DIST = 1_000_000
DIST_GBM = dict(ntrees=10, max_depth=6, seed=1)
FAMILIES = (("poisson", {}), ("gamma", {}), ("tweedie", {"tweedie_power": 1.5}),
            ("laplace", {}), ("quantile", {"quantile_alpha": 0.5}),
            ("quantile", {"quantile_alpha": 0.9}),
            ("huber", {"huber_alpha": 0.9}))
# statistics that sum exactly in any order: these fits must be EXACT
DYADIC_FAMILIES = (("laplace", {}), ("quantile", {"quantile_alpha": 0.5}))
# phase 16: the flagship with early stopping on an 80/20 split of N_DIST
STOPPING = dict(FLAGSHIP, ntrees=50, stopping_rounds=2,
                score_tree_interval=1)
# phase 17: the training surface on phase 4's frame and settings
MONOTONE = {"DepTime": 1, "Distance": -1}
INTERACTIONS = [["DepTime", "CRSDepTime"], ["UniqueCarrier", "Month"]]
N_GRID = 200                     # monotonicity probe points
N_CAL = 1_000_000                # calibration frame rows
CV = dict(FLAGSHIP, nfolds=5)
CAP_LOOSE_S, CAP_TIGHT_S = 3600.0, 0.05
# a GBM whose statistics sum exactly (sign gradients, unit hessians), with
# row and column sampling: deterministic on the card
LAPLACE = dict(FLAGSHIP, distribution="laplace", sample_rate=0.7,
               col_sample_rate_per_tree=0.8)
# phase 19: phase 4's settings in h2o-py's XGBoost names (the GBM
# defaults spelled out), then with its regularisation; DRF's histogram
# types beside phase 6's quantiles
XGB = dict(nrounds=10, max_depth=6, seed=1, eta=0.1, max_bins=64,
           min_child_weight=10.0)
XGB_REG = dict(XGB, reg_lambda=1.0, gamma=1e-3)
HISTOGRAM_TYPES = ("UniformAdaptive", "Random")
# phase 20: anomalies planted among phase 4's rows; both forests at the
# h2o-py defaults (IsolationForest ntrees=50, sample_size=256,
# max_depth=8; ExtendedIsolationForest ntrees=100, sample_size=256)
N_PLANT = 5_000
ISOFOR = dict(seed=1)
EXTISOFOR = dict(seed=1)
NUMERIC = ("Year", "Month", "DayofMonth", "DayOfWeek", "DepTime",
           "CRSDepTime", "Distance")
# phase 21: rows held against the CPU plain versions; DRF contributions
# on fewer rows (a depth-10 tree has ~1000 leaves), and fewer again on
# the CPU
N_CHECK = 20_000
# cut from 1M to 250K rows when phase 22 (GLM) came, and to 50K
# (its CPU head from 2,000 to 500 rows) when phase 27 came: the run's
# time, not the card, bounds it
N_SHAP_DRF = 50_000
N_SHAP_DRF_CPU = 500
Y = "IsDepDelayed"
# phase 22: GLM. (a) bench.py's GLM benchmark (BASELINE.json: "GLM
# binomial IRLS + L-BFGS, HIGGS 11M rows") at its shape, nothing cut;
# (b) elastic net with lambda search, (c) multinomial, (d) the surface
N_HIGGS = 11_000_000
P_HIGGS = 28
HIGGS_GLM = dict(family="binomial", lambda_=0.0, standardize=True)
HIGGS_FITS = (("irlsm", 8), ("l_bfgs", 40))
N_HIGGS_CPU = 1_000_000
N_ENET = 1_000_000
N_ENET_CPU = 20_000
ENET = dict(family="gaussian", alpha=0.5, lambda_search=True, nlambdas=30)
P_AIRLINES = 263                 # 7 numeric + 7 + 124 + 124 levels + 1
MULTI_GLM = dict(family="multinomial")
# cut from 100K to the CPU head's 10K rows when phase 27 came: the
# surface's solvers are host-paced (COD's sweeps, ADMM's iterations), so
# a fit took as long on the head, and the card's head fit now serves both
N_SURFACE = 10_000
N_SURFACE_CPU = 10_000
# card vs CPU plain, each fit on the same head: the training logloss (or
# MSE) within GLM_METRIC_TOL relative, and the raw-scale coefficients
# within a tolerance a fit relative to max(1, |c|), set from the same
# fits on the CPU with the head's rows permuted (float32 sums in another
# order; 8-core CPU, torch 4 threads): IRLSM on HIGGS 5.5e-7, its
# unpenalized gaussian at P = 263 8.2e-4 (Origin and Dest levels of ~160
# rows each), COD 7.9e-5 (50 sweeps stop short), ADMM paths 2.4e-5,
# L-BFGS 7.1e-5 (HIGGS); the ordinal fit's 200 L-BFGS iterations stop
# short of its 265 parameters (1.3e-2): its coefficients are printed, its
# logloss held. The converged multinomial IRLSM fits on the airlines
# 3-class response (ridge and L1): coefficients 3.4e-5, probabilities
# 9e-7, held at GLM_TOL and GLM_PROB_TOL. The multinomial L-BFGS fit on
# the Covertype head stops short too (50 iterations, 385 parameters, the
# one-hot groups collinear with the intercept): row permutations move
# its coefficients and probabilities by up to 1.1e-2 and its logloss by
# 9.7e-5 relative (torch 1 and 4 threads), so they are held at
# GLM_MULTI_LBFGS_TOL and GLM_LBFGS_METRIC_TOL, and phase 22(c) prints
# the same witness from a permuted fit on the CPU and on the card
GLM_METRIC_TOL = 1e-6
GLM_TOL = 1e-4
GLM_PROB_TOL = 1e-5
GLM_WIDE_TOL = 5e-3
GLM_COD_TOL = 1e-3
GLM_ADMM_TOL = 1e-3
GLM_LBFGS_TOL = 2e-3
GLM_MULTI_LBFGS_TOL = 3e-2
GLM_LBFGS_METRIC_TOL = 3e-4
# the Gram against float64, max |diff| / sum|w x x|: float32 sums stay
# far inside 2^-16 (5.9e-7 at 11M rows); a TF32 product does not (6.2e-4)
GRAM_F32_REL = 2.0 ** -16
SURFACE_FITS = (
    ("cod non_negative", "delay", GLM_COD_TOL,
     dict(family="gaussian", lambda_=0.0, non_negative=True)),
    ("cod beta_constraints", "delay", GLM_COD_TOL, dict(
        family="gaussian", lambda_=0.0,
        beta_constraints={"DepTime": (0.0, 5.0),
                          "UniqueCarrier.DL": (-1.0, 1.0)})),
    ("p-values gaussian", "delay", GLM_WIDE_TOL,
     dict(family="gaussian", lambda_=0.0, compute_p_values=True)),
    ("p-values binomial", Y, GLM_TOL,
     dict(family="binomial", lambda_=0.0, compute_p_values=True)),
    ("ordinal", "late", None, dict(family="ordinal", lambda_=0.0)),
    ("multinomial irlsm ridge", "late", GLM_TOL,
     dict(family="multinomial", solver="irlsm", lambda_=1e-3, alpha=0.0)),
    ("multinomial irlsm l1 (ADMM)", "late", GLM_TOL,
     dict(family="multinomial", solver="irlsm", lambda_=1e-3)),
    ("interactions DepTime x Distance", "delay", GLM_WIDE_TOL,
     dict(family="gaussian", lambda_=0.0,
          interactions=["DepTime", "Distance"])),
    ("interactions UniqueCarrier x Month", "delay", GLM_ADMM_TOL,
     dict(family="gaussian", lambda_=0.05, alpha=0.0,
          interactions=["UniqueCarrier", "Month"])),
    ("cv lambda search", "delay", GLM_ADMM_TOL,
     dict(family="gaussian", nfolds=3, seed=7, lambda_search=True,
          nlambdas=10)))
# Phase 23, DeepLearning: bench.py's benchmark (bench.py:336-386), nothing
# cut: 1M x 784 0/1 pixels from RandomState(5), 10 classes, [200, 200]
# rectifier, 8 epochs after a 0.1-epoch warm-up fit; the published H2O
# rate beside it (hex/deeplearning/README.md:26, one node)
N_DL = 1_000_000
P_DL = 784
DL = dict(hidden=[200, 200], activation="rectifier", seed=1)
DL_EPOCHS, DL_WARMUP = 8.0, 0.1
DL_PUBLISHED = 80_000.0          # samples/s
# (b) card vs CPU: batch 256, 32 steps; (c) card vs CPU in bf16: batch
# 16,384, 4 steps (each cut to half when phase 27 came, for the run's
# time)
N_DL_HEAD = 8_192
N_DL_BF16_HEAD = 32_768
DL_BF16_BATCH = 16_384
# (d) the airlines head, P = 263 (cut from 20,000 when phase 27 came, for
# the run's time)
N_DL_SURFACE = 10_000
DL_SURFACE = dict(hidden=[32, 16], epochs=2, seed=3)
# card vs CPU plain (``dl_card_vs_cpu``). Every step of the card's fit is
# held against the CPU plain step taken from the card's state before it,
# on the card's design (``dl_replay``): each hidden pre-activation within
# its float32 error bound of the CPU's (``dl_preactivations``), and the
# update within DL_STEP_TOL (float32 products) or DL_BF16_STEP_TOL (bf16
# products) relative RMS (``dl_step_gap``). A step over it passes only
# where float32 order explains it: a hidden unit of the batch decided
# the other way (a rectifier's sign, a maxout pair's order) within the
# bound of the tie (``dl_tie_flips``), and the same step with those rows
# at weight 0 within the tolerance. Where no step flips, a float32 fit
# replayed whole on both devices is held too: weights (relative to
# max(1, max|W|)) within DL_TOL and scores (relative to max(1,
# max|score|)) within DL_PROB_TOL; a bf16 fit is held step by step only
# (a bf16 rounding of a gradient element parts the fits at every step).
# The card's scores against the CPU's scoring of the same net within
# DL_SCORE_TOL. The estimator's own CPU fit takes its own design, which
# the card's standardization parts in the last bits; its gaps are
# printed, not held. A fit with TF32 left on (phase 23(b)) and one with
# bf16-rounded products (23(c)) must fail. Readings from
# ``scripts/dl_limits.py`` and phase 23 (NVIDIA H100 80GB HBM3, 700 W;
# the largest sound fit, the smallest control): the bound 0.075 and
# 0.85 of it; steps 9.7e-6 and 7.1e-4; replayed weights 1.7e-7 and
# 1.8e-4, scores 3.1e-7 and 2.1e-4; the same net's scores 6.0e-7 and
# 4.3e-6. bf16 steps read 1.5e-3 to 2.8e-3 sound (the same head reads
# 1.7e-3 alone and 2.8e-3 after phase 23(a) in one process; the cause,
# likely bf16 roundings of gradients that go two ways, is not verified)
# and 4.2e-3 to 8.0e-3 with
# bf16-rounded products: no step limit leaves both a margin, so
# DL_BF16_STEP_TOL keeps 3.6x over the sound readings against gross step
# errors and the pre-activation bound (7.5 against 0.075) catches that
# control. DL_METRIC_TOL holds the early-stopping losses and the CV
# metrics (relative; AUC absolute).
DL_STEP_TOL = 1e-4
DL_BF16_STEP_TOL = 1e-2
DL_TOL = 5e-6
DL_PROB_TOL = 1e-5
DL_SCORE_TOL = 2e-6
DL_METRIC_TOL = 1e-4
# phase 24: the unsupervised and count-based algorithms (no kernel).
# (a) KMeans on bench.py's GLM frame (the HIGGS shape, nothing cut); the
# other inits, estimate_k, CV and user_points on its first N_KM_HEAD rows,
# the host float64 constrained fit on N_KM_CONS rows
KMEANS = dict(k=10, init="Furthest", standardize=True, max_iterations=20,
              seed=1)
N_KM_HEAD = 1_000_000
N_KM_CONS = 10_000
KM_CONS = dict(k=10, seed=1, cluster_size_constraints=[800] * 10)
# (b) PCA at MNIST's width: a rank-60 signal whose singular values fall
# by 0.95 a component, plus uniform noise at 1% of the smallest
N_PCA = 500_000                  # cut from 1M when phase 27 came (time)
P_PCA = 784
RANK_PCA = 60
K_PCA = 50
# (b) PCA and SVD (standardized: on the raw columns float32 resolves
# only the top three singular values of this design, whose squares span
# 1e8; two CPU fits of a 20K-row head on permuted rows put d4..d10 1e-4
# to 0.15 apart, |Δλ| ~1e-7·λ1: ``scripts/unsup_witness.py``) and (c)
# GLRM on airlines rows
N_DIMRED = 1_000_000
# (c) GLRM on all levels of the airlines predictors (P = 265), 5% of the
# numeric cells planted NA; L1 and NonNegative on x on a head (Random
# init: no eigenvector sign to differ between devices; NonNegative on
# both sides is not reproducible in float32 at this shape: two CPU fits
# on permuted rows stop at 49 and 50 steps, their A·Y 392x apart,
# ``scripts/unsup_witness.py``)
GLRM = dict(k=10, transform="standardize", loss="Quadratic",
            regularization_x="Quadratic", regularization_y="Quadratic",
            gamma_x=0.1, gamma_y=0.1, max_iterations=50)
GLRM_NA = 0.05
GLRM_HEAD_FITS = (("L1", dict(regularization_x="L1", gamma_x=0.05)),
                  ("NonNegative", dict(regularization_x="NonNegative")))
# (d) Naive Bayes: phase 4's rows, Covertype, 3-fold CV on N_NB_CV rows
NB = dict(laplace=1.0)
N_NB_CV = 1_000_000
# (e) the Target Encoder on phase 4's rows
TE = dict(data_leakage_handling="kfold", fold_column="fold", blending=True,
          noise=0.01, seed=1234)
TE_COLS = ("Origin", "Dest", "UniqueCarrier")
N_TE_FOLDS = 5
# card vs CPU plain on heads of N_UNSUP_CPU rows, at the tolerances of
# tests/test_torch_{kmeans,dimred,naivebayes,targetencoder}.py: KMeans
# centers within 1e-5·max(1, |c|), metrics 1e-5 relative, step counts
# equal, assignments equal off near-ties; eigen- and singular values
# 1e-4 relative, vectors 1e-4 up to sign where the eigenvalues lie 10%
# apart and the top-k subspaces within 1e-4 (the least cosine); GLRM
# objectives 1e-4 relative, archetypes 1e-3·max(1, |y|), steps equal,
# and A·Y 3e-2·max(1, |A·Y|): the reconstruction's per-row solve (ridge
# 1e-6) amplifies the archetypes' last bits on the airlines design (two
# CPU fits of a 20K-row head on permuted rows: A·Y 9.4e-3 apart, the
# archetypes 2.1e-4, the objective equal, ``scripts/unsup_witness.py``;
# the tests' rank-3 data holds A·Y to 1e-3); Naive
# Bayes priors and tables (from counts) 1e-6 relative; means and
# deviations within the CPU's float32 summation bound over the head's n
# rows, n·2^-24 of their scale (a mean within n·2^-24·√(μ² + σ²), a
# deviation within n·2^-24·(μ² + σ²)/σ: the card's sums are fixed
# point, the CPU's run in float32 over same-signed terms, beyond the
# tests' 2e-6 at these row counts); the card's
# probabilities within 1e-5 of the CPU's scoring of the same statistics
# (the CPU's own float32 E[x²] − μ² of a raw column such as Year
# cancels, so its fit's probabilities are printed, not held); Target
# Encoder EXACT.
N_UNSUP_CPU = 20_000
KM_CENTER_TOL = 1e-5
KM_METRIC_TOL = 1e-5
EIG_TOL = 1e-4
VEC_TOL = 1e-4
GLRM_OBJ_TOL = 1e-4
GLRM_Y_TOL = 1e-3
GLRM_AY_TOL = 3e-2
NB_STAT_TOL = 1e-6
NB_PROB_TOL = 1e-5
REF_EINSUM_GB = 10.6             # one [1M, 10, 265] float32 einsum
# phase 25: the GLM wrappers, Isotonic Regression and Infogram. Heads
# card vs CPU plain of N_P25_HEAD rows (RuleFit's of N_RULEFIT_HEAD: its
# CPU lambda search over ~400 columns) at the tolerances of
# tests/test_torch_{gam,rulefit,model_selection,isotonic,infogram}.py.
GAM_HIGGS = dict(family="binomial", gam_columns=["x0", "x1", "x2"],
                 num_knots=[10, 10, 10])
P_GAM = 59                       # 25 linear + 3 x 11 spline + 1
# tests/test_torch_gam.py's GAM_COEF_TOL and GAM_PRED_TOL hold a head, or
# 4x the CPU fit's own distance to the float64 PIRLS fixed point where
# that is larger (gam_card_vs_cpu: the HIGGS head's A has cond ~1.3e4,
# and LAPACK's and cuSOLVER's float32 Cholesky part by ~8e-4, while
# row-permuted CPU fits part by 3.3e-6)
# the HIGGS head's fit stops at beta_epsilon 1e-3: at the default 1e-4
# the float32 floor of a step's largest coefficient change (1.1e-4 to
# 2.7e-4 from step 5 on, on the CPU at 20K rows) sits at the threshold,
# where the step count is a coin toss between two summation orders
GAM_HIGGS_HEAD = dict(GAM_HIGGS, beta_epsilon=1e-3)
N_GAM_SIN = 1_000_000
GAM_SIN = dict(gam_columns=["x"], num_knots=[12], scale=[0.01])
GAM_COEF_TOL = 3e-5
GAM_PRED_TOL = 2e-5
RULEFIT = dict(seed=1)           # the reference's DEFAULTS otherwise
N_RULEFIT = 500_000              # cut from 1M when phase 27 came (time)
N_RULEFIT_HEAD = 10_000
RF_COEF_TOL = 2e-3
RF_PRED_TOL = 2e-4
N_SEL = 1_000_000
SEL_MAXR = dict(mode="maxr", max_predictor_number=3)
SEL_X = tuple(f"x{i}" for i in range(7))
SEL_R2_TOL = 1e-5
ANOVA_LR_TOL = 2.0 ** -16        # of the full deviance
ANOVA_ALPHA = 0.01
INFOGRAM = dict(seed=1)
N_INFOGRAM = 1_000_000
IG_REL_TOL = 1e-5
IG_CMI_TOL = 2e-6
N_P25_HEAD = 20_000
# phase 26: CoxPH, PSVM, the Aggregator, Word2Vec, the device quantiles
# and the sort. Heads card vs CPU plain at the tolerances of
# tests/test_torch_{coxph,psvm,aggregator,word2vec,quantiles_sort}.py.
N_COX = 1_000_000
COX_NUM_BETA = np.array([0.5, -0.4, 0.3, -0.2, 0.1, 0.25, -0.15, 0.05,
                         0.0, 0.35])
COX_CAT_BETA = np.array([0.3, -0.2, 0.1, 0.4])    # c5 levels 1..4 vs 0
COX_MEDIAN = 1000.0              # days, the baseline's median survival
COX_CENSOR_MEAN = 2200.0         # days after entry
COX = dict(stop_column="stop", start_column="start", stratify_by=["s4"])
COX_COEF_TOL = 2e-3
COX_SE_REL = 1e-3
COX_LOGLIK_REL = 1e-6
COX_CONC_TOL = 1e-4
N_P26_HEAD = 20_000
N_PSVM_HEAD = 601                # the tests' data and size
PSVM_WB_TOL = 1e-4
PSVM_DEC_TOL = 1e-4
PSVM_AUC_TOL = 1e-5
N_AGG = 1_000_000                # of HIGGS's 11M rows: the host loop
N_AGG_HEAD = 3_001               # the tests' data and size
W2V_TOKENS = 500_000
W2V_REFIT_TOKENS = 50_000        # the refit's head (phase 26(d))
W2V_TYPES = 30_000
W2V_SENT = 20
W2V_TOPIC_FRAC = 0.05
W2V = dict(epochs=1, seed=1)     # the reference's DEFAULTS otherwise
W2V_TOPICS = [["cat", "dog", "pet", "fur"], ["car", "road", "wheel",
                                            "drive"]]
W2V_TOPIC = dict(vec_size=16, epochs=10, min_word_freq=2, window_size=3,
                 sent_sample_rate=0.0, seed=42)
W2V_REL = 1e-4
Q_PROBS = (0.001, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)
Q_HEAD = 4_194_304               # above the host path's 4,000,000 rows
Q_GAP = 1e-3                     # a few order statistics of N(0, 1)
JOIN_LEFT = 5_000_000
JOIN_RIGHT = 1_000_000
JOIN_KEYS = 2_000_000
N_GRID_ROWS = 500_000            # bench.py bench_grid
GRID_HYPER = {"learn_rate": [0.05, 0.08, 0.1, 0.15],
              "sample_rate": [0.7, 1.0], "min_rows": [5.0, 20.0]}
GRID_FIXED = dict(ntrees=20, max_depth=6, seed=1)
# the reference's RandomDiscrete walk of GRID_HYPER at seed 42, its first
# five combos (h2o3_tpu/ml/grid.py GridSearch._combos)
GRID_RANDOM_ORDER = (
    {"learn_rate": 0.05, "min_rows": 5.0, "sample_rate": 0.7},
    {"learn_rate": 0.05, "min_rows": 5.0, "sample_rate": 1.0},
    {"learn_rate": 0.08, "min_rows": 5.0, "sample_rate": 1.0},
    {"learn_rate": 0.15, "min_rows": 20.0, "sample_rate": 0.7},
    {"learn_rate": 0.15, "min_rows": 5.0, "sample_rate": 1.0})
CAP_GBM_SECS = 0.5
CAP_DL_SECS = 2.0
N_AUTOML = 500_000               # bench.py bench_automl
AUTOML = dict(max_models=20, seed=1, nfolds=3, max_runtime_secs=300)
AUTOML_REPEAT = dict(max_models=4, seed=1, nfolds=3,
                     include_algos=["glm", "gbm", "stackedensemble"])
# (d)-(f) run on the first rows of (c)'s CSV (cut from all 500K for the
# run's time: bit-equality of two runs does not need them, and (d)'s two
# runs took 108-132 s on all of them)
N_AUTOML_HEAD = 100_000
DEEP_STEPS = ("GBM_5", "DRF_1", "XRT_1", "XGBoost_2")   # depth 15 and 20
SE_COEF_TOL = 1e-4               # tests/test_torch_glm.py COEF_TOL
# (e)'s witness of float32 order: the CPU metalearner fit on the level-one
# rows permuted by SE_WITNESS_PERMS seeds; the limit is COEF_TOL or twice
# the largest of them, whichever is larger
SE_WITNESS_PERMS = 5
# (f) a depth-20 GBM (its trees kept as HeapTrees) explained by TreeSHAP:
# min_rows keeps the trees to a few hundred leaves, so the recursion stays
# short; the CPU plain version on the first DEEP_SHAP_CPU rows
DEEP_SHAP = dict(ntrees=2, max_depth=20, min_rows=200.0, seed=1)
DEEP_SHAP_CPU = 2_000
_TREEKERNEL = dict(source="h2o3_tpu_torch/ops/kernels/csrc/treekernel.cu",
                   replaces="h2o3_tpu/ops/pallas/treekernel.py:250")
KERNELS = {
    "tree_hist": _TREEKERNEL, "tree_split": _TREEKERNEL,
    "tree_partition": _TREEKERNEL,
    "histogram": dict(source="h2o3_tpu_torch/ops/kernels/csrc/histogram.cu",
                      replaces="h2o3_tpu/ops/pallas_histogram.py:94"),
    # the per-shard kernels launch tree_hist's and tree_partition's device
    # code (treekernel.cu, hist_slab.cuh) on one rank's rows
    "shard_hist": dict(source="h2o3_tpu_torch/ops/kernels/csrc/treekernel.cu",
                       replaces="h2o3_tpu/ops/pallas/treekernel.py:318"),
    "shard_partition": dict(
        source="h2o3_tpu_torch/ops/kernels/csrc/treekernel.cu",
        replaces="h2o3_tpu/ops/pallas/treekernel.py:351"),
}
LEVEL_KERNELS = ("tree_hist", "tree_split", "tree_partition")
MESH_KERNELS = ("shard_hist", "tree_split", "shard_partition")
W_MESH = 2                       # ranks of the data-parallel path
RANK_TIMEOUT_S = 600.0
L2_FLUSH_BYTES = 128 << 20       # over twice the H100's 50 MB L2
CARD = ""


def say(*parts) -> None:
    print(*parts, f"[{CARD}]", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# later phases' host data (each made from its seed, as in place) is made
# on one background thread while the card runs the earlier phases: numpy
# draws and casts let go of the interpreter lock, so it costs the run
# nothing but a core. A phase takes its data with ``made_ahead``.
_AHEAD = {}


def make_ahead(jobs) -> None:
    """Queue ``(name, maker)`` pairs on one background thread, in order."""
    from concurrent.futures import ThreadPoolExecutor
    ex = ThreadPoolExecutor(1, thread_name_prefix="data")
    for name, fn in jobs:
        _AHEAD[name] = ex.submit(fn)
    ex.shutdown(wait=False)


def made_ahead(name: str, fn):
    """The data ``name`` made ahead, or ``fn()`` made now; the seconds
    this phase waited for it."""
    t0 = time.perf_counter()
    fut = _AHEAD.pop(name, None)
    out = fn() if fut is None else fut.result()
    return out, time.perf_counter() - t0


def drop_ahead() -> None:
    """Cancel what was not made yet (a run that stops early)."""
    for fut in _AHEAD.values():
        fut.cancel()
    _AHEAD.clear()


# ------------------------------------------------------------------ data


def airlines_arrays(n: int, seed: int = 7):
    """The airlines schema and signal of bench.py's CSV generator, as
    int columns plus categorical domains (no CSV file)."""
    r = np.random.RandomState(seed)
    carriers = ["UA", "AA", "DL", "WN", "US", "NW", "CO", "MQ"]
    origins = [f"{a}{b}{c}" for a in "ABCDE" for b in "AEIOU"
               for c in "KLMNP"]
    dep = r.randint(0, 2400, n)
    crs = np.maximum(dep - r.randint(-10, 60, n), 0)
    month = r.randint(1, 13, n)
    car_i = r.randint(0, len(carriers), n)
    delay = (0.03 * (dep - 1000) + np.isin(car_i, [0, 5]) * 15
             + np.isin(month, [12, 1, 6]) * 8 + r.randn(n) * 25)
    cols = {
        "Year": r.randint(1987, 2009, n), "Month": month,
        "DayofMonth": r.randint(1, 29, n), "DayOfWeek": r.randint(1, 8, n),
        "DepTime": dep, "CRSDepTime": crs, "UniqueCarrier": car_i,
        "Origin": r.randint(0, len(origins), n),
        "Dest": r.randint(0, len(origins), n),
        "Distance": r.randint(50, 2600, n),
        "IsDepDelayed": (delay > 15).astype(np.int32),
    }
    domains = {"UniqueCarrier": carriers, "Origin": origins,
               "Dest": origins, "IsDepDelayed": ["NO", "YES"]}
    return cols, domains


def airlines_delay(n: int, seed: int = 7) -> np.ndarray:
    """The departure delay (minutes) behind ``airlines_arrays``'
    IsDepDelayed, from the same draws: IsDepDelayed = delay > 15."""
    r = np.random.RandomState(seed)
    dep = r.randint(0, 2400, n)
    r.randint(-10, 60, n)                    # CRSDepTime's offsets
    month = r.randint(1, 13, n)
    car_i = r.randint(0, 8, n)
    return (0.03 * (dep - 1000) + np.isin(car_i, [0, 5]) * 15
            + np.isin(month, [12, 1, 6]) * 8 + r.randn(n) * 25)


# UCI Forest CoverType (Blackard & Dean 1999, covtype.info): the ten
# quantitative attributes with their published ranges, then 4 one-hot
# Wilderness_Area and 40 one-hot Soil_Type columns; Cover_Type's 7 class
# counts over the 581,012 rows
COVTYPE_RANGES = (
    ("Elevation", 1859, 3858), ("Aspect", 0, 360), ("Slope", 0, 66),
    ("Horizontal_Distance_To_Hydrology", 0, 1397),
    ("Vertical_Distance_To_Hydrology", -173, 601),
    ("Horizontal_Distance_To_Roadways", 0, 7117),
    ("Hillshade_9am", 0, 254), ("Hillshade_Noon", 0, 254),
    ("Hillshade_3pm", 0, 254),
    ("Horizontal_Distance_To_Fire_Points", 0, 7173))
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
N_COVTYPE = sum(COVTYPE_COUNTS)          # 581,012


def covtype_arrays(n: int = N_COVTYPE, seed: int = 5):
    """The Covertype schema and class counts, generated from a seed (no
    download): Cover_Type drawn with the published counts (the first
    ``n`` of a random permutation), integer attributes in their published
    ranges, and a signal on them — a class mean of Elevation, class
    shifts of Slope and the distances, class-dependent Wilderness_Area
    and Soil_Type draws. Returns (int32 columns, domains)."""
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.repeat(np.arange(7, dtype=np.int32),
                                  COVTYPE_COUNTS))[:n]
    k = y.astype(np.float64)
    draw = {
        "Elevation": rng.normal(np.array([3128, 2920, 2394, 2223, 2787,
                                          2419, 3361])[y], 160),
        "Aspect": rng.uniform(0, 360, n),
        "Slope": rng.gamma(2.0, 6.0, n) + 4 * np.isin(y, [2, 5]),
        "Horizontal_Distance_To_Hydrology": rng.exponential(270, n)
        + 40 * k,
        "Vertical_Distance_To_Hydrology": rng.normal(45, 58, n) + 8 * k,
        "Horizontal_Distance_To_Roadways": rng.exponential(2350, n)
        + 900 * (y == 0),
        "Hillshade_9am": rng.normal(212, 27, n),
        "Hillshade_Noon": rng.normal(223, 20, n) - 6 * (y == 2),
        "Hillshade_3pm": rng.normal(142, 38, n),
        "Horizontal_Distance_To_Fire_Points": rng.exponential(1980, n)
        + 700 * np.isin(y, [0, 1]),
    }
    cols = {name: np.clip(np.rint(draw[name]), lo, hi).astype(np.int32)
            for name, lo, hi in COVTYPE_RANGES}
    wild = np.array([[.45, .06, .44, .05], [.52, .03, .38, .07],
                     [0, 0, .1, .9], [0, 0, 0, 1], [.9, 0, .1, 0],
                     [0, 0, .4, .6], [.25, .08, .67, 0]])
    soil = rng.dirichlet(np.full(40, 0.3), 7)
    for name, table in (("Wilderness_Area", wild), ("Soil_Type", soil)):
        cum = np.cumsum(table, axis=1)[y]
        pick = np.minimum((rng.random(n)[:, None] > cum).sum(axis=1),
                          table.shape[1] - 1)
        for j in range(table.shape[1]):
            cols[f"{name}{j + 1}"] = (pick == j).astype(np.int32)
    cols["Cover_Type"] = y
    return cols, {"Cover_Type": [str(c) for c in range(1, 8)]}


def dyadic_stats(n: int, seed: int, torch, device):
    """[n, 3] {w, w·g, w·h} with small-integer g, h: every float32 sum of
    up to 2^22 rows is exact in any order."""
    r = np.random.RandomState(seed)
    w = (r.rand(n) > 0.05).astype(np.float32)
    g = r.randint(-4, 5, n).astype(np.float32)
    h = r.randint(1, 5, n).astype(np.float32)
    return torch.from_numpy(np.stack([w, w * g, w * h], 1)).to(device)


def criteo_arrays(n: int, seed: int = 11):
    """The Criteo Uplift v2.1 schema: 12 float features f0..f11 (no NA),
    a 2-level ``treatment`` (85% treated) and a 2-level response
    ``visit`` (4.7% base rate), with a treatment effect that varies with
    f1 and f9. Generated from a seed; nothing is downloaded."""
    rng = np.random.default_rng(seed)
    f = np.empty((12, n), np.float32)
    f[0:4] = rng.standard_normal((4, n), dtype=np.float32)
    f[4:8] = np.exp(rng.standard_normal((4, n), dtype=np.float32) * 0.75)
    f[8:12] = np.floor(rng.gamma(2.0, 4.0, (4, n))).astype(np.float32)
    treat = rng.random(n, dtype=np.float32) < 0.85
    z = -3.35 + 0.45 * f[0] + 0.25 * np.minimum(f[8], 20) / 8 - 0.2 * f[4]
    z = z + treat * (0.15 + 0.55 * (f[1] > 0.5) - 0.25 * (f[9] > 10))
    visit = rng.random(n, dtype=np.float32) < 1 / (1 + np.exp(-z))
    cols = {f"f{i}": f[i] for i in range(12)}
    cols["treatment"] = treat.astype(np.int32)
    cols["visit"] = visit.astype(np.int32)
    return cols, {"treatment": ["0", "1"], "visit": ["0", "1"]}


def binary_stats(n: int, seed: int, torch, device):
    """[n, 3] {w, w·y, w} with w, y in {0, 1}: uplift's per-arm stats;
    every float32 sum of up to 2^24 rows is exact in any order."""
    r = np.random.RandomState(seed)
    w = (r.rand(n) < 0.6).astype(np.float32)
    y = (r.rand(n) < 0.05).astype(np.float32)
    return torch.from_numpy(np.stack([w, w * y, w], 1)).to(device)


def real_stats(n: int, seed: int, torch, device):
    r = np.random.RandomState(seed)
    g = r.uniform(-1, 1, n).astype(np.float32)
    h = r.uniform(0.05, 0.25, n).astype(np.float32)
    return torch.from_numpy(
        np.stack([np.ones(n, np.float32), g, h], 1)).to(device)


# ------------------------------------------------------------- helpers


def level_plan(bm, torch, device, max_depth: int = 6):
    """Per-level small operands of the flagship fit (no sampling)."""
    from h2o3_tpu_torch.models.tree import TreeParams, scalars_of
    tp = TreeParams(max_depth=max_depth, min_rows=10.0, reg_lambda=0.0,
                    min_split_improvement=1e-5, nbins_total=bm.nbins_total,
                    cat_feats=tuple(bool(v) for v in bm.is_cat))
    sc = scalars_of(tp, device)
    is_cat = torch.tensor(tp.cat_feats, dtype=torch.bool, device=device)
    F = bm.bins.shape[1]
    inf = torch.full((1,), np.inf, dtype=torch.float32, device=device)
    return tp, sc, is_cat, torch.ones(F, dtype=torch.bool, device=device), \
        -inf, inf


def summation_bound(plain, stats):
    """|kernel - plain| allowed per cell for real-valued stats: twice the
    float32 recursive-summation bound n·u·Σ|x| (u = 2^-24) of a cell of n
    rows — both sides sum the same rows in different orders. ``plain``
    maps [N, 3] stats to the plain histogram. Returns (tolerance, Σ|x|
    per cell)."""
    import torch
    mass = plain(stats.abs())
    n = plain(torch.ones_like(stats))
    return 2.0 * n * 2.0 ** -24 * mass, mass


def check_within_bound(got, want, plain, stats, label):
    """Hold ``got`` to ``want`` within the summation bound; returns the
    largest |diff| relative to a cell's absolute mass."""
    tol, mass = summation_bound(plain, stats)
    diff = (got - want).abs()
    check(bool((diff <= tol).all()),
          f"{label} beyond the summation bound: max |diff| "
          f"{float(diff.max())}, max |diff|/bound "
          f"{float((diff / tol.clamp_min(1e-30)).max())}")
    return float((diff / mass.clamp_min(1e-30)).max())


def identical(a, b) -> bool:
    """Equal element for element, NaN equal to NaN."""
    import torch
    return torch.equal(a, b) or (a.dtype.is_floating_point and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))


def compare_level(tk, bins, nid, stats, prev, ops, *, d, L, B, exact):
    """Hold the three kernels against their plain versions at one level.
    Returns (max_abs_err per kernel, split flips, plain outputs)."""
    import torch
    cm, nb, ic, cons, lo, hi, knobs, dl = ops
    Lh = max(L // 2, 1)
    errs = {}
    lh_p = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
    lh_k = tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
    torch.cuda.synchronize()
    errs["tree_hist"] = float((lh_k - lh_p).abs().max())
    if exact:
        check(torch.equal(lh_k, lh_p), f"tree_hist d={d} not exact")
    else:
        errs["tree_hist_rel"] = check_within_bound(
            lh_k, lh_p, lambda s: tk.hist_plain(bins, nid, s, d=d,
                                                n_nodes_h=Lh, n_bins=B),
            stats, f"tree_hist d={d}")
    out_p = tk.split_plain(lh_p, prev, cm, nb, ic, cons, lo, hi, knobs, dl,
                           d=d, n_nodes=L, n_bins=B)
    out_k = tk.tree_split(lh_p, prev, cm, nb, ic, cons, lo, hi, knobs, dl,
                          d=d, n_nodes=L, n_bins=B)
    torch.cuda.synchronize()
    names = ("hist", "gain", "feat", "thresh", "na_left", "left_val",
             "right_val", "leftmask", "split", "cat_split")
    flips = 0
    gk, gp = out_k[1], out_p[1]
    finite = torch.isfinite(gp)
    errs["tree_split"] = float((gk - gp)[finite].abs().max()) \
        if finite.any() else 0.0
    if exact:
        for nm, a, b in zip(names, out_k, out_p):
            check(identical(a, b), f"tree_split d={d} output {nm} not exact")
    else:
        check(torch.equal(out_k[0], out_p[0]), f"tree_split d={d} hist")
        same = (out_k[2] == out_p[2]) & (out_k[3] == out_p[3]) & \
            (out_k[4] == out_p[4])
        flips = int((~same).sum())
        # a flipped decision must be a near-tie: its gain equals the
        # plain best within float32 rounding of the prefix sums
        rel = ((gk - gp).abs() / gp.abs().clamp_min(1.0))[finite]
        errs["tree_split_rel"] = float(rel.max()) if rel.numel() else 0.0
        check(bool((rel <= 1e-3).all()), f"tree_split d={d} gain rtol")
    # partition on the plain decisions, both ways: integer-exact
    dec = (out_p[2], out_p[3], out_p[4], out_p[8], out_p[9], out_p[7])
    new_p = tk.partition_plain(bins, nid, *dec, n_bins=B)
    new_k = tk.tree_partition(bins, nid, *dec, n_bins=B)
    torch.cuda.synchronize()
    errs["tree_partition"] = float((new_k - new_p).abs().max())
    check(torch.equal(new_k, new_p), f"tree_partition d={d} not exact")
    return errs, flips, out_p, new_p


def check_launches(counts, want, path: str) -> None:
    """Every kernel's launches on one path: ``want`` maps a kernel name
    to its expected count; kernels not named must not have launched."""
    for k, v in counts.items():
        check(v == want.get(k, 0), f"{k} launched {v} times on the {path} "
                                   f"path, want {want.get(k, 0)}")


def compare_histogram(bins, nid, stats, *, L, B, exact):
    """Hold the ``histogram`` kernel against its plain version. Returns
    (max |err|, max |err| relative to a cell's absolute mass)."""
    import torch
    from h2o3_tpu_torch.ops.histogram import local_histogram
    from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
    want = local_histogram(bins, nid, stats, n_nodes=L, n_bins=B)
    got = full_histogram(bins, nid, stats, n_nodes=L, n_bins=B)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if exact:
        check(torch.equal(got, want), f"histogram L={L} not exact "
                                      f"(max |err| {err})")
        return err, 0.0
    return err, check_within_bound(
        got, want, lambda s: local_histogram(bins, nid, s, n_nodes=L,
                                             n_bins=B),
        stats, f"histogram L={L}")


def equal_trees(t_a, t_b, label: str) -> None:
    import torch
    from h2o3_tpu_torch.models.tree import Tree
    for f in Tree._fields:
        check(torch.equal(getattr(t_a, f), getattr(t_b, f)),
              f"{label}: field {f} differs kernels vs plain")


def time_ms(torch, fn, reps: int = 10) -> dict:
    """What a call of ``fn`` costs, over ``reps`` calls, three ways.
    ``ms``: the card's time, the median of the calls (``ms_min`` and
    ``ms_max`` give their spread: one slow call, such as the first after
    the profiler, moves a mean but not the median). The calls queue
    behind a sleep kernel that outlasts their host side, each after a
    read of L2_FLUSH_BYTES (its inputs come from device memory, as the
    byte bound assumes, and L2 holds no dirty lines to write back) and
    between its own two events. ``host_paced_ms``: calls back to back
    between two events, as this script first timed kernels; where a
    wrapper takes longer on the host than its kernel on the card, this
    is the wrapper's time, which a fit pays a launch while the card waits
    on the host. ``host_us``: the host's time to make one call."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps + 1)]
    t0 = time.perf_counter()
    ev[reps][0].record()
    for _ in range(reps):
        fn()
    ev[reps][1].record()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: 1.5x the calls' host time (each with a flush
    # and two events) plus 1 ms
    torch.cuda._sleep(int((1.5 * reps * (host_s + 50e-6) + 1e-3) * 2e9))
    for e0, e1 in ev[:reps]:
        flush.sum()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    dev_ms = [e0.elapsed_time(e1) for e0, e1 in ev[:reps]]
    return dict(ms=float(np.median(dev_ms)), ms_min=min(dev_ms),
                ms_max=max(dev_ms),
                host_paced_ms=ev[reps][0].elapsed_time(ev[reps][1]) / reps,
                host_us=host_s * 1e6)


def timing_acc() -> dict:
    """Per-level sums of ``time_ms``'s times (``add_time``), of the plain
    and library times and of the bound's two terms."""
    return dict(ms=0.0, ms_min=float("inf"), ms_max=0.0, host_paced_ms=0.0,
                host_us=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0,
                ops_ms=0.0)


def add_time(a: dict, t: dict) -> None:
    for key in ("ms", "host_paced_ms", "host_us"):
        a[key] += t[key]
    a["ms_min"] = min(a["ms_min"], t["ms_min"])
    a["ms_max"] = max(a["ms_max"], t["ms_max"])


def spread(t: dict) -> str:
    return f"{t['ms']:.6g} ms (calls {t['ms_min']:.6g}..{t['ms_max']:.6g})"


# --------------------------------------------------------------- phases


def phase_toolchain(torch):
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    CARD = smi
    print(smi, flush=True)
    from h2o3_tpu_torch.ops import kernels
    nv = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | nvcc: {nv[-1]} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from concurrent.futures import ThreadPoolExecutor
    from h2o3_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        tokenizer = pool.submit(native.build)   # g++, beside the nvccs
        logs = kernels.build()
        tokenizer.result()
    say(f"kernels and the CSV tokenizer built in "
        f"{time.perf_counter() - t0:.3f} s ({', '.join(kernels.sources())}, "
        f"{native.SRC.name})")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "Compiling entry" in ln or \
                    "bytes stack" in ln:
                print(f"  ptxas[{name}] {ln.strip()}", flush=True)


def phase_kernels(torch, dev, bm):
    """Phase 2 at the flagship width; returns max |err| per kernel."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    B = bm.nbins_total
    bins = bm.bins[:N_KERNEL].contiguous()
    check(bins.dtype == torch.int8 and B == 126 and bins.shape[1] == 10,
          f"flagship bins int8 B=126 F=10, got {bins.dtype} {B} "
          f"{tuple(bins.shape)}")
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    worst = {"tree_hist": 0.0, "tree_split": 0.0, "tree_partition": 0.0}
    for label, stats, exact in (
            ("dyadic", dyadic_stats(N_KERNEL, 3, torch, dev), True),
            ("real", real_stats(N_KERNEL, 4, torch, dev), False)):
        nid = torch.zeros(N_KERNEL, dtype=torch.int32, device=dev)
        prev = None
        total_flips = 0
        perm = torch.from_numpy(np.random.RandomState(12).permutation(
            N_KERNEL)).to(dev)
        for d in range(6):
            if not exact:
                # fixed point: the rows in another order, the same bits
                Lh = max(2 ** d // 2, 1)
                lh = tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=Lh,
                                  n_bins=B)
                lh_perm = tk.tree_hist(
                    bins[perm].contiguous(), nid[perm].contiguous(),
                    stats[perm].contiguous(), d=d, n_nodes_h=Lh, n_bins=B)
                torch.cuda.synchronize()
                check(torch.equal(lh, lh_perm), f"tree_hist d={d}: rows "
                      "permuted give other bits with real-valued stats")
            errs, flips, out_p, nid_next = compare_level(
                tk, bins, nid, stats, prev, ops, d=d, L=2 ** d, B=B,
                exact=exact)
            total_flips += flips
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            prev, nid = out_p[0], nid_next
            say(f"phase2 {label} d={d}: max|err| " + " ".join(
                f"{k}={v:.3g}" for k, v in errs.items()) +
                (f" split flips={flips}" if not exact else " exact"))
        if not exact:
            say(f"phase2 real-valued stats: {total_flips} split decision(s) "
                "differ from the plain version, each at a near-tie "
                "(gain within 1e-3 of max(|gain|, 1)); tree_hist on the "
                "rows permuted bit-identical at d=0..5")
    # depth bucket 10: Lh = 256 parents, the slab in node chunks
    r = np.random.RandomState(5)
    nid = torch.from_numpy(r.randint(0, 512, N_KERNEL).astype(np.int32)).to(dev)
    stats = dyadic_stats(N_KERNEL, 6, torch, dev)
    prev = tk.hist_plain(bins, nid >> 1, stats, d=0, n_nodes_h=256, n_bins=B)
    errs, _, _, _ = compare_level(tk, bins, nid, stats, prev, ops, d=9,
                                  L=512, B=B, exact=True)
    say("phase2 Lh=256 (d=9) exact: " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    deep_levels(torch, dev, bm, bins, B)
    # int32 bins at B = 200
    B2, F2 = 200, 10
    bins32 = torch.from_numpy(r.randint(0, B2, (N_KERNEL, F2)).astype(
        np.int32)).to(dev)
    nb2 = torch.full((F2,), B2 - 1, dtype=torch.int32, device=dev)
    ic2 = torch.tensor([i % 3 == 0 for i in range(F2)], device=dev)
    ops2 = tk.level_operands(torch.ones(F2, dtype=torch.bool, device=dev),
                             nb2, ic2, None, lo, hi, sc, dev)
    nid = torch.from_numpy(r.randint(0, 4, N_KERNEL).astype(np.int32)).to(dev)
    prev = tk.hist_plain(bins32, nid >> 1, stats, d=0, n_nodes_h=2,
                         n_bins=B2)
    errs, _, _, _ = compare_level(tk, bins32, nid, stats, prev, ops2, d=2,
                                  L=4, B=B2, exact=True)
    say("phase2 int32 bins B=200 (d=2) exact: " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    return worst


def deep_levels(torch, dev, bm, bins, B):
    """Phase 2's deep levels (a depth-20 tree's, as AutoML's DRF, XRT and
    XGBoost steps grow them): at d = 15 (L = 32,768: the global-atomic
    histogram of 16,384 parents, the 32,768 nodes' records read from
    global memory) the whole level EXACT with dyadic stats; at d = 19
    (L = 524,288, 262,144 parents) ``tree_hist`` and ``tree_partition``
    (random decisions, categorical ones among them) EXACT."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev, max_depth=20)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    r = np.random.RandomState(8)
    n = bins.shape[0]
    stats = dyadic_stats(n, 9, torch, dev)
    L = 2 ** 15
    nid = torch.from_numpy(r.randint(0, L, n).astype(np.int32)).to(dev)
    prev = tk.hist_plain(bins, nid >> 1, stats, d=0, n_nodes_h=L // 2,
                         n_bins=B)
    errs, _, out_p, _ = compare_level(tk, bins, nid, stats, prev, ops, d=15,
                                      L=L, B=B, exact=True)
    n_split = int(out_p[8].sum())
    del prev, out_p
    L = 2 ** 19
    nid = torch.from_numpy(r.randint(0, L, n).astype(np.int32)).to(dev)
    lh_p = tk.hist_plain(bins, nid, stats, d=19, n_nodes_h=L // 2, n_bins=B)
    lh_k = tk.tree_hist(bins, nid, stats, d=19, n_nodes_h=L // 2, n_bins=B)
    torch.cuda.synchronize()
    check(torch.equal(lh_k, lh_p), "tree_hist d=19 not exact")
    del lh_p, lh_k
    F = bins.shape[1]
    feat = torch.from_numpy(r.randint(0, F, L).astype(np.int32)).to(dev)
    split = torch.from_numpy(r.rand(L) < 0.7).to(dev)
    dec = (feat,
           torch.from_numpy(r.randint(0, B - 1, L).astype(np.int32)).to(dev),
           torch.from_numpy(r.rand(L) < 0.5).to(dev), split,
           split & is_cat[feat.long()],
           torch.from_numpy(r.rand(L, B - 1) < 0.5).to(dev))
    new_p = tk.partition_plain(bins, nid, *dec, n_bins=B)
    new_k = tk.tree_partition(bins, nid, *dec, n_bins=B)
    torch.cuda.synchronize()
    check(torch.equal(new_k, new_p), "tree_partition d=19 not exact")
    say("phase2 deep levels exact: d=15 (L=32768, the global-atomic "
        "tree_hist, tree_partition's records in global memory; "
        f"{n_split} nodes split) " + " ".join(
            f"{k}={v:.3g}" for k, v in errs.items())
        + "; d=19 (L=524288) tree_hist and tree_partition")
    del new_p, new_k
    # what a depth-20 tree's last level costs (the dense layout: PERF.md
    # section 7), each beside its byte bound
    Lh, cell = L // 2, F * B * 3 * 4
    lh = tk.tree_hist(bins, nid, stats, d=19, n_nodes_h=Lh, n_bins=B)
    prev = lh.clone()
    row_bytes = n * (bins.shape[1] * bins.element_size() + 4 + 12)
    times = {
        "tree_hist": (time_ms(torch, lambda: tk.tree_hist(
            bins, nid, stats, d=19, n_nodes_h=Lh, n_bins=B), reps=5),
            row_bytes + Lh * cell),
        "tree_split": (time_ms(torch, lambda: tk.tree_split(
            lh, prev, *ops, d=19, n_nodes=L, n_bins=B), reps=5),
            2 * Lh * cell + L * cell + L * (B - 1)),
        "tree_partition": (time_ms(torch, lambda: tk.tree_partition(
            bins, nid, *dec, n_bins=B), reps=5), n * 9 + L * 11)}
    say("phase2 a depth-20 tree's last level (d=19, L=524288, "
        f"{n} rows): " + "; ".join(
            f"{k} {t['ms']:.4g} ms (host-paced {t['host_paced_ms']:.4g}), "
            f"bound {b / HBM_BYTES_PER_S * 1e3:.4g} ms (bytes)"
            for k, (t, b) in times.items()))


def phase_grow_tree(torch, dev, bm):
    from h2o3_tpu_torch.models.tree import grow_tree
    from h2o3_tpu_torch.ops.kernels.treekernel import plain_level
    tp, sc, _, cm, _, _ = level_plan(bm, torch, dev)
    st = dyadic_stats(N_KERNEL, 8, torch, dev)
    w = st[:, 0].contiguous()
    g = (st[:, 1] / torch.where(w > 0, w, 1.0)).contiguous()
    h = (st[:, 2] / torch.where(w > 0, w, 1.0)).contiguous()
    bins = bm.bins[:N_KERNEL].contiguous()
    t_k, nid_k, gain_k = grow_tree(bins, bm.nbins, w, g, h, cm, params=tp,
                                   scalars=sc)
    t_p, nid_p, gain_p = grow_tree(bins, bm.nbins, w, g, h, cm, params=tp,
                                   scalars=sc, level_fn=plain_level)
    torch.cuda.synchronize()
    equal_trees(t_k, t_p, "grow_tree")
    check(torch.equal(nid_k, nid_p), "grow_tree leaf ids differ")
    check(torch.equal(gain_k, gain_p), "grow_tree gains differ")
    say(f"phase3 grow_tree depth {tp.max_depth}: kernels == plain, field "
        f"for field ({int(t_k.is_split.sum())} splits, "
        f"{int(t_k.cat_split.sum())} categorical)")


def phase_main(torch, dev, cols, domains):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    model = h2o.GBMEstimator(**FLAGSHIP).train(fr, y="IsDepDelayed")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t1 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t1
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    check_launches(counts, {k: want for k in LEVEL_KERNELS}, "GBM")
    tm = model.training_metrics
    p1 = pred.col("p1").host_view()
    check(p1.shape == (N_MAIN,) and np.isfinite(p1).all()
          and (p1 > 0).all() and (p1 < 1).all(), "p1 finite in (0, 1)")
    check(np.array_equal(pred.col("predict").host_view(),
                         (p1 >= model.output["default_threshold"])),
          "predict label = p1 >= threshold")
    check(np.isfinite(tm["AUC"]) and tm["AUC"] > 0.7,
          f"training AUC {tm['AUC']}")
    perf = model.model_performance(fr)
    check(abs(perf["AUC"] - tm["AUC"]) < 1e-9 and
          abs(perf["logloss"] - tm["logloss"]) < 1e-9,
          "model_performance on the training frame = training metrics")
    say(f"phase4 main path: GBM ntrees={FLAGSHIP['ntrees']} max_depth="
        f"{FLAGSHIP['max_depth']} on {N_MAIN} rows: train {t_train:.3f} s, "
        f"{N_MAIN * FLAGSHIP['ntrees'] / t_train:.6g} rows*trees/s, "
        f"predict {t_pred:.3f} s, AUC {tm['AUC']:.6f}, logloss "
        f"{tm['logloss']:.6f}, peak device memory {peak / 2**30:.3f} GiB")
    say(f"phase4 launches: {counts}")
    # the output against the CPU plain path on a small sample
    small = {k: v[:50_000] for k, v in cols.items()}
    m_gpu = h2o.GBMEstimator(**FLAGSHIP).train(
        h2o.Frame.from_numpy(small, domains=domains, device=dev),
        y="IsDepDelayed")
    m_cpu = h2o.GBMEstimator(**FLAGSHIP).train(
        h2o.Frame.from_numpy(small, domains=domains, device="cpu"),
        y="IsDepDelayed")
    d_auc = abs(m_gpu.training_metrics["AUC"] - m_cpu.training_metrics["AUC"])
    d_ll = abs(m_gpu.training_metrics["logloss"]
               - m_cpu.training_metrics["logloss"])
    agree = float((m_gpu.forest.feat.cpu() == m_cpu.forest.feat).float()
                  .mean())
    check(d_auc < 5e-3 and d_ll < 5e-3,
          f"50K-row fit card vs CPU: dAUC {d_auc} dlogloss {d_ll}")
    say(f"phase4 50K-row fit card vs CPU plain: |dAUC| {d_auc:.3g} "
        f"|dlogloss| {d_ll:.3g}, split features equal at {agree:.4f} of "
        "slots")
    return model, fr, counts, t_train


def profiled_fit(torch, label: str, fit):
    """Run ``fit()`` under torch.profiler: device time by kernel, host
    time by op, and the device's busy share of the fit's wall time (the
    profiler stretches the wall time, so the share is a floor). Returns
    the profiler's ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in ev) / 1e3
    say(f"{label}: fit under the profiler {wall:.1f} ms wall, "
        f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
    for e in sorted(ev, key=dev_us, reverse=True)[:10]:
        if dev_us(e) > 0:
            say(f"  device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                f"{e.key[:90]}")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        say(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return ev


def phase_profile(torch, dev, fr):
    """Where the main path's time goes: the binning pass alone, then a
    1-tree fit under torch.profiler (cut from the main path's 10 trees,
    as phase 8's, when phase 27(c) took its fixed 300 s budget: the
    profiler stretches a fit's host time tenfold)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    x = [c for c in fr.names if c != "IsDepDelayed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bin_frame(fr, x, nbins=64, nbins_cats=1024,
              weights=np.ones(fr.nrows, np.float32))
    torch.cuda.synchronize()
    say(f"phase4 profile: bin_frame alone {time.perf_counter() - t0:.3f} s")
    profiled_fit(torch, "phase4 profile (ntrees=1)", lambda: h2o.
                 GBMEstimator(**dict(FLAGSHIP, ntrees=1)).train(
                     fr, y="IsDepDelayed"))


def _hist_bytes(N, F, Lh, B, bin_bytes):
    return N * (F * bin_bytes + 4 + 12) + Lh * F * B * 12


# what each level kernel computes: the shard variants run the same device
# code as their one-card kernels, on one rank's rows
ROLE = {"tree_hist": "hist", "shard_hist": "hist", "tree_split": "split",
        "tree_partition": "partition", "shard_partition": "partition"}


def level_chain(torch, bm, n_rows, depth, mtries=None):
    """The plain level chain on the first ``n_rows`` rows of ``bm``
    (dyadic stats, node ids from d=0, the flagship's parameters; with
    ``mtries``, DRF's per-node [L, F] masks of that many columns at every
    level). Yields per level d < depth a dict of the level's inputs
    (bins, stats, nid, prev, ops, lh: the plain histogram) and the plain
    outputs (out: ``split_plain``'s, dec: the routing decisions, new:
    ``partition_plain``'s ids)."""
    from h2o3_tpu_torch.models.tree import _mtries_mask
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    dev = bm.bins.device
    bins = bm.bins[:n_rows].contiguous()
    N, F = bins.shape
    B = bm.nbins_total
    _, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev,
                                           max_depth=max(6, depth))
    gen = torch.Generator(device=dev).manual_seed(1)
    stats = dyadic_stats(N, 9, torch, dev)
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    prev = None
    for d in range(depth):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        ops = tk.level_operands(
            cm if mtries is None else _mtries_mask(gen, L, F, mtries, dev),
            bm.nbins, is_cat, None, lo, hi, sc, dev)
        lh = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        out = tk.split_plain(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        new = tk.partition_plain(bins, nid, *dec, n_bins=B)
        yield dict(d=d, L=L, Lh=Lh, B=B, bins=bins, stats=stats, nid=nid,
                   prev=prev, ops=ops, is_cat=is_cat, lh=lh, out=out,
                   dec=dec, new=new)
        prev, nid = out[0], new


def level_timing(torch, dev, bm, names, n_rows, depths=range(6),
                 mtries=None):
    """Per-kernel sums over the levels ``depths`` of ``level_chain``'s
    chain on the first ``n_rows`` rows of ``bm``: ms per launch, plain
    ms, library ms and the bound's two terms. Each kernel's output at
    each timed level must equal its plain version's EXACTLY."""
    from h2o3_tpu_torch.ops.fixed_point import exponents
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    acc = {k: timing_acc() for k in names}
    for lev in level_chain(torch, bm, n_rows, depths[-1] + 1, mtries):
        if lev["d"] not in depths:
            continue
        d, L, Lh, B = lev["d"], lev["L"], lev["Lh"], lev["B"]
        bins, stats, nid, prev = (lev["bins"], lev["stats"], lev["nid"],
                                  lev["prev"])
        ops, lh, out, dec, new_p = (lev["ops"], lev["lh"], lev["out"],
                                    lev["dec"], lev["new"])
        N, F = bins.shape
        n = nid.long()
        cell = (n[:, None] * F + torch.arange(F, device=dev)) * B \
            + bins.long()
        if d > 0:
            cell = torch.where((n % 2 == 0)[:, None],
                               ((n >> 1)[:, None] * F
                                + torch.arange(F, device=dev)) * B
                               + bins.long(), Lh * F * B)
        cell = cell.reshape(-1)
        src = stats[:, None, :].expand(N, F, 3).reshape(N * F, 3)
        slots = Lh * F * B + 1
        # the stats' fixed-point exponents, once a tree as a fit has them
        exps = exponents(stats)
        runs = {
            "hist": (
                lambda k: getattr(tk, k)(bins, nid, stats, d=d,
                                         n_nodes_h=Lh, n_bins=B, exps=exps),
                lambda: tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh,
                                      n_bins=B),
                lambda: torch.zeros((slots, 3), device=dev).index_add_(
                    0, cell, src), (lh,)),
            "split": (
                lambda k: tk.tree_split(lh, prev, *ops, d=d, n_nodes=L,
                                        n_bins=B),
                lambda: tk.split_plain(lh, prev, *ops, d=d, n_nodes=L,
                                       n_bins=B),
                None, out),
            "partition": (
                lambda k: getattr(tk, k)(bins, nid, *dec, n_bins=B),
                lambda: tk.partition_plain(bins, nid, *dec, n_bins=B),
                None, (new_p,)),
        }
        # (node, feature) pairs the column masks keep, and the
        # categorical ones among them (sorted by a comparison sort)
        keep = ops[0].bool().expand(L, F)
        kept, kept_cat = int(keep.sum()), int((keep & lev["is_cat"]).sum())
        bound_bytes = {
            "hist": _hist_bytes(N, F, Lh, B, bins.element_size()),
            "split": (Lh * F * B * 12 * (2 if d else 1)
                      + L * F * B * 12 + L * (B - 1) + L * 26),
            "partition": N * (F * bins.element_size() + 4 + 4)
            + L * (B + 12),
        }
        bound_ops = {
            "hist": 3 * N * F,
            # per kept (node, feature, threshold, direction) ~20 flops,
            # plus (B-1)·log2(B-1) compares per kept categorical pair
            "split": kept * (B - 1) * 2 * 20
            + kept_cat * (B - 1) * int(np.ceil(np.log2(B - 1))),
            "partition": 4 * N,
        }
        for k in names:
            kern, plain, lib, want = runs[ROLE[k]]
            got = kern(k)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            check(all(identical(a, b) for a, b in zip(got, want)),
                  f"{k} d={d} != its plain version")
            a = acc[k]
            t = time_ms(torch, lambda: kern(k))
            say(f"  {k} d={d} ({N} rows, L={L}): {spread(t)}, "
                f"host-paced {t['host_paced_ms']:.6g} ms, host "
                f"{t['host_us']:.4g} us a call, exact")
            add_time(a, t)
            a["plain_ms"] += time_ms(torch, plain, reps=3)["ms"]
            if lib is not None:
                a["library_ms"] += time_ms(torch, lib, reps=3)["ms"]
            a["bytes_ms"] += bound_bytes[ROLE[k]] / HBM_BYTES_PER_S * 1e3
            a["ops_ms"] += bound_ops[ROLE[k]] / F32_OPS_PER_S * 1e3
        del cell, src
    return acc


def split_floor_case(torch, dev, bm):
    """``tree_split`` at its smallest level (L = 1, F = 1, B = 3): (a
    call of the kernel, the plain version's outputs)."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    _, sc, _, _, lo, hi = level_plan(bm, torch, dev)
    lh = torch.tensor([[[[4.0, -4.0, 4.0], [4.0, 8.0, 4.0],
                         [0.0, 0.0, 0.0]]]], device=dev)
    ops = tk.level_operands(torch.ones(1, dtype=torch.bool, device=dev),
                            torch.full((1,), 2, dtype=torch.int32), None,
                            None, lo, hi, sc, dev)
    return (lambda: tk.tree_split(lh, None, *ops, d=0, n_nodes=1, n_bins=3),
            tk.split_plain(lh, None, *ops, d=0, n_nodes=1, n_bins=3))


def split_floor_ms(torch, dev, bm) -> dict:
    """What a ``tree_split`` launch costs with next to no work
    (``time_ms``'s three times), checked EXACT against the plain version
    first."""
    fn, want = split_floor_case(torch, dev, bm)
    got = fn()
    torch.cuda.synchronize()
    check(all(identical(a, b) for a, b in zip(got, want)),
          "tree_split L=1 F=1 B=3 != its plain version")
    return time_ms(torch, fn, reps=50)


def timing_records(acc, counts, n_rows, label, path, depths=range(6)):
    records = []
    for k, a in acc.items():
        rec = kernel_record(k, counts[k], a, len(depths), path=path,
                            levels=f"d={depths[0]}..{depths[-1]}",
                            has_library=ROLE[k] == "hist")
        records.append(rec)
        say(f"{label} {k}: {rec['ms']:.6g} ms per launch (mean of the "
            f"medians of {rec['levels']} at {n_rows} rows, calls "
            f"{rec['ms_min']:.6g}..{rec['ms_max']:.6g}; host-paced "
            f"{rec['host_paced_ms']:.6g} ms, host {rec['host_us']:.4g} us a "
            f"call), plain {rec['plain_ms']:.6g} ms, bound "
            f"{rec['bound_ms']:.6g} ms ({rec['bound_by']}), library "
            f"{rec['library_ms']}")
    return records


def phase_timing(torch, dev, model, counts):
    """Kernel times at the main path's shapes, averaged over d=0..5; then
    ``tree_hist``, ``tree_split`` and ``tree_partition`` over the DRF
    path's deeper levels d=6..9 (L = 64..512) of the same rows, with
    DRF's per-node mtries masks (sqrt(F) columns a node); and
    ``tree_split``'s floor. The DRF records' launches are set once phase
    6 has counted them."""
    n = model.bm.bins.shape[0]
    records = timing_records(level_timing(torch, dev, model.bm,
                                          LEVEL_KERNELS, n),
                             counts, n, "phase5", "gbm")
    mtries = max(1, int(np.sqrt(model.bm.bins.shape[1])))
    records += timing_records(
        level_timing(torch, dev, model.bm, LEVEL_KERNELS, n, DRF_DEPTHS,
                     mtries=mtries),
        {k: None for k in LEVEL_KERNELS}, n, "phase5 DRF depths", "drf",
        DRF_DEPTHS)
    leaf_sum_timing(torch, dev, model.bm, n)
    floor = split_floor_ms(torch, dev, model.bm)
    say(f"phase5 tree_split floor (L=1, F=1, B=3): {spread(floor)}, "
        f"host-paced {floor['host_paced_ms']:.6g} ms, host "
        f"{floor['host_us']:.4g} us a call")
    for rec in records:
        if rec["name"] == "tree_split":
            rec["floor_ms"] = floor["ms"]
    return records


def leaf_sum_timing(torch, dev, bm, n_rows):
    """The leaf sums a tree ends with (``segment_sum`` into the 64 leaves
    of the level chain's last routing, fixed point), held EXACT against a
    float64 sum of its dyadic stats, and timed beside the float
    ``index_add_`` it replaced (its adds' order varies on the card) and
    beside the first fixed-point design: an int64 ``index_add_`` and a
    float one for the non-finite values, both into the 64 cells."""
    from h2o3_tpu_torch.ops import fixed_point as fp
    from h2o3_tpu_torch.ops.segments import segment_sum
    for lev in level_chain(torch, bm, n_rows, 6):
        pass
    nid, stats = lev["new"], lev["stats"]
    idx, n = nid.long(), 2 * lev["L"]
    exps = fp.exponents(stats)
    want = torch.zeros((n, 3), dtype=torch.float64, device=dev).index_add_(
        0, idx, stats.double()).float()
    got = segment_sum(nid, stats, n_nodes=n, e=exps)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "leaf sums != the exact sums")

    def two_passes():
        acc = torch.zeros((n, 3), dtype=torch.int64, device=dev)
        acc.index_add_(0, idx, fp.quantize(stats, exps))
        side = torch.zeros((n, 3), device=dev)
        side.index_add_(0, idx, torch.where(torch.isfinite(stats), 0,
                                            stats))
        return torch.where(side == 0, fp.dequantize(acc, exps,
                                                    torch.float32), side)
    t = {k: time_ms(torch, f)["ms"] for k, f in (
        ("fixed", lambda: segment_sum(nid, stats, n_nodes=n, e=exps)),
        ("float", lambda: torch.zeros((n, 3), device=dev).index_add_(
            0, idx, stats)),
        ("two", two_passes))}
    say(f"phase5 leaf sums ({n_rows} rows into {n} leaves, EXACT): "
        f"segment_sum {t['fixed']:.6g} ms; the float index_add_ it "
        f"replaced {t['float']:.6g} ms; the int64 and float index_add_ "
        f"pair of the first fixed-point design {t['two']:.6g} ms")


def kernel_record(name, launches, a, n_levels, *, path, levels,
                  has_library):
    """One entry of the ``{"kernels": [...]}`` line from per-level sums
    of measured times and of the bound's two terms."""
    return {"name": name, "route": "cuda", **KERNELS[name], "path": path,
            "levels": levels, "launches": launches,
            "ms": a["ms"] / n_levels,
            "ms_min": a["ms_min"], "ms_max": a["ms_max"],
            "host_paced_ms": a["host_paced_ms"] / n_levels,
            "host_us": a["host_us"] / n_levels,
            "plain_ms": a["plain_ms"] / n_levels,
            "bound_ms": max(a["bytes_ms"], a["ops_ms"]) / n_levels,
            "bound_by": "bytes" if a["bytes_ms"] >= a["ops_ms"]
            else "operations",
            "library_ms": a["library_ms"] / n_levels if has_library
            else None}


def phase_drf_grow_tree(torch, dev, bm):
    """One DRF-style ``grow_tree`` (per-node mtries masks drawn from a
    generator) through the kernels and through the plain versions, both
    from the same generator state: equal Trees."""
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.models.tree import TreeParams, grow_tree, scalars_of
    from h2o3_tpu_torch.ops.kernels.treekernel import plain_level
    F = bm.bins.shape[1]
    tp = TreeParams(max_depth=DRF["max_depth"], min_rows=1.0,
                    reg_lambda=0.0, min_split_improvement=1e-5,
                    nbins_total=bm.nbins_total,
                    cat_feats=tuple(bool(v) for v in bm.is_cat))
    sc = scalars_of(tp, dev)
    st = dyadic_stats(N_KERNEL, 10, torch, dev)
    w = st[:, 0].contiguous()
    g = (st[:, 1] / torch.where(w > 0, w, 1.0)).contiguous()
    h = (st[:, 2] / torch.where(w > 0, w, 1.0)).contiguous()
    bins = bm.bins[:N_KERNEL].contiguous()
    cm = torch.ones(F, dtype=torch.bool, device=dev)
    mtries = max(1, int(np.sqrt(F)))
    out = [grow_tree(bins, bm.nbins, w, g, h, cm, params=tp, scalars=sc,
                     mtries=mtries, generator=tree_generator(1, 0, dev),
                     **kw)
           for kw in ({}, {"level_fn": plain_level})]
    torch.cuda.synchronize()
    (t_k, nid_k, _), (t_p, nid_p, _) = out
    equal_trees(t_k, t_p, "grow_tree with mtries")
    check(torch.equal(nid_k, nid_p), "grow_tree with mtries: leaf ids")
    say(f"phase6 grow_tree depth {tp.max_depth}, mtries {mtries} of {F} per "
        f"node ([L, F] column masks): kernels == plain, field for field "
        f"({int(t_k.is_split.sum())} splits)")


def phase_drf(torch, dev, fr):
    """The DRF path on phase 4's 5M-row airlines frame."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    model = h2o.DRFEstimator(**DRF).train(fr, y="IsDepDelayed")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # depth 10 is a depth bucket of its own: 10 levels a tree
    want = DRF["ntrees"] * DRF["max_depth"]
    check(model.forest.feat.shape[1] == DRF["max_depth"],
          f"DRF laid out at depth {model.forest.feat.shape[1]}")
    check_launches(counts, {k: want for k in LEVEL_KERNELS}, "DRF")
    tm = model.training_metrics
    check(np.isfinite(tm["AUC"]) and tm["AUC"] > 0.7,
          f"DRF OOB AUC {tm['AUC']}")
    p1 = model.predict(fr).col("p1").host_view()
    check(p1.shape == (N_MAIN,) and np.isfinite(p1).all()
          and (p1 >= 0).all() and (p1 <= 1).all(), "DRF p1 in [0, 1]")
    say(f"phase6 DRF ntrees={DRF['ntrees']} max_depth={DRF['max_depth']} "
        f"(mtries sqrt(F) per node, sample_rate 0.632) on {N_MAIN} rows: "
        f"train {t_train:.3f} s, "
        f"{N_MAIN * DRF['ntrees'] / t_train:.6g} rows*trees/s, OOB AUC "
        f"{tm['AUC']:.6f} (nobs {tm.nobs}), OOB logloss "
        f"{tm['logloss']:.6f}, peak device memory {peak / 2**30:.3f} GiB")
    say(f"phase6 launches: {counts}")
    return counts, model


def uplift_inputs(torch, dev, cols, domains, n):
    """The first ``n`` uplift rows on ``dev``: (binned features, response,
    treatment), the last two as float32 0/1."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    fr = h2o.Frame.from_numpy({k: v[:n] for k, v in cols.items()},
                              domains=domains, device=dev)
    bm = bin_frame(fr, [f"f{i}" for i in range(12)], nbins=64,
                   nbins_cats=64)
    y = fr.col("visit").data.to(torch.float32)
    t = fr.col("treatment").data.to(torch.float32)
    return bm, y, t


def phase_hist_kernel(torch, dev, cols, domains):
    """Phase 7: ``histogram`` vs its plain version at the uplift width;
    returns the largest |err|."""
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.models.uplift import _grow_uplift_tree
    from h2o3_tpu_torch.ops.histogram import plain_histogram
    bm, y, treat = uplift_inputs(torch, dev, cols, domains, N_KERNEL)
    bins, B = bm.bins, bm.nbins_total
    N, F = bins.shape
    check(bins.dtype == torch.int8 and B == 65 and F == 12,
          f"uplift bins int8 B=65 F=12, got {bins.dtype} {B} {F}")
    r = np.random.RandomState(12)
    worst = 0.0

    def ids(L):
        nid = r.randint(0, L, N).astype(np.int32)
        nid[::97] = L                 # outside the histogram: skipped
        return torch.from_numpy(nid).to(dev)

    st01 = binary_stats(N, 13, torch, dev)
    for L in (1, 8, 64, 512):
        err, _ = compare_histogram(bins, ids(L), st01, L=L, B=B, exact=True)
        worst = max(worst, err)
        say(f"phase7 histogram 0/1 stats L={L}: exact")
    compare_histogram(bins.to(torch.int32).contiguous(), ids(64), st01, L=64,
                      B=B, exact=True)
    say("phase7 histogram int32 bins L=64: exact")
    st = real_stats(N, 14, torch, dev)
    for L in (1, 64, 512):
        err, rel = compare_histogram(bins, ids(L), st, L=L, B=B, exact=False)
        worst = max(worst, err)
        say(f"phase7 histogram real-valued stats L={L}: max|err| {err:.3g}, "
            f"max |err|/cell mass {rel:.3g} (within the summation bound)")
    # one uplift tree through the kernel and through the plain version
    gen = tree_generator(1, 0, dev)
    w = (torch.rand(N, generator=gen, device=dev) < 0.632).to(torch.float32)
    kw = dict(depth=UPLIFT["max_depth"], B=B, mtries=F, metric="kl",
              min_rows=10.0)
    t_k, pt_k, pc_k = _grow_uplift_tree(bins, bm.nbins, w, y, treat, None,
                                        **kw)
    t_p, pt_p, pc_p = _grow_uplift_tree(bins, bm.nbins, w, y, treat, None,
                                        hist_fn=plain_histogram, **kw)
    torch.cuda.synchronize()
    equal_trees(t_k, t_p, "_grow_uplift_tree")
    check(torch.equal(pt_k, pt_p) and torch.equal(pc_k, pc_p),
          "_grow_uplift_tree leaf rates differ")
    say(f"phase7 _grow_uplift_tree depth {kw['depth']}: kernel == plain, "
        f"field for field ({int(t_k.is_split.sum())} splits)")
    return worst


def phase_uplift(torch, dev, cols, domains):
    """Phase 8: the uplift main path at the Criteo v2.1 size."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    model = h2o.UpliftDRFEstimator(**UPLIFT).train(fr, y="visit")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check_launches(counts, {"histogram": 2 * UPLIFT["ntrees"]
                            * UPLIFT["max_depth"]}, "uplift")
    t1 = time.perf_counter()
    raw = model._score_raw(fr)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    up, pt = raw["uplift_predict"], raw["p_y1_ct1"]
    check(up.shape == (N_UPLIFT,) and np.isfinite(up).all()
          and (np.abs(up) <= 1).all() and (pt > 0).all() and (pt < 1).all(),
          "uplift predictions finite, rates in (0, 1)")
    tm = model.training_metrics
    check(np.isfinite(tm["auuc"]) and np.isfinite(tm["qini"])
          and tm["qini"] > 0, f"uplift AUUC {tm['auuc']} Qini {tm['qini']}")
    check(tm.nobs == N_UPLIFT, f"uplift nobs {tm.nobs}")
    say(f"phase8 uplift main path: UpliftDRF ntrees={UPLIFT['ntrees']} "
        f"max_depth={UPLIFT['max_depth']} on {N_UPLIFT} rows x 12 features: "
        f"train {t_train:.3f} s (training metrics included), "
        f"{N_UPLIFT * UPLIFT['ntrees'] / t_train:.6g} rows*trees/s, score "
        f"{t_score:.3f} s, AUUC {tm['auuc']:.6f}, Qini {tm['qini']:.6f}, "
        f"peak device memory {peak / 2**30:.3f} GiB")
    say(f"phase8 launches: {counts}")
    # where the time goes: binning alone, the training metrics alone (the
    # scoring walks and the host AUUC), and a 2-tree fit under the profiler
    from h2o3_tpu_torch.frame.binning import bin_frame
    t0 = time.perf_counter()
    bin_frame(fr, [f"f{i}" for i in range(12)], nbins=64, nbins_cats=64,
              weights=np.ones(fr.nrows, np.float32))
    torch.cuda.synchronize()
    t_bin = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.model_performance(fr)
    say(f"phase8 breakdown: bin_frame alone {t_bin:.3f} s, training "
        f"metrics alone {time.perf_counter() - t0:.3f} s")
    # one tree under the profiler (cut from 2 when phase 27 came, for the
    # run's time)
    profiled_fit(torch, "phase8 profile (ntrees=1)", lambda: h2o.
                 UpliftDRFEstimator(**dict(UPLIFT, ntrees=1)).train(
                     fr, y="visit"))
    # the fit against the CPU plain path on a sample, without bagging: the
    # card's and the CPU's generators draw different bags
    kw = dict(UPLIFT, sample_rate=1.0)
    small = {k: v[:N_SAMPLE] for k, v in cols.items()}
    fits = [h2o.UpliftDRFEstimator(**kw).train(
        h2o.Frame.from_numpy(small, domains=domains, device=d), y="visit")
        for d in (dev, "cpu")]
    a, b = (m.training_metrics for m in fits)
    d_auuc = abs(a["auuc"] - b["auuc"]) / max(abs(b["auuc"]), 1e-12)
    d_qini = abs(a["qini"] - b["qini"]) / max(abs(b["qini"]), 1e-12)
    agree = float((fits[0].forest.feat.cpu() == fits[1].forest.feat)
                  .float().mean())
    check(d_auuc <= 1e-3 and d_qini <= 1e-3,
          f"{N_SAMPLE}-row uplift fit card vs CPU: relative dAUUC {d_auuc} "
          f"dQini {d_qini}")
    say(f"phase8 {N_SAMPLE}-row uplift fit card vs CPU plain (no bagging): "
        f"relative |dAUUC| {d_auuc:.3g}, |dQini| {d_qini:.3g} (tolerance "
        f"1e-3: 0/1 stats sum exactly, a near-tie in the float32 "
        f"divergence may flip a split), split features equal at "
        f"{agree:.4f} of slots")
    return model, fr, counts


def phase_hist_timing(torch, dev, model, fr, counts):
    """Phase 9: ``histogram`` at the uplift path's shapes, d=0..9, on the
    first tree's node ids and the treated arm's stats."""
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.models.tree import Tree, _route
    from h2o3_tpu_torch.ops.fixed_point import exponents
    from h2o3_tpu_torch.ops.histogram import local_histogram
    from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
    bm = model.bm
    bins = bm.bins
    N, F = bins.shape
    B = bm.nbins_total
    D = UPLIFT["max_depth"]
    leaf = _route(Tree(*(a[0] for a in model.forest)), bins, B)
    gen = tree_generator(UPLIFT["seed"], 0, dev)
    keep = torch.rand(N, generator=gen, device=dev) < UPLIFT["sample_rate"]
    w = fr.valid_weights() * keep * fr.col("treatment").data
    y = fr.col("visit").data.to(torch.float32)
    stats = torch.stack([w, w * y, w], dim=1).contiguous()
    acc = timing_acc()
    feat = torch.arange(F, device=dev)
    exps = exponents(stats)            # once a tree, as the fit has them
    for d in range(D):
        L = 2 ** d
        nid = (leaf >> (D - d)).to(torch.int32).contiguous()
        cell = ((nid.long()[:, None] * F + feat) * B
                + bins.long()).reshape(-1)
        src = stats[:, None, :].expand(N, F, 3).reshape(N * F, 3)
        t = time_ms(torch, lambda: full_histogram(bins, nid, stats,
                                                  n_nodes=L, n_bins=B,
                                                  exps=exps))
        say(f"  histogram d={d} (L={L}): {spread(t)}, host-paced "
            f"{t['host_paced_ms']:.6g} ms")
        add_time(acc, t)
        acc["plain_ms"] += time_ms(torch, lambda: local_histogram(
            bins, nid, stats, n_nodes=L, n_bins=B), reps=3)["ms"]
        acc["library_ms"] += time_ms(torch, lambda: torch.zeros(
            (L * F * B, 3), device=dev).index_add_(0, cell, src),
            reps=3)["ms"]
        acc["bytes_ms"] += _hist_bytes(N, F, L, B, bins.element_size()) \
            / HBM_BYTES_PER_S * 1e3
        acc["ops_ms"] += 3 * N * F / F32_OPS_PER_S * 1e3
        del cell, src
    rec = kernel_record("histogram", counts["histogram"], acc, D,
                        path="uplift", levels=f"d=0..{D - 1}",
                        has_library=True)
    say(f"phase9 histogram: {rec['ms']:.6g} ms per launch (mean of the "
        f"medians of d=0..9 at {N} rows, F={F}, B={B}; calls "
        f"{rec['ms_min']:.6g}..{rec['ms_max']:.6g}), plain {rec['plain_ms']:.6g} ms, bound "
        f"{rec['bound_ms']:.6g} ms ({rec['bound_by']}), library "
        f"{rec['library_ms']:.6g} ms (index_add_ on precomputed cells)")
    return rec


def mesh_layout(torch):
    """(backend, devices, text): NCCL with one card per rank where there
    are W cards; else gloo with every rank on card 0 (NCCL refuses two
    ranks on one card; gloo all-reduces CUDA tensors through the host)."""
    if torch.cuda.device_count() >= W_MESH:
        return "nccl", [f"cuda:{r}" for r in range(W_MESH)], \
            f"{W_MESH} ranks, one card each, NCCL"
    return "gloo", ["cuda:0"] * W_MESH, \
        f"{W_MESH} ranks on one card (time-sliced), gloo"


def rank_sharded_level(torch, mesh, bm, lo_row):
    """Phase 10 on one rank: the sharded level at the flagship shapes,
    d=0..5, dyadic stats. ``shard_hist`` == ``hist_plain`` and
    ``shard_partition`` == ``partition_plain`` on the rank's rows, EXACT;
    ``shard_hist`` over the mesh (its int64 cells all-reduced) == the
    plain histograms' sum; the splits on it identical on every rank.
    Returns per level the summed histogram, the split outputs and the
    routed node ids, for the parent to hold against one card."""
    from h2o3_tpu_torch.frame.partition import allgather_objects
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    from h2o3_tpu_torch.parallel.map_reduce import all_reduce
    dev = mesh.device
    bins, B = bm.bins, bm.nbins_total
    N = bins.shape[0]
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    stats = dyadic_stats(N_MAIN, 9, torch, dev)[lo_row:lo_row + N]
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    prev, levels = None, []
    errs = {"shard_hist": 0.0, "shard_partition": 0.0}
    for d in range(6):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        lh = tk.shard_hist(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        lh_p = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        torch.cuda.synchronize(dev)
        errs["shard_hist"] = max(errs["shard_hist"],
                                 float((lh - lh_p).abs().max()))
        check(torch.equal(lh, lh_p), f"rank {mesh.rank} shard_hist d={d} "
                                     f"!= hist_plain")
        # the level's form: int64 cells summed over the ranks, converted
        lh = tk.shard_hist(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B,
                           mesh=mesh)
        check(torch.equal(lh, all_reduce(lh_p, mesh)),
              f"rank {mesh.rank} shard_hist d={d}: the sum over the ranks "
              "!= the plain sum")
        out = tk.tree_split(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        seen = allgather_objects([out[i].cpu() for i in (2, 3, 4, 8, 9)],
                                 mesh)
        check(all(torch.equal(a, b) for other in seen
                  for a, b in zip(seen[0], other)),
              f"d={d}: the ranks' split decisions differ")
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        new = tk.shard_partition(bins, nid, *dec, n_bins=B)
        new_p = tk.partition_plain(bins, nid, *dec, n_bins=B)
        torch.cuda.synchronize(dev)
        errs["shard_partition"] = max(errs["shard_partition"],
                                      float((new - new_p).abs().max()))
        check(torch.equal(new, new_p), f"rank {mesh.rank} shard_partition "
                                       f"d={d} != partition_plain")
        levels.append(dict(hist=lh.cpu(), split=[o.cpu() for o in out],
                           nid=new.cpu()))
        prev, nid = out[0], new
    say(f"phase10 rank {mesh.rank}: shard_hist == hist_plain and "
        f"shard_partition == partition_plain on its {N} rows, d=0..5, "
        "exact; split decisions identical on every rank")
    return levels, errs


def rank_main_path(torch, mesh, fr):
    """Phase 11 on one rank: the flagship GBM on the partitioned frame."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.parallel import map_reduce
    dev = mesh.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    map_reduce.reset_collectives()
    t0 = time.perf_counter()
    model = h2o.GBMEstimator(**FLAGSHIP).train(fr, y="IsDepDelayed")
    torch.cuda.synchronize(dev)
    t_train = time.perf_counter() - t0
    coll = dict(map_reduce.COLLECTIVES)
    t1 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize(dev)
    t_pred = time.perf_counter() - t1
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    check_launches(counts, {k: want for k in MESH_KERNELS},
                   f"GBM mesh (rank {mesh.rank})")
    tm = model.training_metrics
    p1 = pred.col("p1").host_view()
    check(pred.partitioned and pred.span == fr.span, "predict partitioned "
                                                     "like its input")
    check(p1.shape == (N_MAIN,) and np.isfinite(p1).all()
          and (p1 > 0).all() and (p1 < 1).all(), "mesh p1 finite in (0, 1)")
    perf = model.model_performance(fr)
    check(abs(perf["AUC"] - tm["AUC"]) < 1e-9, "mesh model_performance on "
                                               "the training frame")
    return dict(t_train=t_train, t_pred=t_pred, auc=tm["AUC"],
                logloss=tm["logloss"], counts=counts, collectives=coll,
                peak=peak, feat=model.forest.feat.cpu(),
                leaf=model.forest.leaf.cpu())


def rank_entry(rank, init_method, backend, devices, card, out_dir):
    """One rank of phases 10-11 (a spawned process): join the group,
    ingest its own rows, run both phases, save what the parent checks."""
    global CARD
    CARD = card
    import torch
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import cloud
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.parallel.mesh import owned_rows
    mesh = cloud.init(backend, rank, W_MESH, init_method,
                      device=devices[rank])
    try:
        cols, domains = airlines_arrays(N_MAIN)
        lo, hi = owned_rows(N_MAIN, mesh, 8)
        t0 = time.perf_counter()
        fr = h2o.Frame.from_numpy_partitioned(
            {k: v[lo:hi] for k, v in cols.items()}, N_MAIN, domains=domains,
            mesh=mesh)
        t_ingest = time.perf_counter() - t0
        del cols
        check(fr.span == (lo, hi), f"rank {rank} span {fr.span}")
        x = [c for c in fr.names if c != "IsDepDelayed"]
        t0 = time.perf_counter()
        bm = bin_frame(fr, x, nbins=64, nbins_cats=1024)
        torch.cuda.synchronize(mesh.device)
        t_bin = time.perf_counter() - t0
        levels, errs = rank_sharded_level(torch, mesh, bm, lo)
        res = dict(levels=levels, errs=errs, bins=bm.bins.cpu(), span=fr.span,
                   t_ingest=t_ingest, t_bin=t_bin)
        del bm
        res.update(rank_main_path(torch, mesh, fr))
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        cloud.shutdown()


def spawn_ranks(torch, out_dir):
    """Start the W ranks of phases 10-11, wait for them (at most
    RANK_TIMEOUT_S; a rank that raises stops all), and return each
    rank's saved results."""
    import socket
    import torch.multiprocessing as mp
    backend, devices, layout = mesh_layout(torch)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    say(f"phase10-11 layout: {layout}; backend {backend}; rendezvous "
        f"tcp://localhost:{port}")
    ctx = mp.start_processes(
        rank_entry, args=(f"tcp://localhost:{port}", backend, devices, CARD,
                          out_dir), nprocs=W_MESH, join=False,
        start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"ranks still running after {RANK_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False)
            for r in range(W_MESH)], backend, layout


def phase_mesh(torch, dev, fr, auc_one_card, forest_one_card):
    """Phases 10-11: the sharded level and the flagship GBM over W ranks,
    held against one card. Returns (rank 0's launch counts, the largest
    |err| of each shard kernel against its plain version over the ranks,
    the full frame's bins for phase 12)."""
    import tempfile
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    x = [c for c in fr.names if c != "IsDepDelayed"]
    bm = bin_frame(fr, x, nbins=64, nbins_cats=1024)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ranks, backend, layout = spawn_ranks(torch, out_dir)
    say(f"phase10-11 ranks done in {time.perf_counter() - t0:.3f} s "
        "(spawn, ingest, both phases)")
    # phase 10 against one card over all rows
    check(torch.equal(torch.cat([r["bins"] for r in ranks]).to(dev),
                      bm.bins), "partitioned bins != one-card bins")
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    B = bm.nbins_total
    stats = dyadic_stats(N_MAIN, 9, torch, dev)
    nid = torch.zeros(N_MAIN, dtype=torch.int32, device=dev)
    prev = None
    for d in range(6):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        lh = tk.tree_hist(bm.bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        out = tk.tree_split(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        new = tk.tree_partition(bm.bins, nid, *dec, n_bins=B)
        for r, res in enumerate(ranks):
            lev = res["levels"][d]
            check(torch.equal(lev["hist"].to(dev), lh),
                  f"d={d}: rank {r}'s all-reduced histogram != one card")
            for i, (a, b) in enumerate(zip(lev["split"], out)):
                check(identical(a.to(dev), b),
                      f"d={d}: rank {r}'s split output {i} != one card")
        cat = torch.cat([res["levels"][d]["nid"] for res in ranks]).to(dev)
        check(torch.equal(cat, new), f"d={d}: concatenated nids != one card")
        prev, nid = out[0], new
    say(f"phase10 sharded level, {W_MESH} ranks x {N_MAIN // W_MESH} rows, "
        "d=0..5: all-reduced histograms == one card's over all "
        f"{N_MAIN} rows, splits identical on every rank and == one card, "
        "concatenated routing == one card (all EXACT)")
    # phase 11: the main path over W ranks
    for r, res in enumerate(ranks):
        coll = res["collectives"]
        say(f"phase11 rank {r} rows [{res['span'][0]}, {res['span'][1]}): "
            f"ingest {res['t_ingest']:.3f} s, train {res['t_train']:.3f} s "
            f"({N_MAIN * FLAGSHIP['ntrees'] / res['t_train']:.6g} "
            f"rows*trees/s; bin_frame alone {res['t_bin']:.3f} s), predict "
            f"{res['t_pred']:.3f} s, AUC "
            f"{res['auc']:.6f}, logloss {res['logloss']:.6f}, peak device "
            f"memory {res['peak'] / 2**30:.3f} GiB; all-reduce "
            f"{int(coll['all_reduce'])} calls, {int(coll['bytes'])} bytes, "
            f"{coll['seconds']:.3f} s per fit; launches {res['counts']}")
        check(torch.equal(res["feat"], ranks[0]["feat"]) and torch.equal(
            res["leaf"], ranks[0]["leaf"]), f"rank {r}'s forest differs")
    d_auc = abs(ranks[0]["auc"] - auc_one_card)
    check(d_auc < 5e-3, f"mesh AUC {ranks[0]['auc']} vs one card "
                        f"{auc_one_card}")
    # the histograms and leaf sums are integer sums all-reduced in int64,
    # with exponents every rank shares: the ranks' forest is one card's
    check(torch.equal(ranks[0]["feat"], forest_one_card.feat) and
          torch.equal(ranks[0]["leaf"], forest_one_card.leaf),
          f"the forest over {W_MESH} ranks differs from phase 4's")
    say(f"phase11 main path over {W_MESH} ranks ({layout}, backend "
        f"{backend}): every rank holds the same forest; |AUC - phase 4 "
        f"AUC| {d_auc:.3g} (tolerance 5e-3); splits and leaves bit-equal "
        f"to phase 4's (checked)")
    errs = {k: max(r["errs"][k] for r in ranks) for k in ranks[0]["errs"]}
    return ranks[0]["counts"], errs, bm


def phase_shard_timing(torch, dev, bm, counts):
    """Phase 12: ``shard_hist`` and ``shard_partition`` at the shard
    shapes (one rank's N/W rows), d=0..5, on one card alone."""
    n = N_MAIN // W_MESH
    return timing_records(level_timing(
        torch, dev, bm, ("shard_hist", "shard_partition"), n), counts, n,
        "phase12", "gbm_mesh")


def on_cpu(forest):
    """A forest's fields copied to the host."""
    return type(forest)(*(a.cpu() for a in forest))


def card_and_cpu(build, small, domains, dev, **train_kw):
    """``build()`` estimator trained on the ``small`` columns on the card
    and on the CPU (the plain versions): (card model, CPU model)."""
    import h2o3_tpu_torch as h2o
    return tuple(build().train(h2o.Frame.from_numpy(
        small, domains=domains, device=d), **train_kw) for d in (dev, "cpu"))


def timed_fit(torch, fit):
    """(model, train seconds, launches, peak device bytes) of ``fit()``,
    every launch count set to 0 just before it."""
    from h2o3_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    model = fit()
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated())


def class_probs(pred, K: int) -> np.ndarray:
    return np.stack([pred.col(f"p{k}").host_view() for k in range(K)], 1)


def phase_multinomial(torch, dev, cols, domains):
    """Phase 13: multinomial GBM on the Covertype frame, train → predict
    → model_performance; K class trees an iteration through the level
    kernels; the fit against the CPU plain path on a 20K-row sample."""
    import h2o3_tpu_torch as h2o
    K = len(COVTYPE_COUNTS)
    n = len(cols["Cover_Type"])
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    model, t_train, counts, peak = timed_fit(torch, lambda: h2o.GBMEstimator(
        **MULTI_GBM).train(fr, y="Cover_Type"))
    t0 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    T = MULTI_GBM["ntrees"] * K
    check_launches(counts, {k: T * MULTI_GBM["max_depth"]
                            for k in LEVEL_KERNELS}, "GBM multinomial")
    check(model.forest.feat.shape[0] == T and model.f0.shape == (K,),
          f"multinomial forest {tuple(model.forest.feat.shape)}")
    p = class_probs(pred, K)
    check(p.shape == (n, K) and np.isfinite(p).all() and (p >= 0).all()
          and np.abs(p.sum(1) - 1).max() < 1e-5,
          "class probabilities finite, in [0, 1], summing to 1")
    check(np.array_equal(pred.col("predict").host_view(), p.argmax(1)),
          "predict = the most probable class")
    tm = model.training_metrics
    perf = model.model_performance(fr)
    check(abs(perf["logloss"] - tm["logloss"]) < 1e-9
          and abs(perf["AUC"] - tm["AUC"]) < 1e-9,
          "model_performance on the training frame = training metrics")
    prior = np.asarray(COVTYPE_COUNTS) / N_COVTYPE
    check(np.isfinite(tm["logloss"]) and tm["logloss"]
          < -np.sum(prior * np.log(prior)) and tm["AUC"] > 0.8,
          f"multinomial logloss {tm['logloss']} AUC {tm['AUC']}")
    say(f"phase13 multinomial GBM ntrees={MULTI_GBM['ntrees']} max_depth="
        f"{MULTI_GBM['max_depth']} on the Covertype schema ({n} rows x 54 "
        f"features, {K} classes: {T} class trees): train {t_train:.3f} s, "
        f"{n * MULTI_GBM['ntrees'] / t_train:.6g} rows*iterations/s "
        f"({n * T / t_train:.6g} rows*trees/s), predict {t_pred:.3f} s, "
        f"logloss {tm['logloss']:.6f}, mean per-class error "
        f"{tm['mean_per_class_error']:.6f}, weighted-OVR AUC "
        f"{tm['AUC']:.6f}, peak device memory {peak / 2**30:.3f} GiB")
    say(f"phase13 launches: {counts}")
    refit = h2o.GBMEstimator(**MULTI_GBM).train(fr, y="Cover_Type")
    check(forests_equal(refit.forest, model.forest) and all(
        refit.training_metrics[k] == tm[k] for k in ("logloss", "AUC")),
        "multinomial GBM refit differs from the first fit")
    say("phase13 refit: forest and training logloss/AUC bit-equal to the "
        "first fit")
    from h2o3_tpu_torch.frame.binning import bin_frame
    t0 = time.perf_counter()
    bin_frame(fr, [c for c in cols if c != "Cover_Type"], nbins=64,
              nbins_cats=1024, weights=np.ones(n, np.float32))
    torch.cuda.synchronize()
    say(f"phase13 breakdown: bin_frame alone {time.perf_counter() - t0:.3f} "
        "s")
    small = {k: v[:N_SAMPLE] for k, v in cols.items()}
    a, b = (m.training_metrics for m in card_and_cpu(
        lambda: h2o.GBMEstimator(**MULTI_GBM), small, domains, dev,
        y="Cover_Type"))
    d_ll, d_auc = abs(a["logloss"] - b["logloss"]), abs(a["AUC"] - b["AUC"])
    check(d_ll < 5e-3 and d_auc < 5e-3, f"{N_SAMPLE}-row multinomial fit "
                                        f"card vs CPU: dlogloss {d_ll} "
                                        f"dAUC {d_auc}")
    say(f"phase13 {N_SAMPLE}-row multinomial fit card vs CPU plain: "
        f"|dlogloss| {d_ll:.3g}, |dAUC| {d_auc:.3g} (tolerance 5e-3)")
    return model, fr, counts


def phase_multinomial_drf(torch, dev, fr, cols, domains):
    """Phase 14: multinomial DRF on phase 13's frame (as phase 6: the
    default mtries, sample_rate 0.632); on a 20K-row sample without
    bagging or column sampling, the card forest EXACTLY equals the CPU
    plain forest (0/1 statistics, no draws)."""
    import h2o3_tpu_torch as h2o
    K = len(COVTYPE_COUNTS)
    model, t_train, counts, peak = timed_fit(torch, lambda: h2o.DRFEstimator(
        **DRF).train(fr, y="Cover_Type"))
    T = DRF["ntrees"] * K
    check(model.forest.feat.shape[:2] == (T, DRF["max_depth"]),
          f"multinomial DRF forest {tuple(model.forest.feat.shape)}")
    check_launches(counts, {k: T * DRF["max_depth"] for k in LEVEL_KERNELS},
                   "DRF multinomial")
    tm = model.training_metrics
    check(np.isfinite(tm["logloss"]) and tm["AUC"] > 0.8,
          f"multinomial DRF OOB logloss {tm['logloss']} AUC {tm['AUC']}")
    p = class_probs(model.predict(fr), K)
    check(np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
          and np.abs(p.sum(1) - 1).max() < 1e-4, "DRF class probabilities")
    n = len(cols["Cover_Type"])
    say(f"phase14 multinomial DRF ntrees={DRF['ntrees']} max_depth="
        f"{DRF['max_depth']} on {n} rows ({T} class trees): train "
        f"{t_train:.3f} s, {n * DRF['ntrees'] / t_train:.6g} "
        f"rows*iterations/s, OOB logloss {tm['logloss']:.6f}, OOB "
        f"weighted-OVR AUC {tm['AUC']:.6f} (nobs {tm.nobs}), peak device "
        f"memory {peak / 2**30:.3f} GiB")
    say(f"phase14 launches: {counts}")
    small = {k: v[:N_SAMPLE] for k, v in cols.items()}
    m_gpu, m_cpu = card_and_cpu(
        lambda: h2o.DRFEstimator(**DRF, sample_rate=1.0, mtries=54), small,
        domains, dev, y="Cover_Type")
    equal_trees(on_cpu(m_gpu.forest), m_cpu.forest,
                f"{N_SAMPLE}-row multinomial DRF, card vs CPU plain")
    splits = int(m_gpu.forest.is_split.sum())
    say(f"phase14 {N_SAMPLE}-row multinomial DRF (sample_rate=1, mtries=54) "
        f"card forest == CPU plain forest, EXACT ({splits} splits)")
    return counts


def family_columns(cols, delay, seed: int = 13):
    """The airlines features with one response a family, made from the
    delay signal s = delay / 25: counts (poisson), positive values
    (gamma), zero-inflated positive values (tweedie) and the delay in
    minutes (laplace, quantile, huber)."""
    rng = np.random.default_rng(seed)
    n = len(delay)
    s = delay / 25.0
    scale = np.exp(0.3 * s) / 2.0
    out = {k: v for k, v in cols.items() if k != "IsDepDelayed"}
    out["y_poisson"] = rng.poisson(np.exp(0.3 * s)).astype(np.float32)
    out["y_gamma"] = rng.gamma(2.0, scale).astype(np.float32)
    out["y_tweedie"] = ((rng.random(n) < 1 / (1 + np.exp(-s)))
                        * rng.gamma(2.0, scale)).astype(np.float32)
    out["y_real"] = delay.astype(np.float32)
    return out


def family_response(name: str) -> str:
    return f"y_{name}" if name in ("poisson", "gamma", "tweedie") \
        else "y_real"


def split_on_family_stats(torch, model, fr, name, kw):
    """The level kernels on a family's own statistics {w, w·g, w·h} at
    the fitted margins, d=0..5, held against their plain versions as
    phase 2 holds real-valued stats: ``tree_hist`` within the summation
    bound, ``tree_split``'s gains within 1e-3 relative on the same
    histogram and its decisions equal but at near-ties (the kernel's
    block-wide prefix scans add the bins in another order than the plain
    ``cumsum``), ``tree_partition`` EXACT. Returns (the largest node
    hessian sum, max |gain diff|, max |gain diff| / max(|gain|, 1),
    split flips)."""
    from h2o3_tpu_torch.models.distribution import get_distribution
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    dist = get_distribution(name, **kw)
    bm = model.bm
    dev = bm.bins.device
    y = fr.col(family_response(name)).data.to(torch.float32)
    marg = model._margins(bm)
    w = fr.valid_weights()
    stats = torch.stack([w, w * dist.grad(y, marg), w * dist.hess(y, marg)],
                        dim=1).contiguous()
    # DIST_GBM's min_rows, reg_lambda, min_split_improvement and depth
    _, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    B = bm.nbins_total
    nid = torch.zeros(bm.bins.shape[0], dtype=torch.int32, device=dev)
    prev, h_max, err, rel, flips = None, 0.0, 0.0, 0.0, 0
    for d in range(DIST_GBM["max_depth"]):
        errs, f, out_p, nid_next = compare_level(
            tk, bm.bins, nid, stats, prev, ops, d=d, L=2 ** d, B=B,
            exact=False)
        err = max(err, errs["tree_split"])
        rel = max(rel, errs.get("tree_split_rel", 0.0))
        flips += f
        # node H: the hessian sums of any one feature's bins
        h_max = max(h_max, float(out_p[0][:, 0, :, 2].sum(dim=1).max()))
        prev, nid = out_p[0], nid_next
    return h_max, err, rel, flips


def phase_distributions(torch, dev, cols, delay, domains):
    """Phase 15: one GBM a family on the first N_DIST airlines rows, each
    launching every level kernel 60 times; ``tree_split`` EXACT against
    its plain version on the log-link families' exp-scaled hessians; on a
    20K-row sample the dyadic families' card forests EXACTLY equal the
    CPU plain forests, the others' mean residual deviance within 5e-3
    relative. Returns the launches summed over the fits."""
    import h2o3_tpu_torch as h2o
    fcols = family_columns(cols, delay)
    x = [c for c in cols if c != "IsDepDelayed"]
    fr = h2o.Frame.from_numpy(fcols, domains=domains, device=dev)
    small = {k: v[:N_SAMPLE] for k, v in fcols.items()}
    total = {}
    for name, kw in FAMILIES:
        label = name + "".join(f"({v})" for v in kw.values())
        y = family_response(name)
        params = dict(DIST_GBM, distribution=name, **kw)
        model, t_train, counts, peak = timed_fit(
            torch, lambda: h2o.GBMEstimator(**params).train(fr, y=y, x=x))
        check_launches(counts, {k: DIST_GBM["ntrees"] * DIST_GBM["max_depth"]
                                for k in LEVEL_KERNELS}, f"GBM {label}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        tm = model.training_metrics
        pred = model.predict(fr).col("predict").host_view()
        check(np.isfinite(pred).all() and np.isfinite(
            tm["mean_residual_deviance"]), f"{label}: predictions finite")
        if name in ("poisson", "gamma", "tweedie"):
            check((pred > 0).all(), f"{label}: log-link predictions > 0")
        extra = ""
        if name == "poisson":
            refit = h2o.GBMEstimator(**params).train(fr, y=y, x=x)
            check(forests_equal(refit.forest, model.forest) and
                  refit.training_metrics["mean_residual_deviance"]
                  == tm["mean_residual_deviance"],
                  "poisson GBM refit differs from the first fit")
            extra += "; refit bit-equal (forest, deviance)"
        if name in ("poisson", "gamma", "tweedie"):
            h_max, err, rel, flips = split_on_family_stats(torch, model, fr,
                                                           name, kw)
            extra += (f"; level kernels on its exp-scaled hessians (largest "
                     f"node H {h_max:.6g}), d=0..5: tree_split max |gain "
                     f"diff| {err:.3g} ({rel:.3g} of max(|gain|, 1)), "
                     f"{flips} split flip(s) at near-ties, tree_hist within "
                     f"the summation bound, tree_partition EXACT")
        m_gpu, m_cpu = card_and_cpu(lambda: h2o.GBMEstimator(**params),
                                    small, domains, dev, y=y, x=x)
        if (name, kw) in DYADIC_FAMILIES:
            equal_trees(on_cpu(m_gpu.forest), m_cpu.forest,
                        f"{label}: {N_SAMPLE}-row fit, card vs CPU plain")
            cmp = "card forest == CPU plain forest, EXACT"
        else:
            a = m_gpu.training_metrics["mean_residual_deviance"]
            b = m_cpu.training_metrics["mean_residual_deviance"]
            rel = abs(a - b) / max(abs(b), 1e-12)
            check(rel <= 5e-3, f"{label}: {N_SAMPLE}-row mean residual "
                               f"deviance card {a} vs CPU {b}")
            cmp = f"relative |d deviance| card vs CPU {rel:.3g}"
        say(f"phase15 GBM {label} on {N_DIST} rows: train {t_train:.3f} s, "
            f"{N_DIST * DIST_GBM['ntrees'] / t_train:.6g} rows*trees/s, "
            f"mean residual deviance {tm['mean_residual_deviance']:.6g}, "
            f"peak device memory {peak / 2**30:.3f} GiB; {N_SAMPLE} rows: "
            f"{cmp}{extra}")
    say(f"phase15 launches over {len(FAMILIES)} fits: {total}")
    return total


def phase_stopping(torch, dev, cols, domains):
    """Phase 16: the flagship GBM with early stopping on the validation
    part of an 80/20 split of the first N_DIST airlines rows: every level
    kernel launches (trees kept) x 6 times."""
    import h2o3_tpu_torch as h2o
    cut = N_DIST * 4 // 5
    fr_t, fr_v = (h2o.Frame.from_numpy({k: v[a:b] for k, v in cols.items()},
                                       domains=domains, device=dev)
                  for a, b in ((0, cut), (cut, N_DIST)))
    model, t_train, counts, peak = timed_fit(torch, lambda: h2o.GBMEstimator(
        **STOPPING).train(fr_t, y="IsDepDelayed", validation_frame=fr_v))
    kept = model.forest.feat.shape[0]
    hist = model.output["scoring_history"]
    check_launches(counts, {k: kept * STOPPING["max_depth"]
                            for k in LEVEL_KERNELS}, "GBM early stopping")
    check(len(hist) == kept and hist[-1]["ntrees"] == kept
          and kept <= STOPPING["ntrees"], f"scoring history {hist}")
    vm = model.validation_metrics
    check(vm is not None and vm.nobs == N_DIST - cut and vm["AUC"] > 0.7,
          f"validation metrics {vm}")
    stopped = kept < STOPPING["ntrees"]
    say(f"phase16 GBM early stopping (stopping_rounds=2, "
        f"score_tree_interval=1, validation {N_DIST - cut} of {N_DIST} "
        f"rows): {'stopped after tree' if stopped else 'ran all'} {kept} of "
        f"{STOPPING['ntrees']}, train {t_train:.3f} s, validation AUC "
        f"{vm['AUC']:.6f}, logloss {vm['logloss']:.6f}, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    say("phase16 scoring history (ntrees: validation deviance): " + ", ".join(
        f"{e['ntrees']}: {e['deviance']:.6f}" for e in hist))
    say(f"phase16 launches: {counts}")
    return counts


def forests_equal(a, b) -> bool:
    """Every field of two forests equal (compared on the host)."""
    import torch
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in a._fields)


def forest_prefix(forest, n: int):
    return type(forest)(*(a[:n] for a in forest))


INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words", "leaf_w")


def leaf_gap(a, b):
    """How two GBM forests on the card compare: None when a split (any
    integer field, or a leaf's row weight) differs, else the largest leaf
    difference over the largest leaf (0.0: bit-equal)."""
    import torch
    if not all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in INT_FIELDS):
        return None
    la, lb = a.leaf.cpu(), b.leaf.cpu()
    return float((la - lb).abs().max() / lb.abs().max().clamp_min(1e-30))


def host_auc(p1, y) -> float:
    """AUC of host scores against 0/1 labels, by the port's metrics."""
    from h2o3_tpu_torch.models.metrics import binomial_metrics
    return binomial_metrics(np.asarray(p1, np.float32),
                            np.asarray(y, np.float32))["AUC"]


def path_sets_ok(forest, names, groups) -> int:
    """Check that no root-to-node path of any tree splits on features of
    two different interaction sets; returns the split nodes checked."""
    feat = forest.feat.cpu().numpy()
    split = forest.is_split.cpu().numpy()
    group_of = {c: i for i, g in enumerate(groups) for c in g}
    checked = 0
    for t in range(feat.shape[0]):
        for d in range(feat.shape[1]):
            for node in np.nonzero(split[t, d, :2 ** d])[0]:
                path = {group_of.get(names[feat[t, a, node >> (d - a)]],
                                     names[feat[t, a, node >> (d - a)]])
                        for a in range(d + 1)
                        if split[t, a, node >> (d - a)]}
                check(len(path) == 1, f"tree {t} node ({d}, {node}) path "
                                      f"mixes interaction sets {path}")
                checked += 1
    return checked


def monotone_probe(model, cols, domains, dev, feature: str) -> np.ndarray:
    """p1 on an N_GRID-point grid over ``feature``'s range, every other
    column held at the values of row 0."""
    import h2o3_tpu_torch as h2o
    grid = {k: np.repeat(v[:1], N_GRID) for k, v in cols.items()}
    lo, hi = float(cols[feature].min()), float(cols[feature].max())
    grid[feature] = np.linspace(lo, hi, N_GRID)
    fr = h2o.Frame.from_numpy(grid, domains=domains, device=dev)
    return model.predict(fr).col("p1").host_view()


def phase_constraints(torch, dev, fr, cols, domains):
    """Phase 17(a): monotone and interaction constraints at full width."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.gbm import (build_constraints,
                                           build_interaction_sets)
    from h2o3_tpu_torch.models.tree import grow_tree
    from h2o3_tpu_torch.ops.kernels.treekernel import plain_level
    kw = dict(FLAGSHIP, monotone_constraints=MONOTONE,
              interaction_constraints=INTERACTIONS)
    model, t_train, counts, peak = timed_fit(
        torch, lambda: h2o.GBMEstimator(**kw).train(fr, y=Y))
    want = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    check_launches(counts, {k: want for k in LEVEL_KERNELS},
                   "GBM constraints")
    tm = model.training_metrics
    check(tm["AUC"] > 0.7, f"constrained AUC {tm['AUC']}")
    up = monotone_probe(model, cols, domains, dev, "DepTime")
    down = monotone_probe(model, cols, domains, dev, "Distance")
    check((np.diff(up) >= 0).all(), "p1 decreases along DepTime: "
                                    f"{np.diff(up).min()}")
    check((np.diff(down) <= 0).all(), "p1 increases along Distance: "
                                      f"{np.diff(down).max()}")
    names = model.bm.names
    groups = INTERACTIONS + [[c] for c in names
                             if not any(c in g for g in INTERACTIONS)]
    n_paths = path_sets_ok(model.forest, names, groups)
    # one grow_tree with these constraints and sets on dyadic stats,
    # through the kernels and through the plain versions
    bm = model.bm
    tp, sc, _, cm, _, _ = level_plan(bm, torch, dev)
    cons = build_constraints(kw, names, fr, "Binomial", dev)
    sets = build_interaction_sets(kw, names, dev)
    st = dyadic_stats(N_KERNEL, 17, torch, dev)
    w = st[:, 0].contiguous()
    g = (st[:, 1] / torch.where(w > 0, w, 1.0)).contiguous()
    h = (st[:, 2] / torch.where(w > 0, w, 1.0)).contiguous()
    bins = bm.bins[:N_KERNEL].contiguous()
    (t_k, nid_k, gain_k), (t_p, nid_p, gain_p) = (
        grow_tree(bins, bm.nbins, w, g, h, cm, params=tp, scalars=sc,
                  constraints=cons, interaction_sets=sets, **lv)
        for lv in ({}, {"level_fn": plain_level}))
    torch.cuda.synchronize()
    equal_trees(t_k, t_p, "constrained grow_tree")
    check(torch.equal(nid_k, nid_p) and torch.equal(gain_k, gain_p),
          "constrained grow_tree: leaf ids or gains differ")
    small = {k: v[:N_SAMPLE] for k, v in cols.items()}
    a, b = (m.training_metrics["AUC"] for m in card_and_cpu(
        lambda: h2o.GBMEstimator(**kw), small, domains, dev, y=Y))
    check(abs(a - b) < 5e-3, f"{N_SAMPLE}-row constrained fit card vs "
                             f"CPU: dAUC {abs(a - b)}")
    say(f"phase17a constraints (monotone {MONOTONE}, interaction sets "
        f"{INTERACTIONS}) on {N_MAIN} rows: train {t_train:.3f} s, AUC "
        f"{tm['AUC']:.6f}, peak {peak / 2**30:.3f} GiB; p1 monotone on "
        f"{N_GRID}-point grids (DepTime up, Distance down); {n_paths} split "
        "paths each within one interaction set; constrained grow_tree "
        f"kernels == plain ({int(t_k.is_split.sum())} splits); "
        f"{N_SAMPLE}-row fit |dAUC| card vs CPU {abs(a - b):.3g}")
    say(f"phase17a launches: {counts}")
    return counts


def phase_offset(torch, dev, cols, domains):
    """Phase 17(b): an offset column, its f0 and scoring with it."""
    import h2o3_tpu_torch as h2o
    ocols = dict(cols, Offset=0.002 * (cols["DepTime"] - 1200.0))
    fro = h2o.Frame.from_numpy(ocols, domains=domains, device=dev)
    kw = dict(FLAGSHIP, offset_column="Offset")
    model, t_train, counts, peak = timed_fit(
        torch, lambda: h2o.GBMEstimator(**kw).train(fro, y=Y))
    want = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    check_launches(counts, {k: want for k in LEVEL_KERNELS}, "GBM offset")
    tm = model.training_metrics
    check(np.isfinite(float(model.f0)) and tm["AUC"] > 0.7,
          f"offset fit f0 {model.f0} AUC {tm['AUC']}")
    small = {k: v[:N_SAMPLE] for k, v in ocols.items()}
    frs = [h2o.Frame.from_numpy(small, domains=domains, device=d)
           for d in (dev, "cpu")]
    a, b = (h2o.GBMEstimator(**kw).train(f, y=Y) for f in frs)
    rel = abs(float(a.f0) - float(b.f0)) / max(abs(float(b.f0)), 1e-30)
    check(rel < 1e-6, f"offset f0 card {a.f0} vs CPU {b.f0}")
    y = small[Y]
    auc_a, auc_b = (host_auc(m.predict(f).col("p1").host_view(), y)
                    for m, f in ((a, frs[0]), (b, frs[1])))
    check(abs(auc_a - auc_b) < 5e-3, f"offset predict AUC card {auc_a} "
                                     f"vs CPU {auc_b}")
    say(f"phase17b offset 0.002*(DepTime-1200) on {N_MAIN} rows: train "
        f"{t_train:.3f} s, f0 {float(model.f0):.9g}, AUC {tm['AUC']:.6f}, "
        f"peak {peak / 2**30:.3f} GiB; {N_SAMPLE}-row f0 card "
        f"{float(a.f0):.9g} vs CPU {float(b.f0):.9g} (rel {rel:.3g}), "
        f"predict AUC card {auc_a:.6f} vs CPU {auc_b:.6f}")
    say(f"phase17b launches: {counts}")
    return counts


def phase_checkpoint(torch, dev, fr, gbm_forest, drf_forest, drf_auc):
    """Phase 17(c): 5 trees, then a checkpoint restart to 10, for GBM
    (held to the donor's prefix; whether it equals phase 4's forest is
    reported) and DRF (bit-equal to phase 6's forest and OOB AUC)."""
    import h2o3_tpu_torch as h2o

    def restart(est, kw):
        donor = est(**dict(kw, ntrees=5)).train(fr, y=Y)
        return donor, est(**dict(kw, checkpoint=donor)).train(fr, y=Y)

    (donor, model), t_gbm, counts_gbm, _ = timed_fit(
        torch, lambda: restart(h2o.GBMEstimator, FLAGSHIP))
    check_launches(counts_gbm, {k: 60 for k in LEVEL_KERNELS},
                   "GBM checkpoint")
    check(model.forest.feat.shape[0] == 10 and forests_equal(
        forest_prefix(model.forest, 5), donor.forest),
        "GBM restart: trees 1-5 are not the donor's")
    gap = leaf_gap(model.forest, gbm_forest)
    same = (f"splits first differ at tree "
            f"{first_split_diff(model.forest, gbm_forest) + 1}"
            if gap is None else "bit-equal" if gap == 0
            else f"splits equal, leaves within {gap:.3g} of the largest")
    (ddonor, dmodel), t_drf, counts_drf, _ = timed_fit(
        torch, lambda: restart(h2o.DRFEstimator, DRF))
    check_launches(counts_drf, {k: 100 for k in LEVEL_KERNELS},
                   "DRF checkpoint")
    check(forests_equal(dmodel.forest, drf_forest),
          "DRF 5 -> 10 restart differs from phase 6's forest")
    auc = dmodel.training_metrics["AUC"]
    check(auc == drf_auc, f"DRF restart OOB AUC {auc} vs phase 6 {drf_auc}")
    say(f"phase17c GBM checkpoint 5 -> 10 trees: {t_gbm:.3f} s both fits, "
        f"trees 1-5 == donor's; against phase 4's 10-tree forest: {same}")
    say(f"phase17c DRF checkpoint 5 -> 10 trees: {t_drf:.3f} s both fits, "
        f"forest == phase 6's bit for bit, OOB AUC {auc:.9f} == phase 6's")
    say(f"phase17c launches: GBM {counts_gbm}, DRF {counts_drf}")
    return counts_gbm, counts_drf


def phase_cv(torch, dev, fr, t_main):
    """Phase 17(d): 5-fold CV of the flagship GBM on the fast path: the
    main model's binning shared by the folds, so one bin_frame a fit."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame import binning
    from h2o3_tpu_torch.models import gbm as gbm_mod
    calls = []
    real = binning.bin_frame

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    binning.bin_frame = gbm_mod.bin_frame = counted
    try:
        model, t_cv, counts, peak = timed_fit(
            torch, lambda: h2o.GBMEstimator(**CV).train(fr, y=Y))
    finally:
        binning.bin_frame = gbm_mod.bin_frame = real
    nf = CV["nfolds"]
    want = (nf + 1) * FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    check_launches(counts, {k: want for k in LEVEL_KERNELS}, "GBM CV")
    check(len(calls) == 1, f"bin_frame ran {len(calls)} times in a CV fit")
    cvm = model.cross_validation_metrics
    check(len(model._cv_models) == nf and cvm.nobs == N_MAIN
          and cvm["AUC"] > 0.7 and np.isfinite(cvm["logloss"]),
          f"CV metrics {cvm}")
    rows = {r[0]: r for r in model.output["cv_summary_rows"]}
    check(len(rows["AUC"]) == 3 + nf, "cv_summary_rows: a slot per fold")
    say(f"phase17d GBM {nf}-fold CV (random folds, seed 1) on {N_MAIN} "
        f"rows: train {t_cv:.3f} s ({t_cv / (nf + 1):.3f} s a fit, "
        f"against phase 4's {t_main:.3f} s; {t_cv / (t_main * (nf + 1)):.3f}"
        f" of {nf + 1} x phase 4), bin_frame calls {len(calls)}, CV AUC "
        f"{cvm['AUC']:.6f}, CV logloss {cvm['logloss']:.6f}, fold AUCs "
        + " ".join(f"{v:.6f}" for v in rows["AUC"][3:])
        + f", peak {peak / 2**30:.3f} GiB")
    say(f"phase17d launches: {counts}")
    return counts


def phase_calibration(torch, dev, fr, domains):
    """Phase 17(e): Platt scaling and isotonic regression fitted on a
    1M-row calibration frame."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ml import calibration as cal
    ccols, _ = airlines_arrays(N_CAL, seed=8)
    frc = h2o.Frame.from_numpy(ccols, domains=domains, device=dev)
    kw = dict(FLAGSHIP, calibrate_model=True, calibration_frame=frc)
    model, t_train, counts, _ = timed_fit(
        torch, lambda: h2o.GBMEstimator(**kw).train(fr, y=Y))
    p1 = np.asarray(model._score_raw(frc)["p1"], np.float64)
    y = ccols[Y].astype(float)
    a, b = model.calibrator.params
    a_np, b_np = cal.fit_platt(p1, y)
    check(abs(a - a_np) < 1e-9 and abs(b - b_np) < 1e-9,
          f"Platt (a, b) = ({a}, {b}), numpy ({a_np}, {b_np})")
    out = {}
    for method in ("PlattScaling", "IsotonicRegression"):
        t0 = time.perf_counter()
        if method != "PlattScaling":
            cal.calibrate_model(model, frc, method)
        t_fit = time.perf_counter() - t0
        pred = model.predict(frc)
        cp1 = pred.col("cal_p1").host_view()
        check(np.isfinite(cp1).all() and (cp1 >= 0).all()
              and (cp1 <= 1).all(), f"{method}: cal_p1 outside [0, 1]")
        out[method] = (host_auc(cp1, y), float(np.mean(cp1)), t_fit)
    xs, ys = model.calibrator.params
    check((np.diff(xs) >= 0).all() and (np.diff(ys) >= 0).all(),
          "isotonic steps not monotone")
    say(f"phase17e calibration on {N_CAL} rows: fit + Platt {t_train:.3f} "
        f"s, Platt (a, b) = ({a:.9g}, {b:.9g}) == numpy's, isotonic "
        f"{len(xs)} steps in {out['IsotonicRegression'][2]:.3f} s; cal_p1 "
        "AUC / mean: " + ", ".join(f"{k} {v[0]:.6f} / {v[1]:.6f}"
                                   for k, v in out.items())
        + f", raw p1 mean {p1.mean():.6f}, labels mean {y.mean():.6f}")
    say(f"phase17e launches: {counts}")


def first_split_diff(a, b):
    """The first tree whose splits (integer fields) differ, or None."""
    import torch
    for t in range(a.feat.shape[0]):
        if not all(torch.equal(getattr(a, f)[t].cpu(), getattr(b, f)[t].cpu())
                   for f in INT_FIELDS):
            return t
    return None


def phase_runtime_cap(torch, dev, fr, cols, domains, gbm_forest,
                      metrics_main, drf_forest):
    """Phase 17(f): ``max_runtime_secs``. The card's fits are
    deterministic (every sum of a fit is 64-bit fixed point), so a cap
    that does not bind leaves a forest bit-equal to the uncapped fit's
    and a tight one keeps a bit-equal prefix: DRF's and a laplace GBM's
    (both sample rows and columns, so this holds the per-tree draws too),
    and the flagship's refit under the loose cap, bit-equal to phase 4's
    forest and training AUC and logloss. Then the flagship's tree loop
    timed alone (the binning shared) without a cap and under the loose
    cap: what the device wait after each tree costs."""
    import h2o3_tpu_torch as h2o
    drf = h2o.DRFEstimator(**dict(DRF, max_runtime_secs=CAP_LOOSE_S)
                           ).train(fr, y=Y)
    check(forests_equal(drf.forest, drf_forest),
          "a non-binding max_runtime_secs changed phase 6's DRF forest")
    lcols = {k: v for k, v in cols.items() if k != Y}
    lcols["Delay"] = airlines_delay(N_MAIN)
    frl = h2o.Frame.from_numpy(lcols, domains=domains, device=dev)
    lap = {cap: h2o.GBMEstimator(**dict(LAPLACE, max_runtime_secs=cap)
                                 ).train(frl, y="Delay")
           for cap in (0.0, CAP_LOOSE_S, CAP_TIGHT_S)}
    check(forests_equal(lap[CAP_LOOSE_S].forest, lap[0.0].forest),
          "a non-binding max_runtime_secs changed the laplace GBM")
    n = lap[CAP_TIGHT_S].forest.feat.shape[0]
    check(1 <= n < LAPLACE["ntrees"] and forests_equal(
        lap[CAP_TIGHT_S].forest, forest_prefix(lap[0.0].forest, n)),
        f"max_runtime_secs={CAP_TIGHT_S:g}: {n} trees, or not a prefix")
    loose = h2o.GBMEstimator(**dict(FLAGSHIP, max_runtime_secs=CAP_LOOSE_S)
                             ).train(fr, y=Y)
    t_diff = first_split_diff(loose.forest, gbm_forest)
    check(forests_equal(loose.forest, gbm_forest) and all(
        loose.training_metrics[k] == v for k, v in metrics_main.items()),
        "the flagship refit under a loose cap differs from phase 4's: "
        + ("leaves" if t_diff is None else f"splits from tree {t_diff + 1}")
        + f", {[(loose.training_metrics[k], v) for k, v in metrics_main.items()]}")

    def loop_s(cap):
        est = h2o.GBMEstimator(**dict(FLAGSHIP, max_runtime_secs=cap))
        est._cv_shared_bm = loose.bm      # the tree loop alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train(fr, y=Y)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = {0.0: [], CAP_LOOSE_S: []}
    for cap in (0.0, CAP_LOOSE_S, CAP_LOOSE_S, 0.0, 0.0, CAP_LOOSE_S):
        times[cap].append(loop_s(cap))
    free, capped = (float(np.median(times[c])) for c in (0.0, CAP_LOOSE_S))
    say(f"phase17f max_runtime_secs={CAP_LOOSE_S:g}: DRF forest == phase "
        f"6's, laplace GBM (sample_rate {LAPLACE['sample_rate']}, "
        f"col_sample_rate_per_tree {LAPLACE['col_sample_rate_per_tree']}) "
        f"== its uncapped fit; ={CAP_TIGHT_S:g}: the laplace GBM stopped "
        f"after {n} of {LAPLACE['ntrees']} trees, its uncapped fit's "
        f"first {n} bit for bit")
    say(f"phase17f flagship refit under the loose cap: forest and training "
        f"AUC/logloss bit-equal to phase 4's; tree loop alone (median of 3): "
        f"{free:.4f} s uncapped, {capped:.4f} s capped, the device wait "
        f"after each tree {1e3 * (capped - free) / FLAGSHIP['ntrees']:.3f} "
        f"ms a tree (runs: {times})")


def csv_bytes(cols, domains) -> bytes:
    """The columns as CSV text, as bench.py's airlines generator writes
    them (a header; integers in decimal; categoricals, the response
    included, as their level strings), built with vectorised numpy byte
    operations: each column becomes an [n, width] byte matrix whose
    unused (leading) bytes are 0, the matrices and the separators are
    joined side by side, and the zero bytes dropped."""
    names = list(cols)
    n = len(cols[names[0]])
    pieces = []
    for j, nm in enumerate(names):
        v = np.asarray(cols[nm])
        if nm in domains:
            lv = np.array(domains[nm], dtype=bytes)       # zero-padded
            table = np.frombuffer(lv.tobytes(), np.uint8).reshape(
                len(lv), lv.dtype.itemsize)
            pieces.append(table[v])
        else:
            check(v.min() >= 0, f"csv_bytes: {nm} has negative values")
            w = len(str(int(v.max())))
            p10 = 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
            v64 = v.astype(np.int64)[:, None]
            digits = (v64 // p10 % 10 + 48).astype(np.uint8)
            # a digit shows from the leading one on (the units always)
            digits[(v64 < p10) & (p10 > 1)] = 0
            pieces.append(digits)
        sep = b"\n" if j == len(names) - 1 else b","
        pieces.append(np.full((n, 1), sep[0], np.uint8))
    mat = np.concatenate(pieces, axis=1)
    return (",".join(names) + "\n").encode() + mat[mat != 0].tobytes()


def same_frames(a, b) -> bool:
    """Two port frames bit for bit: names, types, domains, device data,
    NA masks, float64 host views."""
    import torch
    if a.names != b.names or a.nrows != b.nrows:
        return False
    for nm in a.names:
        ca, cb = a.col(nm), b.col(nm)
        if (ca.type, ca.domain) != (cb.type, cb.domain) or not (
                torch.equal(ca.data, cb.data)
                and torch.equal(ca.na_mask, cb.na_mask)
                and np.array_equal(ca.host.view(np.int64),
                                   cb.host.view(np.int64))):
            return False
    return True


def check_csv_frame(fr, cols, domains, label: str) -> None:
    """A frame read from ``csv_bytes(cols, domains)`` holds the arrays:
    names in order, types, decoded levels, no NA, float64 host values."""
    check(fr.names == list(cols) and fr.nrows == len(cols[Y]),
          f"{label}: names/rows {fr.names} {fr.nrows}")
    for nm, v in cols.items():
        c = fr.col(nm)
        n = fr.nrows
        check(not bool(c.na_mask[:n].any()), f"{label} {nm}: NA found")
        if nm in domains:
            check(c.is_categorical, f"{label} {nm}: not categorical")
            codes = c.host_view().astype(np.int64)
            got = np.asarray(c.domain, dtype=object)[codes]
            want = np.asarray(domains[nm], dtype=object)[v]
            check(np.array_equal(got, want), f"{label} {nm}: levels")
        else:
            check(c.type == "numeric" and np.array_equal(
                c.host_view(), v.astype(np.float64)), f"{label} {nm}: values")


def recode(cols, domains, fr):
    """The columns with each categorical's codes renumbered into ``fr``'s
    domain of it (and that domain): ``Frame.from_numpy`` of them is the
    same data as ``fr``."""
    out, doms = {}, {}
    for nm, v in cols.items():
        if nm in domains:
            lut = {lvl: i for i, lvl in enumerate(fr.col(nm).domain)}
            remap = np.array([lut[lvl] for lvl in domains[nm]], np.int32)
            out[nm], doms[nm] = remap[v], list(fr.col(nm).domain)
        else:
            out[nm] = v
    return out, doms


def phase_csv(torch, dev, cols, domains):
    """Phase 18: CSV ingest → the flagship GBM at full size. Phase 4's
    rows written as CSV (categoricals as their levels, the response as
    NO/YES); read by ``stream_import_csv`` at the default worker count
    and with ``workers=1`` (bit-identical frames) and by ``import_file``;
    each frame holds the written arrays; the flagship trained on the
    streamed frame launches every level kernel 60 times, and its binning
    and forest equal the fit's on ``Frame.from_numpy`` of the same values
    with the CSV frame's domains. Returns the fit's launches."""
    import tempfile
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.io import chunking
    from h2o3_tpu_torch.io.stream import stream_import_csv
    n = len(cols[Y])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/airlines.csv"
        t0 = time.perf_counter()
        data = csv_bytes(cols, domains)
        with open(path, "wb") as f:
            f.write(data)
        t_write = time.perf_counter() - t0
        mb = len(data) / 1e6
        del data
        say(f"phase18 wrote {n} airlines rows as CSV ({mb:.3f} MB) in "
            f"{t_write:.3f} s")
        frames, secs = {}, {}
        workers = chunking.resolve_workers(None)
        for label, read in (
                (f"stream workers={workers}",
                 lambda: stream_import_csv(path, device=dev)),
                ("stream workers=1",
                 lambda: stream_import_csv(path, workers=1, device=dev)),
                ("import_file", lambda: h2o.import_file(path, device=dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames[label] = read()
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
    par, seq, eager = frames.values()
    check(same_frames(par, seq), "stream_import_csv: the parallel frame "
                                 "differs from the sequential one")
    for label, fr in frames.items():
        check_csv_frame(fr, cols, domains, label)
    say("phase18 ingest: " + "; ".join(
        f"{label} {secs[label]:.3f} s, {mb / secs[label]:.6g} MB/s, "
        f"{n / secs[label]:.6g} rows/s" for label in frames)
        + f"; parallel frame == sequential frame bit for bit; every frame "
        f"== the written arrays")
    del seq, eager, frames
    x = [c for c in cols if c != Y]
    model, t_train, counts, _ = timed_fit(
        torch, lambda: h2o.GBMEstimator(**FLAGSHIP).train(par, y=Y, x=x))
    check_launches(counts, {k: FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
                            for k in LEVEL_KERNELS}, "GBM on the CSV frame")
    rcols, rdoms = recode(cols, domains, par)
    fr_np = h2o.Frame.from_numpy(rcols, domains=rdoms, device=dev)
    ref = h2o.GBMEstimator(**FLAGSHIP).train(fr_np, y=Y, x=x)
    for f in ("bins", "edges", "nbins", "is_cat"):
        a, b = getattr(model.bm, f), getattr(ref.bm, f)
        check(torch.equal(torch.as_tensor(a), torch.as_tensor(b)),
              f"bin_frame of the CSV frame differs in {f}")
    check(forests_equal(model.forest, ref.forest) and all(
        model.training_metrics[k] == ref.training_metrics[k]
        for k in ("AUC", "logloss")),
        "the GBM on the CSV frame differs from the from_numpy fit")
    say(f"phase18 GBM {FLAGSHIP} on the streamed CSV frame: train "
        f"{t_train:.3f} s, AUC {model.training_metrics['AUC']:.6f}; "
        "bin_frame and forest bit-equal to the fit on Frame.from_numpy "
        "of the same values")
    say(f"phase18 launches: {counts}")
    return counts


# ------------------------------------------- phases 19-21 (slice 9)


def phase_xgboost_histogram_types(torch, dev, fr, cols, domains,
                                  gbm_forest):
    """Phase 19 on phase 4's frame: the XGBoost facade with phase 4's
    settings in h2o-py's names (forest bit-equal to phase 4's GBM, 60
    launches a level kernel), a second fit with ``reg_lambda`` and
    ``gamma`` set; DRF at phase 6's settings with ``histogram_type``
    UniformAdaptive and Random: edges and bins EXACT against the CPU plain
    binning of the same rows, 100 launches a level kernel, OOB AUC, and
    on a 20K-row sample without bagging or column sampling the card
    forest EXACTLY the CPU plain forest. Returns the launches by path."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.models.drf import edge_method
    paths = {}
    x = [c for c in cols if c != Y]
    for label, kw in (("xgboost", XGB), ("xgboost_reg", XGB_REG)):
        model, t_train, counts, peak = timed_fit(
            torch, lambda: h2o.XGBoostEstimator(**kw).train(fr, y=Y))
        check_launches(counts, {k: XGB["nrounds"] * XGB["max_depth"]
                                for k in LEVEL_KERNELS}, label)
        check(model.output["facade"] == "xgboost", "facade output")
        auc = model.training_metrics["AUC"]
        check(np.isfinite(auc) and auc > 0.7, f"{label} AUC {auc}")
        same = forests_equal(model.forest, gbm_forest)
        if label == "xgboost":
            check(same, "the XGBoost forest differs from phase 4's GBM")
        say(f"phase19 {label} {kw} on {N_MAIN} rows: train {t_train:.3f} s, "
            f"AUC {auc:.6f}, forest == phase 4's GBM forest: {same}, peak "
            f"device memory {peak / 2**30:.3f} GiB")
        paths[label] = counts
    fr_cpu = h2o.Frame.from_numpy(cols, domains=domains, device="cpu")
    small = {k: v[:N_SAMPLE] for k, v in cols.items()}
    for ht in HISTOGRAM_TYPES:
        model, t_train, counts, peak = timed_fit(
            torch, lambda: h2o.DRFEstimator(**DRF, histogram_type=ht).train(
                fr, y=Y))
        check_launches(counts, {k: DRF["ntrees"] * DRF["max_depth"]
                                for k in LEVEL_KERNELS}, f"DRF {ht}")
        ref = bin_frame(fr_cpu, x, nbins=20, nbins_cats=1024,
                        histogram_type=edge_method(ht))
        for f in ("edges", "nbins", "bins"):
            check(torch.equal(getattr(model.bm, f).cpu(), getattr(ref, f)),
                  f"DRF {ht}: {f} differ from the CPU plain binning")
        auc = model.training_metrics["AUC"]
        check(np.isfinite(auc) and auc > 0.7, f"DRF {ht} OOB AUC {auc}")
        m_gpu, m_cpu = card_and_cpu(
            lambda: h2o.DRFEstimator(**DRF, histogram_type=ht,
                                     sample_rate=1.0, mtries=len(x)),
            small, domains, dev, y=Y)
        equal_trees(on_cpu(m_gpu.forest), m_cpu.forest,
                    f"{N_SAMPLE}-row DRF {ht}, card vs CPU plain")
        say(f"phase19 DRF {DRF} histogram_type={ht} on {N_MAIN} rows: "
            f"train {t_train:.3f} s, OOB AUC {auc:.6f}, peak device memory "
            f"{peak / 2**30:.3f} GiB; edges, nbins and bins == the CPU "
            f"plain binning; {N_SAMPLE}-row unbagged forest (mtries="
            f"{len(x)}) card == CPU plain, EXACT "
            f"({int(m_gpu.forest.is_split.sum())} splits)")
        say(f"phase19 DRF {ht} launches: {counts}")
        paths[f"drf_{edge_method(ht)}"] = counts
    return paths


def planted_anomalies(cols, seed: int = 20):
    """Phase 4's rows with N_PLANT of them moved far out of the airlines
    ranges (Distance 9000-12000, DepTime and CRSDepTime 2600-2999):
    (columns, is_anomaly)."""
    r = np.random.RandomState(seed)
    n = len(cols[Y])
    out = {k: v.copy() for k, v in cols.items()}
    idx = r.choice(n, N_PLANT, replace=False)
    out["Distance"][idx] = r.randint(9000, 12000, N_PLANT)
    out["DepTime"][idx] = r.randint(2600, 3000, N_PLANT)
    out["CRSDepTime"][idx] = r.randint(2600, 3000, N_PLANT)
    bad = np.zeros(n, bool)
    bad[idx] = True
    return out, bad


def isofor_partition_timing(torch, bm, tree, counts):
    """``tree_partition`` at the Isolation Forest levels d=0..D-1 (L up to
    128, B = 65) of one grown tree over every row: EXACT against the plain
    version, timed as phase 5 times it. Returns its kernels record."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    bins, B = bm.bins, bm.nbins_total
    N, F = bins.shape
    dev = bins.device
    D = tree.feat.shape[0]
    acc = timing_acc()
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    for d in range(D):
        L = 2 ** d
        dec = (tree.feat[d, :L], tree.thresh[d, :L], tree.na_left[d, :L],
               tree.is_split[d, :L],
               torch.zeros(L, dtype=torch.bool, device=dev),
               torch.zeros((L, B - 1), dtype=torch.bool, device=dev))
        want = tk.partition_plain(bins, nid, *dec, n_bins=B)
        got = tk.tree_partition(bins, nid, *dec, n_bins=B)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"tree_partition isofor d={d}")
        t = time_ms(torch, lambda: tk.tree_partition(bins, nid, *dec,
                                                     n_bins=B))
        add_time(acc, t)
        acc["plain_ms"] += time_ms(torch, lambda: tk.partition_plain(
            bins, nid, *dec, n_bins=B), reps=3)["ms"]
        acc["bytes_ms"] += (N * (F * bins.element_size() + 8)
                            + L * (B + 12)) / HBM_BYTES_PER_S * 1e3
        acc["ops_ms"] += 4 * N / F32_OPS_PER_S * 1e3
        nid = want
    return timing_records({"tree_partition": acc}, counts, N,
                          "phase20 timing", "isofor", range(D))[0]


def phase_isolation_forests(torch, dev, cols, domains):
    """Phase 20 on phase 4's rows with N_PLANT anomalies planted:
    Isolation Forest at its defaults (ntrees=50, sample_size=256,
    max_depth=8): one tree grown from fixed draws on the card equal to
    the CPU plain version's (and the rows' path lengths), ``tree_partition``
    launched ntrees x depth times growing and as many again for the
    training metrics and for ``predict``, the planted rows scoring above
    the rest (AUC >= 0.95), a same-seed refit bit-equal; Extended
    Isolation Forest at its defaults (ntrees=100, sample_size=256) on the
    7 numeric columns with extension_level 0 and 6 (no kernel). Returns
    (launches by path, the tree_partition timing record)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.models import isofor
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.ops import kernels
    pcols, bad = planted_anomalies(cols)
    x = [c for c in cols if c != Y]
    fr = h2o.Frame.from_numpy(pcols, domains=domains, device=dev)
    n = len(bad)
    depth = h2o.IsolationForestEstimator.DEFAULTS["max_depth"]
    ntrees = h2o.IsolationForestEstimator.DEFAULTS["ntrees"]
    # (a) growth from fixed draws: card vs CPU plain
    bm = bin_frame(fr, x, nbins=64, nbins_cats=64, histogram_type="uniform")
    check(bm.nbins_total == 65, f"isofor B {bm.nbins_total}")
    gen = tree_generator(1, 0, dev)
    w = fr.valid_weights() * (torch.rand(bm.bins.shape[0], generator=gen,
                                         device=dev) < 256 / n).float()
    dr = isofor.draw_tree(gen, bm.nbins, depth, dev)
    t_card = isofor.grow_isolation_tree(bm.bins, w, dr["feat"],
                                        dr["thresh"], dr["na_left"], B=65)
    pl_card = isofor.tree_path_length(t_card, bm.bins, 65)
    bins_cpu = bm.bins.cpu()
    t_cpu = isofor.grow_isolation_tree(bins_cpu, w.cpu(),
                                       *(dr[k].cpu() for k in (
                                           "feat", "thresh", "na_left")),
                                       B=65)
    equal_trees(on_cpu(t_card), t_cpu, "isolation tree from fixed draws")
    check(torch.equal(pl_card.cpu(), isofor.tree_path_length(
        t_cpu, bins_cpu, 65)), "isolation path lengths card vs CPU plain")
    say(f"phase20 isolation tree (depth {depth}, {int(w.sum())}-row bag) "
        f"from fixed draws: card == CPU plain, field for field "
        f"({int(t_card.is_split.sum())} splits), and every row's path "
        "length")
    # (b) the fit, predict, the planted rows, a refit
    est = lambda: h2o.IsolationForestEstimator(**ISOFOR)  # noqa: E731
    model, t_train, counts, peak = timed_fit(
        torch, lambda: est().train(fr, x=x))
    check_launches(counts, {"tree_partition": 2 * ntrees * depth},
                   "Isolation Forest fit (growth and training metrics)")
    kernels.reset_counts()
    t0 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    counts_pred = dict(kernels.LAUNCHES)
    check_launches(counts_pred, {"tree_partition": ntrees * depth},
                   "Isolation Forest predict")
    score = pred.col("predict").host_view()
    check(np.isfinite(score).all() and score.shape == (n,),
          "Isolation Forest scores")
    auc = host_auc(score, bad)
    check(auc >= 0.95, f"Isolation Forest planted-anomaly AUC {auc}")
    again = est().train(fr, x=x)
    check(forests_equal(again.forest, model.forest)
          and again.training_metrics == model.training_metrics,
          "Isolation Forest same-seed refit differs")
    tm = model.training_metrics
    say(f"phase20 IsolationForest {ISOFOR} (ntrees={ntrees}, sample_size="
        f"256, max_depth={depth}) on {n} rows ({N_PLANT} planted): train "
        f"{t_train:.3f} s, predict {t_pred:.3f} s, planted-anomaly AUC "
        f"{auc:.6f}, mean score {tm['mean_score']:.6f}, mean length "
        f"{tm['mean_length']:.6f}, path length bounds "
        f"[{model.output['min_path_length']}, "
        f"{model.output['max_path_length']}], peak device memory "
        f"{peak / 2**30:.3f} GiB; same-seed refit bit-equal")
    say(f"phase20 launches: fit {counts}, predict {counts_pred}")
    record = isofor_partition_timing(torch, bm, t_card, counts)
    paths = {"isofor": counts, "isofor_predict": counts_pred}
    # (c) Extended Isolation Forest on the numeric columns
    for ext in (0, len(NUMERIC) - 1):
        model, t_train, counts, peak = timed_fit(
            torch, lambda: h2o.ExtendedIsolationForestEstimator(
                **EXTISOFOR, extension_level=ext).train(fr, x=list(NUMERIC)))
        check_launches(counts, {}, f"Extended Isolation Forest ext={ext}")
        t0 = time.perf_counter()
        score = model.predict(fr).col("anomaly_score").host_view()
        torch.cuda.synchronize()
        t_pred = time.perf_counter() - t0
        auc = host_auc(score, bad)
        check(np.isfinite(score).all() and auc >= 0.9,
              f"Extended Isolation Forest ext={ext} AUC {auc}")
        say(f"phase20 ExtendedIsolationForest {EXTISOFOR} extension_level="
            f"{ext} (ntrees=100, sample_size=256) on the {len(NUMERIC)} "
            f"numeric columns: train {t_train:.3f} s, predict {t_pred:.3f} "
            f"s, planted-anomaly AUC {auc:.6f}, peak device memory "
            f"{peak / 2**30:.3f} GiB")
        paths[f"extisofor_{ext}"] = counts
    return paths, record


def cpu_model(model):
    """A shallow copy of a GBM or DRF model with its forest and binning
    on the host (the CPU plain versions score it)."""
    import copy
    import dataclasses
    m = copy.copy(model)
    m.forest = on_cpu(model.forest)
    m.bm = dataclasses.replace(model.bm, bins=model.bm.bins.cpu(),
                               nbins=model.bm.nbins.cpu(),
                               edges=model.bm.edges.cpu(), source_ref=None)
    return m


def host_columns(fr) -> np.ndarray:
    return np.stack([fr.col(c).host_view() for c in fr.names], 1)


def phase_scoring(torch, dev, fr, cols, domains, gbm, drf):
    """Phase 21: the scoring surface of phase 4's GBM and phase 6's DRF.
    Leaf assignment and feature frequencies over all 5M rows, EXACT
    against the CPU plain versions on N_CHECK rows, the leaf values at the
    assigned ids adding up to the margin (GBM) or mean vote (DRF); GBM's
    staged probabilities, the last stage equal to ``predict``; TreeSHAP
    contributions with local accuracy on every row they cover (GBM all
    rows, DRF N_SHAP_DRF: see the printed cut) and within 1e-5·max(1,
    |margin|) of the CPU plain version's. Returns the launches (none: the
    surface is plain torch)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import rebin_for_scoring
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.parallel.device import fetch
    n = len(cols[Y])
    small = h2o.Frame.from_numpy({k: v[:N_CHECK] for k, v in cols.items()},
                                 domains=domains, device="cpu")
    kernels.reset_counts()
    for label, model in (("GBM", gbm), ("DRF", drf)):
        T = model.forest.feat.shape[0]
        bm = rebin_for_scoring(model.bm, fr)
        if label == "GBM":
            margin = fetch(model._margins(bm))[:n]
        else:
            margin = fetch(model._mean_votes(bm)[:, 0])[:n]
        cm = cpu_model(model)
        secs = {}
        outs = {}
        for what in ("predict_leaf_node_assignment", "feature_frequencies"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[what] = getattr(model, what)(fr)
            torch.cuda.synchronize()
            secs[what] = time.perf_counter() - t0
            want = getattr(cm, what)(small)
            check(outs[what].names == want.names and np.array_equal(
                host_columns(outs[what])[:N_CHECK], host_columns(want)),
                f"{label} {what}: card != CPU plain on {N_CHECK} rows")
        ids = host_columns(outs["predict_leaf_node_assignment"]).astype(
            np.int64)
        leaf = model.forest.leaf.cpu().numpy()
        tot = np.zeros(n, np.float32)
        for t in range(T):
            tot = tot + leaf[t][ids[:, t]]
        via_ids = (np.float32(model.f0) + tot if label == "GBM"
                   else tot * np.float32(1.0 / T))
        gap = float(np.abs(via_ids - margin).max())
        check(gap <= 1e-6 * max(1.0, float(np.abs(margin).max())),
              f"{label}: leaf values at the assigned ids miss the margin by "
              f"{gap}")
        ff = host_columns(outs["feature_frequencies"])
        say(f"phase21 {label} on {n} rows: predict_leaf_node_assignment "
            f"{secs['predict_leaf_node_assignment']:.3f} s, "
            f"feature_frequencies {secs['feature_frequencies']:.3f} s, both "
            f"== CPU plain on {N_CHECK} rows; leaf values at the ids add up "
            f"to the {'margin' if label == 'GBM' else 'mean vote'} (max "
            f"|gap| {gap:.3g}); mean splits a row {ff.sum(1).mean():.4f}")
        del outs, ids, ff
        if label == "GBM":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = model.staged_predict_proba(fr)
            torch.cuda.synchronize()
            t_st = time.perf_counter() - t0
            p0 = model.predict(fr).col("p0").host_view()
            check(np.array_equal(st.col(f"T{T}.C1").host_view(), p0),
                  "staged_predict_proba: the last stage != predict")
            say(f"phase21 GBM staged_predict_proba over {T} stages: "
                f"{t_st:.3f} s, the last stage == predict's p0")
            del st
        # contributions
        rows = n if label == "GBM" else N_SHAP_DRF
        sub = fr if rows == n else h2o.Frame.from_numpy(
            {k: v[:rows] for k, v in cols.items()}, domains=domains,
            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        contrib = host_columns(model.predict_contributions(sub))
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tol = 1e-5 * np.maximum(1.0, np.abs(margin[:rows]))
        acc_gap = np.abs(contrib.sum(1) - margin[:rows])
        check((acc_gap <= tol).all(), f"{label} contributions: local "
                                      f"accuracy off by {acc_gap.max()}")
        n_cpu = N_CHECK if label == "GBM" else N_SHAP_DRF_CPU
        t0 = time.perf_counter()
        want = host_columns(cm.predict_contributions(
            h2o.Frame.from_numpy({k: v[:n_cpu] for k, v in cols.items()},
                                 domains=domains, device="cpu")))
        t_cpu = time.perf_counter() - t0
        err = np.abs(contrib[:n_cpu] - want)
        check((err <= tol[:n_cpu, None]).all(),
              f"{label} contributions card vs CPU plain: max |err| "
              f"{err.max()}")
        cut = "" if rows == n else (
            f" (cut from {n} rows: the recursion streams every leaf's "
            f"[rows, path] float32 weights ~90 times a tree, and a depth-"
            f"{model.forest.feat.shape[1]} DRF tree has up to "
            f"{2 ** model.forest.feat.shape[1]} leaves; from 1M to 250000 "
            f"rows since phase 22 came and to {rows} since phase 27 came, "
            f"the CPU head to {n_cpu} rows, to keep the whole run within "
            f"its time limit)")
        say(f"phase21 {label} predict_contributions on {rows} rows{cut}: "
            f"{t_c:.3f} s, peak device memory {peak / 2**30:.3f} GiB, local "
            f"accuracy on every row (max |gap| {acc_gap.max():.3g}); card "
            f"== CPU plain on {n_cpu} rows within 1e-5*max(1, |margin|) "
            f"(max |err| {err.max():.3g}; CPU {t_cpu:.3f} s)")
    counts = dict(kernels.LAUNCHES)
    check_launches(counts, {}, "scoring surface")
    return counts


# ---------------------------------------------------------------- GLM


def higgs_arrays(n: int, p: int = P_HIGGS, seed: int = 3):
    """bench.py's GLM benchmark data (the HIGGS shape): n x p standard
    normal float32 features from RandomState(seed), beta = 0.3·N(0, 1),
    a binomial response drawn from the logistic of X·beta (levels b, s).
    Returns (columns, domains, beta)."""
    r = np.random.RandomState(seed)
    X = r.randn(n, p).astype(np.float32)
    beta = r.randn(p) * 0.3
    yv = (r.rand(n) < 1 / (1 + np.exp(-(X @ beta)))).astype(np.int32)
    cols = {f"x{i}": X[:, i] for i in range(p)}
    cols["y"] = yv
    return cols, {"y": ["b", "s"]}, beta


def glm_metric(model) -> float:
    tm = model.training_metrics
    return tm["MSE"] if tm.kind == "Regression" else tm["logloss"]


def cpu_glm_check(build, cols, domains, y, n, tol, label, dev,
                  metric_tol=None, prob_tol=None, m_card=None):
    """Fit ``build()`` on the first ``n`` rows on the card and on the CPU
    (the plain path): the training logloss (MSE for regression) within
    ``metric_tol`` (GLM_METRIC_TOL) relative, unless ``tol`` is None the
    raw-scale coefficients within ``tol``·max(1, |c|), and unless
    ``prob_tol`` is None the scores (class probabilities or mu) on the
    head within ``prob_tol``; ``m_card``: the card's fit on the head,
    where the caller has it. Returns (card model, CPU model, the largest
    relative coefficient gap, the largest score gap)."""
    import h2o3_tpu_torch as h2o
    head = {k: v[:n] for k, v in cols.items()}
    frs = [h2o.Frame.from_numpy(head, domains=domains, device=d)
           for d in (dev, "cpu")]
    if m_card is None:
        m_card = build().train(frs[0], y=y)
    m_cpu = build().train(frs[1], y=y)
    gap = coef_gap(m_card, m_cpu, label)
    check(tol is None or gap <= tol,
          f"{label}: card vs CPU plain on {n} rows, max relative "
          f"coefficient gap {gap:.3g} > {tol}")
    ma, mb = glm_metric(m_card), glm_metric(m_cpu)
    check(abs(ma - mb) <= (metric_tol or GLM_METRIC_TOL) * abs(mb),
          f"{label}: training metric card {ma} vs CPU plain {mb}")
    p_gap = score_gap(m_card, frs[0], m_cpu, frs[1], n)
    check(prob_tol is None or p_gap <= prob_tol,
          f"{label}: scores card vs CPU plain on {n} rows {p_gap:.3g} > "
          f"{prob_tol}")
    return m_card, m_cpu, gap, p_gap


def coef_gap(a_model, b_model, label) -> float:
    """The largest gap of two GLMs' raw-scale coefficients relative to
    max(1, |c|)."""
    a, b = a_model.coefficients, b_model.coefficients
    check(list(a) == list(b), f"{label}: coefficient names differ")
    return max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in b)


def score_gap(a_model, a_frame, b_model, b_frame, n) -> float:
    """The largest gap of two GLMs' scores over the first ``n`` rows."""
    from h2o3_tpu_torch.parallel.device import fetch
    a = fetch(a_model._score_dev(a_frame))[:n]
    b = fetch(b_model._score_dev(b_frame))[:n]
    return float(np.abs(a - b).max())


def permuted_gaps(build, cols, domains, y, n, dev, base, seed=1):
    """The witness of float32 order: ``build()`` fit on ``dev`` on the
    first ``n`` rows with their order permuted, against ``base`` (the
    same fit on those rows in order). Returns (coefficient gap, score
    gap on the rows in order)."""
    import h2o3_tpu_torch as h2o
    perm = np.random.default_rng(seed).permutation(n)
    m = build().train(h2o.Frame.from_numpy(
        {k: v[:n][perm] for k, v in cols.items()}, domains=domains,
        device=dev), y=y)
    fr = h2o.Frame.from_numpy({k: v[:n] for k, v in cols.items()},
                              domains=domains, device=dev)
    return coef_gap(m, base, "permuted"), score_gap(m, fr, base, fr, n)


def gram_vs_float64(torch, X1, w, z):
    """The card's float32 Gram at (w, z) against float64 on the card:
    max |diff| / Σ|w x x| within GRAM_F32_REL (2^-16), which holds the
    Gram. The worst-case float32 summation bound, (rows a block + blocks)
    ·2^-24 relative, is 6.3e-2 at 1M-row blocks and so far looser: a
    Gram within 2^-16 is within it too, and a TF32 product is not within
    2^-16. Returns (max |diff| / Σ|w x x|, the same for a TF32 product of
    the same rows, for comparison)."""
    from h2o3_tpu_torch.ops.gram import gram
    g32 = gram(X1, w, z)[0].double()
    n = X1.shape[0]
    g64 = torch.zeros_like(g32)
    mass = torch.zeros_like(g32)
    for lo in range(0, n, 1 << 21):
        Xd = X1[lo:lo + (1 << 21)].double()
        wd = w[lo:lo + (1 << 21)].double()
        g64 += (Xd * wd[:, None]).T @ Xd
        mass += (Xd.abs() * wd.abs()[:, None]).T @ Xd.abs()
        del Xd
    diff = (g32 - g64).abs()
    rel = float((diff / mass.clamp_min(1e-30)).max())
    check(rel <= GRAM_F32_REL, f"Gram vs float64: max |diff| / sum|w x x| "
                               f"{rel:.3g} > 2^-16 (a TF32 product?)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g_tf = ((X1 * w[:, None]).T @ X1).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rel, float(((g_tf - g64).abs() / mass.clamp_min(1e-30)).max())


def higgs_frame(dev):
    """bench.py's GLM frame (``higgs_arrays(N_HIGGS)``) on the card:
    (columns, domains, beta, frame). Phases 22(a) and 24(a) share it."""
    import h2o3_tpu_torch as h2o
    t0 = time.perf_counter()
    (cols, domains, beta), t_gen = made_ahead(
        "higgs", lambda: higgs_arrays(N_HIGGS))
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    say(f"phase22a HIGGS shape {N_HIGGS} x {P_HIGGS} float32 made ahead "
        f"(waited {t_gen:.3f} s), on the card in "
        f"{time.perf_counter() - t0 - t_gen:.3f} s")
    return cols, domains, beta, fr


def phase_glm_higgs(torch, dev, higgs):
    """Phase 22(a): bench.py's GLM benchmark at its shape, nothing cut:
    binomial on 11M x 28 (standardize, lambda 0), IRLSM with 8 iterations
    and L-BFGS with 40, on ``higgs_frame``'s data. Returns the launches
    of each fit's path."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    from h2o3_tpu_torch.models import glm as glm_mod
    from h2o3_tpu_torch.ops.gram import gram
    cols, domains, beta, fr = higgs
    x = [c for c in cols if c != "y"]
    paths, models = {}, {}
    for solver, iters in HIGGS_FITS:
        params = dict(HIGGS_GLM, solver=solver, max_iterations=iters)
        model, secs, counts, peak = timed_fit(
            torch, lambda: h2o.GLMEstimator(**params).train(fr, y="y"))
        check_launches(counts, {}, f"GLM {solver}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        refit = h2o.GLMEstimator(**params).train(fr, y="y")
        torch.cuda.synchronize()
        t_re = time.perf_counter() - t1
        tm = model.training_metrics
        check(np.array_equal(refit.coef, model.coef)
              and refit.training_metrics["AUC"] == tm["AUC"]
              and refit.training_metrics["logloss"] == tm["logloss"],
              f"GLM {solver}: the refit is not bit-equal")
        check(np.isfinite(model.coef).all(), f"GLM {solver}: coefficients")
        models[solver] = model
        paths[f"glm_{solver.replace('l_bfgs', 'lbfgs')}"] = counts
        say(f"phase22a GLM binomial {solver.upper()} max_iterations={iters} "
            f"on {N_HIGGS} x {P_HIGGS}: train {secs:.3f} s (refit "
            f"{t_re:.3f} s, bit-equal), {N_HIGGS * iters / secs:.6g} "
            f"row-iterations/s ({N_HIGGS * iters / t_re:.6g} refit), AUC "
            f"{tm['AUC']:.6f}, logloss {tm['logloss']:.6f}, peak device "
            f"memory {peak / 2**30:.3f} GiB; launches {counts}")
    irls, lb = models["irlsm"], models["l_bfgs"]
    raw = irls.coefficients
    want = dict({f"x{i}": float(b) for i, b in enumerate(beta)},
                Intercept=0.0)
    err = max(abs(raw[k] - want[k]) for k in want)
    check(err <= 0.02, f"IRLSM coefficients miss the generating beta by "
                       f"{err}")
    d_auc = abs(lb.training_metrics["AUC"] - irls.training_metrics["AUC"])
    check(d_auc <= 1e-3, f"L-BFGS AUC {lb.training_metrics['AUC']} vs "
                         f"IRLSM {irls.training_metrics['AUC']}")
    # the Gram at the IRLSM fit's coefficients, against float64; one
    # Gram pass and one IRLS iteration timed
    di = build_datainfo(fr, x, standardize=True)
    X1 = di.X1
    y = torch.from_numpy(cols["y"].astype(np.float32)).to(dev)
    w = fr.valid_weights()
    off = torch.zeros_like(w)
    coef = torch.from_numpy(irls.coef.astype(np.float32)).to(dev)
    _, z, w_irls = glm_mod._working(irls.family, X1, coef, y, w, off)
    rel32, rel_tf32 = gram_vs_float64(torch, X1, w_irls, z)
    t_gram = time_ms(torch, lambda: gram(X1, w_irls, z), reps=5)
    n, P1 = X1.shape
    b_bytes = (n * P1 + 2 * n) * 4 / HBM_BYTES_PER_S * 1e3
    b_ops = 2.0 * n * P1 * P1 / F32_OPS_PER_S * 1e3
    it_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        glm_mod._irls_solve(X1, coef, y, w, off, glm_mod._f32(0.0, dev),
                            glm_mod._f32(0.0, dev), 0.0, 1, irls.family,
                            0.0, use_l1=False)
        torch.cuda.synchronize()
        it_s.append(time.perf_counter() - t1)
    say(f"phase22a IRLSM de-standardized coefficients within {err:.4g} of "
        f"the generating beta (<= 0.02); L-BFGS AUC within {d_auc:.3g} of "
        f"IRLSM's (<= 1e-3); Gram at the fit vs float64: max |diff| / "
        f"sum|w x x| {rel32:.3g} (<= 2^-16, inside the float32 bound; a TF32 "
        f"product of the same rows {rel_tf32:.3g}); one Gram pass "
        f"{t_gram['ms']:.4f}"
        f" ms device (bound {max(b_bytes, b_ops):.4f} ms: bytes "
        f"{b_bytes:.4f}, float32 operations {b_ops:.4f}); one IRLS "
        f"iteration (Gram, Cholesky, the 9-step line search, one sync) "
        f"{min(it_s) * 1e3:.3f} ms wall")
    del X1, di, z, w_irls
    # the first rows: card vs CPU plain
    for solver, iters in HIGGS_FITS:
        tol = GLM_TOL if solver == "irlsm" else GLM_LBFGS_TOL
        params = dict(HIGGS_GLM, solver=solver, max_iterations=iters)
        t1 = time.perf_counter()
        m_card, m_cpu, gap, _ = cpu_glm_check(
            lambda: h2o.GLMEstimator(**params), cols, domains, "y",
            N_HIGGS_CPU, tol, f"GLM {solver}", dev)
        d = abs(m_card.training_metrics["AUC"] - m_cpu.training_metrics["AUC"])
        check(d <= 1e-5, f"GLM {solver} {N_HIGGS_CPU} rows: AUC card vs "
                         f"CPU {d}")
        say(f"phase22a {solver.upper()} on the first {N_HIGGS_CPU} rows: "
            f"card vs CPU plain max relative coefficient gap {gap:.3g} "
            f"(<= {tol}), |d AUC| {d:.3g} ({time.perf_counter() - t1:.3f} "
            f"s for both fits)")
    return paths


def phase_glm_enet(torch, dev, cols, domains, delay):
    """Phase 22(b): elastic net with lambda search (alpha 0.5, 30
    lambdas) on the first N_ENET airlines rows, the gaussian response
    ``airlines_delay``, the one-hot width P = 263; coefficients against
    the CPU plain fit on an N_ENET_CPU-row head. Returns the launches."""
    import h2o3_tpu_torch as h2o
    ecols = {k: v[:N_ENET] for k, v in cols.items() if k != Y}
    ecols["delay"] = delay[:N_ENET]
    edoms = {k: v for k, v in domains.items() if k != Y}
    fr = h2o.Frame.from_numpy(ecols, domains=edoms, device=dev)
    model, secs, counts, peak = timed_fit(
        torch, lambda: h2o.GLMEstimator(**ENET).train(fr, y="delay"))
    check_launches(counts, {}, "GLM lambda search")
    P1 = len(model.output["coef_names"]) + 1
    check(P1 == P_AIRLINES, f"airlines one-hot width {P1}")
    check(len(model._lambda_path_vals) == ENET["nlambdas"], "path length")
    nnz = int((np.abs(model.coef[:-1]) > 0).sum())
    r2 = model.training_metrics["r2"]
    check(np.isfinite(model.coef).all() and 0.0 < r2 < 1.0, f"R2 {r2}")
    t1 = time.perf_counter()
    _, _, gap, _ = cpu_glm_check(lambda: h2o.GLMEstimator(**ENET), ecols,
                              edoms, "delay", N_ENET_CPU, GLM_ADMM_TOL,
                              "GLM lambda search", dev)
    say(f"phase22b GLM gaussian elastic net (alpha 0.5, lambda search) on "
        f"{N_ENET} airlines rows, P = {P1}: train {secs:.3f} s, path "
        f"{len(model._lambda_path_vals)} lambdas, lambda_best "
        f"{model.output['lambda_best']:.6g}, {nnz} nonzero coefficients of "
        f"{P1 - 1}, R2 {r2:.6f}, peak {peak / 2**30:.3f} GiB; "
        f"{N_ENET_CPU}-row head card vs CPU plain max relative coefficient "
        f"gap {gap:.3g} (<= {GLM_ADMM_TOL}; {time.perf_counter() - t1:.3f} "
        f"s); launches {counts}")
    return counts


def margins_agree(model, fr_card, fr_cpu, n, label):
    """The class margins X1·B of ``model`` on the card and on the CPU (the
    plain path) over the first ``n`` rows: within twice the float32 dot
    bound P·u·Σ|x b| a row and class."""
    from h2o3_tpu_torch.parallel.device import fetch
    X1 = model._design(fr_cpu)[:n]
    got = fetch(model._eta(fr_card))[:n]
    want = model._eta(fr_cpu)[:n].numpy()
    B = np.abs(np.asarray(model.coef_multinomial, np.float64))
    tol = 2.0 * X1.shape[1] * 2.0 ** -24 * (np.abs(X1.numpy()) @ B)
    diff = np.abs(got - want)
    check((diff <= tol).all(), f"{label}: margins card vs CPU beyond the "
                               f"float32 bound (max {diff.max()})")
    return float((diff / np.maximum(tol, 1e-30)).max())


def phase_glm_multinomial(torch, dev, ccols, cdomains):
    """Phase 22(c): multinomial GLM on phase 13's Covertype frame (K = 7),
    solver auto (IRLSM at this width), then L-BFGS for comparison; the
    IRLSM model's margins on N_CHECK rows on the card against the CPU
    plain path; the L-BFGS fit against the CPU plain fit on an
    N_CHECK-row head, beside the same fit with the head's rows permuted
    on either device. Returns the launches of the IRLSM fit."""
    import h2o3_tpu_torch as h2o
    y = "Cover_Type"
    fr = h2o.Frame.from_numpy(ccols, domains=cdomains, device=dev)
    model, secs, counts, peak = timed_fit(
        torch, lambda: h2o.GLMEstimator(**MULTI_GLM).train(fr, y=y))
    check_launches(counts, {}, "GLM multinomial")
    check(model.coef_multinomial.shape == (len(ccols), len(COVTYPE_COUNTS)),
          f"multinomial coefficients {model.coef_multinomial.shape}")
    small = {k: v[:N_CHECK] for k, v in ccols.items()}
    fr_cpu = h2o.Frame.from_numpy(small, domains=cdomains, device="cpu")
    rel = margins_agree(model, fr, fr_cpu, N_CHECK, "multinomial")
    lb, s_lb, c_lb, _ = timed_fit(torch, lambda: h2o.GLMEstimator(
        **dict(MULTI_GLM, solver="l_bfgs")).train(fr, y=y))
    check_launches(c_lb, {}, "GLM multinomial L-BFGS")
    # 50 L-BFGS iterations stop short of the optimum of 385 parameters
    # (the one-hot groups Wilderness_Area and Soil_Type each add up to
    # the intercept), so float32 order alone moves the iterates: the
    # same head fit with its rows permuted, on the CPU and on the card,
    # is the witness printed beside the card-vs-CPU gaps, which are held
    # at GLM_MULTI_LBFGS_TOL (coefficients and probabilities) and
    # GLM_LBFGS_METRIC_TOL (training logloss)
    def build():
        return h2o.GLMEstimator(**dict(MULTI_GLM, solver="l_bfgs"))
    m_card, m_cpu, gap, p_gap = cpu_glm_check(
        build, ccols, cdomains, y, N_CHECK, GLM_MULTI_LBFGS_TOL,
        "GLM multinomial L-BFGS", dev, metric_tol=GLM_LBFGS_METRIC_TOL,
        prob_tol=GLM_MULTI_LBFGS_TOL)
    wit = {d: permuted_gaps(build, ccols, cdomains, y, N_CHECK, d, m)
           for d, m in (("cpu", m_cpu), (dev, m_card))}
    ll, ll_lb = (m.training_metrics["logloss"] for m in (model, lb))
    bmax = float(np.abs(model.coef_multinomial).max())
    check(np.isfinite(ll_lb) and ll_lb < np.log(7), f"L-BFGS logloss {ll_lb}")
    say(f"phase22c GLM multinomial on {N_COVTYPE} Covertype rows (K = 7, "
        f"P = {len(ccols)}): IRLSM (auto) train {secs:.3f} s, logloss "
        f"{ll:.6f}, max |coefficient| {bmax:.6g} (the block IRLS takes "
        f"full Newton steps and diverges here, as the reference's does; "
        f"converged multinomial IRLSM fits are held in 22(d)), peak "
        f"{peak / 2**30:.3f} GiB; margins on {N_CHECK} rows "
        f"card vs CPU plain within {rel:.3g} of the float32 bound; L-BFGS "
        f"train {s_lb:.3f} s, logloss {ll_lb:.6f}; {N_CHECK}-row head card "
        f"vs CPU plain: coefficients {gap:.3g} and probabilities "
        f"{p_gap:.3g} apart (<= {GLM_MULTI_LBFGS_TOL}), training logloss "
        f"within {GLM_LBFGS_METRIC_TOL} relative; witness, the head's rows "
        f"permuted: CPU coefficients {wit['cpu'][0]:.3g} and probabilities "
        f"{wit['cpu'][1]:.3g}, card {wit[dev][0]:.3g} and {wit[dev][1]:.3g}"
        f"; launches {counts}")
    return counts


def phase_glm_surface(torch, dev, cols, domains, delay):
    """Phase 22(d): the rest of the surface on N_SURFACE airlines rows:
    ``non_negative`` and ``beta_constraints`` (COD, its time an IRLS
    iteration at P = 263), p-values (gaussian, binomial), an ordinal
    fit, two multinomial IRLSM fits (ridge, L1), two interaction fits,
    3-fold CV with lambda search; each against
    the CPU plain fit on an N_SURFACE_CPU-row head. Returns the launches
    over all of them."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    from h2o3_tpu_torch.models import glm as glm_mod
    from h2o3_tpu_torch.ops import kernels
    n = N_SURFACE
    scols = {k: v[:n] for k, v in cols.items()}
    scols["delay"] = delay[:n]
    scols["late"] = np.digitize(delay[:n], [0.0, 15.0]).astype(np.int32)
    sdoms = dict(domains, late=["l0_early", "l1_ontime", "l2_late"])
    x = [c for c in cols if c != Y]
    fr = h2o.Frame.from_numpy(scols, domains=sdoms, device=dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    lines = []
    for label, y, tol, params in SURFACE_FITS:
        def build(params=params, y=y):
            drop = [c for c in ("delay", "late", Y) if c != y]
            return h2o.GLMEstimator(**dict(params, ignored_columns=drop))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model = build().train(fr, y=y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        multi = params["family"] == "multinomial"
        _, m_cpu, gap, p_gap = cpu_glm_check(
            build, scols, sdoms, y, N_SURFACE_CPU, tol, f"GLM {label}", dev,
            prob_tol=GLM_PROB_TOL if multi else None,
            m_card=model if n == N_SURFACE_CPU else None)
        extra = ""
        c = model.coefficients
        if label == "cod non_negative":
            check(min(v for k, v in c.items() if k != "Intercept") >= 0.0,
                  "non_negative: a negative coefficient")
        if label == "cod beta_constraints":
            # the bounds hold in the standardized design's space
            cm = dict(zip(model.output["coef_names"], model.coef))
            for k, (lo, hi) in params["beta_constraints"].items():
                check(lo <= cm[k] <= hi, f"{k} = {cm[k]} out of [{lo}, "
                                         f"{hi}]")
            extra = ", bounds binding: " + ", ".join(
                f"{k} {cm[k]:.6g}" for k in params["beta_constraints"])
        if "p-values" in label:
            tab = model.output["coefficients_table"]
            pv = np.array([r["p_value"] for r in tab])
            check(np.isfinite(pv).all() and (pv >= 0).all() and
                  (pv <= 1).all(), f"{label}: p-values")
            extra = f", {int((pv < 0.05).sum())} of {len(pv)} p < 0.05"
        if label == "cv lambda search":
            cvm = model.cross_validation_metrics
            check(np.isfinite(cvm["MSE"]) and len(model._cv_models) == 3,
                  "CV metrics")
            extra = (f", CV MSE {cvm['MSE']:.6g}, lambda_best "
                     f"{model.output['lambda_best']:.6g}")
        if label == "ordinal":
            extra = f", logloss {model.training_metrics['logloss']:.6f}"
        if multi:
            ll = model.training_metrics["logloss"]
            check(ll < np.log(3), f"{label}: logloss {ll} (diverged)")
            extra = (f", probabilities {p_gap:.3g} <= {GLM_PROB_TOL}, "
                     f"logloss {ll:.6f}")
        lines.append(f"{label} {secs:.3f} s (head: coefficient gap "
                     f"{gap:.3g}{'' if tol is None else f' <= {tol}'}"
                     f"{extra})")
    counts = dict(kernels.LAUNCHES)
    check_launches(counts, {}, "GLM surface")
    # one COD and one ADMM IRLS iteration at the airlines one-hot width
    di = build_datainfo(fr, x, standardize=True)
    X1 = di.X1
    check(X1.shape[1] == P_AIRLINES, f"one-hot width {X1.shape[1]}")
    yv = torch.from_numpy(scols["delay"].astype(np.float32)).to(dev)
    w = fr.valid_weights()
    off = torch.zeros_like(w)
    fam = glm_mod.Family("gaussian")
    coef = torch.zeros(X1.shape[1], device=dev)
    f32 = glm_mod._f32
    secs = {}
    for what, fn in (
            ("cod", lambda: glm_mod._irls_iter_cod(
                X1, coef, yv, w, off, f32(0.0, dev), f32(0.0, dev), None,
                None, fam)),
            ("admm", lambda: glm_mod._irls_iter(
                X1, coef, yv, w, off, f32(0.05, dev), f32(0.05, dev), fam,
                use_l1=True))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t1
    say(f"phase22d GLM surface on {n} airlines rows (P = {X1.shape[1]}; "
        f"cut from 100000 rows when phase 27 came, for the run's time: "
        f"its solvers are host-paced, a fit takes as long on the head) in "
        f"{time.perf_counter() - t0:.3f} s: " + "; ".join(lines))
    say(f"phase22d one IRLS iteration at P = {X1.shape[1]} on {n} rows: COD "
        f"({glm_mod.COD_SWEEPS} sweeps x {X1.shape[1]} coordinates in plain "
        f"torch) {secs['cod']:.3f} s, ADMM (lambda 0.05, alpha 0.5) "
        f"{secs['admm'] * 1e3:.3f} ms (wall, host-paced loops)")
    return counts


def phase_glm(torch, dev, cols, domains, delay, ccols, cdomains, higgs):
    """Phase 22: GLM (22(a) on ``higgs_frame``'s data). Returns the
    launches of its five paths (every kernel 0 on each)."""
    t0 = time.perf_counter()
    paths = phase_glm_higgs(torch, dev, higgs)
    secs = {"a": time.perf_counter() - t0}
    paths["glm_lambda_search"] = phase_glm_enet(torch, dev, cols, domains,
                                                delay)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    paths["glm_multinomial"] = phase_glm_multinomial(torch, dev, ccols,
                                                     cdomains)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    paths["glm_surface"] = phase_glm_surface(torch, dev, cols, domains,
                                             delay)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    for p, c in paths.items():
        check(not any(c.values()), f"{p}: a kernel launched")
    say("phase22: " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s; every kernel 0 launches "
        f"on {', '.join(paths)}")
    return paths


def mnist_shape_arrays(n: int, seed: int = 5):
    """bench.py's DL frame: ``n`` x 784 pixels rand > 0.8 as float32 and
    a 10-class label, from RandomState(seed) in bench.py's order (drawn a
    row block at a time: the same stream as one ``rand(n, 784)``)."""
    r = np.random.RandomState(seed)
    X = np.empty((n, P_DL), np.float32)
    for lo in range(0, n, 1 << 16):
        hi = min(n, lo + (1 << 16))
        X[lo:hi] = r.rand(hi - lo, P_DL) > 0.8
    cols = {f"p{i}": X[:, i] for i in range(P_DL)}
    cols["label"] = r.randint(0, 10, n)
    return cols, {"label": [str(k) for k in range(10)]}


def same_net(a, b) -> bool:
    import torch
    return all(torch.equal(x[k].cpu(), y[k].cpu())
               for x, y in zip(a.net, b.net) for k in ("W", "b"))


def net_gap(a, b) -> float:
    """The largest weight gap of two nets relative to max(1, max|W|)."""
    from h2o3_tpu_torch.parallel.device import fetch
    A = [{k: fetch(l[k]).astype(np.float64) for k in ("W", "b")} for l in a]
    B = [{k: fetch(l[k]).astype(np.float64) for k in ("W", "b")} for l in b]
    scale = max(1.0, max(np.abs(l["W"]).max() for l in B))
    return max(np.abs(x[k] - y[k]).max() for x, y in zip(A, B)
               for k in ("W", "b")) / scale


def dl_scores(model, fr) -> np.ndarray:
    """A DL model's scores: class probabilities, the prediction, or the
    reconstruction error, [rows, columns]."""
    cols = model._score_raw(fr)
    keys = [k for k in cols if k != "predict"] or ["predict"]
    return np.stack([np.asarray(cols[k], np.float64) for k in keys], 1)


def dl_card_vs_cpu(build, cols, domains, y, dev, label, x=None,
                   **train_kw) -> dict:
    """``build()`` fit on ``cols`` on the card and on the CPU (the plain
    path, the same initial weights), held as the comment at DL_STEP_TOL
    says. Returns the verdict (``ok``, and ``why`` lists what failed)
    and the readings: the card and CPU models, the card's frame,
    ``dl_replay``'s, the replayed fits' weight and score gaps (``whole``:
    whether they were held), the estimator fits' (each on its own
    design; printed, not held), and the card net's scores on the card
    against the CPU."""
    import copy
    import h2o3_tpu_torch as h2o
    frs = [h2o.Frame.from_numpy(cols, domains=domains, device=d)
           for d in (dev, "cpu")]
    m_card, m_cpu = (build().train(fr, y=y, x=x, **train_kw) for fr in frs)
    rep = dl_replay(build(), frs, m_card.features, y, m_card._steps_trained)
    twin = copy.copy(m_card)
    twin.net = rep["cpu_net"]
    # scores relative to max(1, max|score|): probabilities as they are,
    # a regression's predictions on their own scale; scoring designs
    # take the card model's statistics, so both devices score the same
    # inputs
    sc, sp = dl_scores(m_card, frs[0]), dl_scores(m_cpu, frs[1])
    scale = max(1.0, float(np.abs(sp).max()))

    def gap_of(s):
        return float(np.abs(sc - s).max()) / scale
    ma, mb = m_card.training_metrics["MSE"], m_cpu.training_metrics["MSE"]
    res = dict(rep, m_card=m_card, m_cpu=m_cpu, fr=frs[0],
               gap=net_gap(m_card.net, rep["cpu_net"]),
               p_gap=gap_of(dl_scores(twin, frs[1])),
               own_gap=net_gap(m_card.net, m_cpu.net), own_p_gap=gap_of(sp),
               score_gap=gap_of(dl_scores(m_card, frs[1])),
               mse_gap=abs(ma - mb) / max(abs(mb), 1e-3))
    why = list(rep["why"])
    if not all(same_layer(u, v) for u, v in zip(m_card.net, rep["net"])):
        why.append("the step-by-step replay is not the card's fit")
    if res["score_gap"] > DL_SCORE_TOL:
        why.append(f"the card's scores {res['score_gap']:.3g} from the "
                   f"CPU's on the same net (<= {DL_SCORE_TOL})")
    res["whole"] = not rep["flips"] and m_card.output["bf16"] is None
    if res["whole"] and (res["gap"] > DL_TOL or res["p_gap"] > DL_PROB_TOL):
        why.append(f"no flip, and the fits part: weights {res['gap']:.3g} "
                   f"(<= {DL_TOL}), scores {res['p_gap']:.3g} (<= "
                   f"{DL_PROB_TOL})")
    res.update(ok=not why, why=why, label=label)
    return res


def dl_report(res) -> str:
    """One line of ``dl_card_vs_cpu``'s readings."""
    fl = res["flips"]
    return (f"card vs CPU plain: {res['steps']} steps each held from the "
            f"card's state, {res['held']:.3g} (<= {res['step_tol']}), "
            f"pre-activations within {res['z_ratio']:.3g} of their float32 "
            f"bound, {len(fl)} flip steps"
            + (f" {[f[:2] for f in fl]} (first: step {fl[0][0]}, "
               f"{fl[0][2]})" if fl else "")
            + f"; replayed fits: weights {res['gap']:.3g}, scores "
            f"{res['p_gap']:.3g}" + (" (held)" if res["whole"] else
                                     " (not held: a flip)" if fl else
                                     " (not held: bf16)")
            + f"; the estimator's fits (own designs): weights "
            f"{res['own_gap']:.3g}, scores {res['own_p_gap']:.3g}, training "
            f"MSE {res['mse_gap']:.3g} relative; the card net's scores on "
            f"the CPU {res['score_gap']:.3g}")


def dl_check(res) -> None:
    say(f"{res['label']}: {dl_report(res)}")
    check(res["ok"], f"{res['label']}: {res['why']}")


def dl_control(res, what: str) -> None:
    """A control fit (``dl_card_vs_cpu`` with the card's products broken
    on purpose) must come out as not correct."""
    say(f"{res['label']} control ({what}): {dl_report(res)}; caught by "
        f"{res['why']}")
    check(not res["ok"], f"{res['label']}: the control ({what}) passed")


def same_layer(a, b) -> bool:
    import torch
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in ("W", "b"))


def dl_replay(est, frs, x, y, steps: int) -> dict:
    """Each of the first ``steps`` steps of ``est``'s fit on the card
    (``frs[0]``) against the CPU plain step (``frs[1]``) taken from the
    card's net and optimizer state before it, on the card's design
    (``prepare`` on each frame, then ``train_steps`` one step at a
    time), so gaps do not compound. Every step's hidden pre-activations
    must lie within their float32 bound of the CPU's
    (``dl_preactivations``). A step's gap is ``dl_step_gap``; a step over
    the tolerance must be explained by ``dl_tie_flips``, and the same
    step with the tied rows at weight 0 must be within it. Beside it the
    CPU takes its own steps from the same start (``cpu_net``). Returns
    ``why`` (the failures), ``gaps`` (every step's), ``held`` (the
    largest gap held against the tolerance: a step's own, or where a
    flip explains it the same step's without the tied rows),
    ``z_ratio`` (the largest pre-activation gap over its bound),
    ``flips`` [(step, gap, first flipped unit)], ``step_tol``, ``steps``
    and the card's ``net`` after the last step."""
    import torch
    from h2o3_tpu_torch.models import deeplearning as dl
    a, c = (est.prepare(fr, x, y) for fr in frs)
    assert not a.cfg.dropout, "dl_replay: a fit with dropout"
    # the same inputs on both sides: the card's design, target and weights
    # (the two designs' standardization parts them in the last bits, and
    # bf16 would round a column near a midpoint two ways)
    c = c._replace(X=a.X.cpu(), y=a.y.cpu(), w=a.w.cpu())
    tol = DL_BF16_STEP_TOL if a.cfg.bf16 else DL_STEP_TOL
    out = dict(why=[], held=0.0, z_ratio=0.0, flips=[], step_tol=tol,
               steps=steps - a.done, gaps=[])

    def copy(net, opt, device):
        return ([{k: v.detach().to(device).clone().requires_grad_(True)
                  for k, v in l.items()} for l in net],
                dl.opt_state_on(opt, device))

    def step(t, net, opt, k, w=None):
        with dl.exact_f32():
            dl.train_steps(net, opt, t.X, t.y, t.w if w is None else w,
                           t.gen, t.cfg, t.sched, k, 1, t.n)

    for k in range(a.done, steps):
        before = [{n: v.detach().clone() for n, v in l.items()}
                  for l in a.net]
        opt0 = dl.opt_state_on(a.opt, "cpu")
        net_c, opt_c = copy(before, opt0, "cpu")
        z = dl_preactivations(before, a, c, k)
        ratio = max(float((za - zc).abs().div(bound).nan_to_num(
            posinf=np.inf).max()) for za, zc, bound in z)
        out["z_ratio"] = max(out["z_ratio"], ratio)
        if ratio > 1:
            out["why"].append(f"step {k}: a pre-activation {ratio:.3g} x "
                              "its float32 bound from the CPU's")
        step(a, a.net, a.opt, k)
        step(c, net_c, opt_c, k)
        step(c, c.net, c.opt, k)
        r = dl_step_gap(before, a.net, net_c)
        out["gaps"].append(r)
        if r <= tol:
            out["held"] = max(out["held"], r)
            continue
        rows, units, why = dl_tie_flips(z, a, k)
        if why:
            out["held"] = max(out["held"], r)
            out["why"].append(f"step {k}: gap {r:.3g} > {tol}, {why}")
            continue
        lo = dl.batch_start(k, a.sched.batch, a.n, a.X.shape[0])
        probe = []
        for t in (a, c):
            w = t.w.clone()
            w[lo + torch.as_tensor(rows, device=w.device)] = 0.0
            net_p, opt_p = copy(before, opt0, t.X.device)
            step(t, net_p, opt_p, k, w)
            probe.append(net_p)
        rp = dl_step_gap(before, *probe)
        out["held"] = max(out["held"], rp)
        out["flips"].append((k, float(f"{r:.3g}"), units[0]))
        if rp > tol:
            out["why"].append(f"step {k}: gap {rp:.3g} > {tol} without "
                              f"the {len(rows)} tied rows")
    out["net"] = [{n: v.detach() for n, v in l.items()} for l in a.net]
    out["cpu_net"] = [{n: v.detach() for n, v in l.items()} for l in c.net]
    return out


def dl_step_gap(before, A, C) -> float:
    """The relative RMS gap of two steps' updates from the same net
    ``before``: ||A - C|| / ||C - before|| over every W and b together
    (a small tensor whose update cancels, such as an output bias, would
    read its own rounding as a large relative gap)."""
    from h2o3_tpu_torch.parallel.device import fetch

    def flat(net):
        return np.concatenate([fetch(l[k].detach()).astype(
            np.float64).ravel() for l in net for k in ("W", "b")])
    x0, xa, xc = flat(before), flat(A), flat(C)
    num, den = np.linalg.norm(xa - xc), np.linalg.norm(xc - x0)
    return num / den if den > 0 else (0.0 if num == 0 else np.inf)


def dl_preactivations(before, a, c, k):
    """Each hidden layer's pre-activations of step ``k``'s batch from the
    net ``before``, on the card (``a``) and on the CPU (``c``,
    ``prepare``'s states), as float64 on the CPU, with the error bound
    of two float32 evaluations of the layer: 2·K·2^-24·(|h|·|W| + |b|)
    for K = fan-in + 1 terms, plus |W| times its inputs' bound, from the
    gap of the two designs up (bf16 products: the operands rounded to
    bf16, and 2^-8·|h| more where an input's bound is not 0). Returns
    [(z card, z CPU, bound)]."""
    import torch
    from h2o3_tpu_torch.models import deeplearning as dl
    B, act = a.sched.batch, a.cfg.act
    bf16 = a.cfg.bf16 is not None
    lo = dl.batch_start(k, B, a.n, a.X.shape[0])
    za, zc = [], []
    with torch.no_grad(), dl.exact_f32():
        dl.forward(before, a.X[lo:lo + B], act, bf16=a.cfg.bf16, record=za)
        dl.forward([{n: v.cpu() for n, v in l.items()} for l in before],
                   c.X[lo:lo + B], act, bf16=c.cfg.bf16, record=zc)

    def f64(t):
        t = t.detach().cpu()
        return (t.to(torch.bfloat16) if bf16 else t).double()
    h = f64(c.X[lo:lo + B])
    e = (f64(a.X[lo:lo + B]) - h).abs()
    out = []
    for li, (z1, z2) in enumerate(zip(za, zc)):
        W = f64(before[li]["W"]).abs()
        eps = 2 * (W.shape[0] + 1) * 2.0 ** -24
        bound = (eps * (h.abs() @ W + before[li]["b"].detach().cpu()
                        .double().abs()) + e @ W)
        z1, z2 = z1.detach().cpu().double(), z2.detach().cpu().double()
        out.append((z1, z2, bound))
        if act == "maxout":
            h = torch.maximum(z2[:, 0::2], z2[:, 1::2])
            e = torch.maximum(bound[:, 0::2], bound[:, 1::2])
        else:
            h = torch.relu(z2) if act == "rectifier" else torch.tanh(z2)
            e = bound
        if bf16:
            e = e + 2.0 ** -8 * h.abs() * (e > 0)
            h = h.to(torch.bfloat16).double()
    return out


def dl_tie_flips(z, a, k):
    """The rows of step ``k``'s batch where the card and the CPU decide a
    hidden unit the other way (``dl_preactivations`` ``z``): a
    rectifier's sign, or a maxout pair's order (tanh decides nothing),
    each within its float32 bound of the tie. Returns (rows of the batch,
    the flipped units as text, why): ``why`` is set where nothing flips
    or a flip lies outside its bound."""
    import torch
    from h2o3_tpu_torch.models import deeplearning as dl
    lo = dl.batch_start(k, a.sched.batch, a.n, a.X.shape[0])
    rows, units = set(), []
    for li, (z1, z2, bound) in enumerate(z):
        if a.cfg.act == "maxout":
            d1 = torch.sign(z1[:, 0::2] - z1[:, 1::2])
            d2 = torch.sign(z2[:, 0::2] - z2[:, 1::2])
            margin = (z2[:, 0::2] - z2[:, 1::2]).abs()
            bound = bound[:, 0::2] + bound[:, 1::2]
        elif a.cfg.act == "rectifier":
            d1, d2, margin = z1 > 0, z2 > 0, z2.abs()
        else:
            d1 = d2 = torch.zeros(z2.shape, dtype=torch.bool)
            margin = z2.abs()
        for r, u in (d1 != d2).nonzero().tolist():
            if margin[r, u] > bound[r, u]:
                return [], [], (f"layer {li} unit {u} of row {lo + r} "
                                f"decided the other way at |z| "
                                f"{float(margin[r, u]):.3g}, outside its "
                                f"float32 bound {float(bound[r, u]):.3g}")
            rows.add(r)
            units.append(f"layer {li} unit {u}: |z| "
                         f"{float(margin[r, u]):.3g} within "
                         f"{float(bound[r, u]):.3g}")
    if not rows:
        return [], [], "no unit decided the other way"
    return sorted(rows), units, ""


def dl_step_timing(torch, fr, model) -> dict:
    """One training step of ``model``'s fit continued (``prepare`` with
    ``checkpoint=model``: its net, optimizer state and step count, the
    next batch) timed with ``time_ms``, and one 20-step chunk under
    torch.profiler: its kernels by device time, the device's busy share,
    and no scatter or atomic kernel in the step's backward (the refit is
    bit-equal)."""
    from h2o3_tpu_torch.models import deeplearning as dl
    p = {k: v for k, v in model.params.items() if k != "checkpoint"}
    t = dl.DeepLearningEstimator(**dict(p, epochs=2 * p["epochs"]),
                                 checkpoint=model).prepare(
        fr, model.features, model.output["response"])
    step = [t.done]

    def one(k=1):
        with dl.exact_f32():
            dl.train_steps(t.net, t.opt, t.X, t.y, t.w, t.gen, t.cfg,
                           t.sched, step[0], k, t.n)
        step[0] += k
    tm = time_ms(torch, one)
    ev = profiled_fit(torch, f"phase23 20 steps at batch {t.sched.batch}",
                      lambda: one(20))
    names = [e.key for e in ev if getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        > 0]
    bad = [k for k in names if any(s in k.lower() for s in (
        "scatter", "index_add", "atomic"))]
    check(not bad, f"DL step kernels that add through atomics: {bad}")
    tm["launches"] = sum(e.count for e in ev
                         if e.key.startswith("cudaLaunchKernel")) / 20
    return tm


def phase_dl_bench(torch, dev):
    """Phase 23(a): bench.py's DL benchmark at its shape, nothing cut;
    (c) the same frame at a batch of 16,384 (bf16). Returns (the paths'
    launches, the frame's arrays)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.deeplearning import (BF16_MIN_BATCH,
                                                    batch_size, bf16_route)
    t0 = time.perf_counter()
    (cols, domains), t_gen = made_ahead(
        "mnist", lambda: mnist_shape_arrays(N_DL))
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    torch.cuda.synchronize()
    say(f"phase23a MNIST shape {N_DL} x {P_DL} made ahead (waited "
        f"{t_gen:.3f} s), on the card in "
        f"{time.perf_counter() - t0 - t_gen:.3f} s")
    paths = {}
    _, t_warm, _, _ = timed_fit(torch, lambda: h2o.DeepLearningEstimator(
        epochs=DL_WARMUP, **DL).train(fr, y="label"))
    model, secs, counts, peak = timed_fit(
        torch, lambda: h2o.DeepLearningEstimator(
            epochs=DL_EPOCHS, **DL).train(fr, y="label"))
    check_launches(counts, {}, "DeepLearning")
    paths["deeplearning"] = counts
    batch = batch_size(N_DL, fr.nrows_padded, 1)
    check(batch < BF16_MIN_BATCH, f"DL batch {batch} at {N_DL} rows is "
                                  "bf16's")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    refit = h2o.DeepLearningEstimator(epochs=DL_EPOCHS, **DL).train(
        fr, y="label")
    torch.cuda.synchronize()
    t_re = time.perf_counter() - t1
    tm = model.training_metrics
    check(same_net(model, refit) and refit.training_metrics["logloss"]
          == tm["logloss"], "DL: the refit is not bit-equal")
    check(np.isfinite(tm["logloss"]) and tm["error_rate"] < 0.9,
          f"DL training error {tm['error_rate']}")
    sps = N_DL * DL_EPOCHS / secs
    hist = [(h["step"], round(h["loss"], 6))
            for h in model.output["scoring_history"]]
    say(f"phase23a DeepLearning [200,200] rectifier, {DL_EPOCHS} epochs on "
        f"{N_DL} x {P_DL} ({CARD}): train {secs:.3f} s (warm-up fit of "
        f"{DL_WARMUP} epochs {t_warm:.3f} s, refit {t_re:.3f} s, "
        f"bit-equal), {sps:.6g} samples/s ({sps / DL_PUBLISHED:.4g}x the "
        f"published {DL_PUBLISHED:.0f} samples/s of one H2O node, "
        f"{N_DL * DL_EPOCHS / t_re:.6g} refit), batch {batch} (float32, "
        f"TF32 off), {model._steps_trained} steps, peak device memory "
        f"{peak / 2**30:.3f} GiB; training error {tm['error_rate']:.6f}, "
        f"logloss {tm['logloss']:.6f}, mean per-class error "
        f"{tm['mean_per_class_error']:.6f} on {tm['nobs']} sampled rows; "
        f"early-stopping history (step, full-data loss) {hist}; launches "
        f"{counts}")
    t = dl_step_timing(torch, fr, model)
    dev_s = t["ms"] * model._steps_trained / 1e3
    say(f"phase23a one step at batch {batch}: {spread(t)} device, "
        f"host-paced {t['host_paced_ms']:.4f} ms, host {t['host_us']:.1f} "
        f"us a call ({t['launches']:.0f} launches a step); the fit's "
        f"{model._steps_trained} steps are {dev_s:.3f} s of device time "
        f"against {secs:.3f} s wall: the step loop is "
        + ("paced by the host" if t["host_paced_ms"] > 1.2 * t["ms"]
           else "paced by the card"))
    del refit
    # (c) the bf16 path on the same frame: one bf16 GEMM with a float32
    # result on the card, not the upcast route
    route = bf16_route(dev)
    check(route == "mm_out_dtype", f"DL bf16 route on the card: {route}")
    bmodel, bsecs, bcounts, bpeak = timed_fit(
        torch, lambda: h2o.DeepLearningEstimator(
            epochs=DL_EPOCHS, mini_batch_size=DL_BF16_BATCH, **DL).train(
                fr, y="label"))
    check_launches(bcounts, {}, "DeepLearning bf16")
    paths["deeplearning_bf16"] = bcounts
    btm = bmodel.training_metrics
    check(np.isfinite(btm["logloss"]) and bmodel.output["bf16"] == route,
          f"DL bf16: training logloss, route {bmodel.output['bf16']}")
    tb = dl_step_timing(torch, fr, bmodel)
    say(f"phase23c bf16 route {route}: mini_batch_size {DL_BF16_BATCH}, "
        f"{bmodel._steps_trained} steps, train {bsecs:.3f} s, "
        f"{N_DL * DL_EPOCHS / bsecs:.6g} samples/s, peak "
        f"{bpeak / 2**30:.3f} GiB, training error {btm['error_rate']:.6f}, "
        f"logloss {btm['logloss']:.6f}; one step {spread(tb)} device, "
        f"host-paced {tb['host_paced_ms']:.4f} ms; launches {bcounts}")
    del fr, model, bmodel
    return paths, cols, domains


@contextlib.contextmanager
def dl_tf32_control(torch):
    """A control: the DL module's float32 products on the card in TF32
    (its ``exact_f32`` turns TF32 on instead of off)."""
    from h2o3_tpu_torch.models import deeplearning as dl

    @contextlib.contextmanager
    def tf32():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    with mock.patch.object(dl, "exact_f32", tf32):
        yield


@contextlib.contextmanager
def dl_bf16_rounded_control(torch):
    """A control: the card's bf16 products rounded to bf16 (what a plain
    ``bf16 @ bf16`` gives), not the reference's float32 result."""
    from h2o3_tpu_torch.models import deeplearning as dl
    plain = dl._Bf16Product.forward

    def rounded(ctx, a, b, route):
        out = plain(ctx, a, b, route)
        return out.to(torch.bfloat16).float() if a.is_cuda else out
    with mock.patch.object(dl._Bf16Product, "forward",
                           staticmethod(rounded)):
        yield


def phase_dl_heads(torch, dev, cols, domains):
    """Phase 23(b): card vs CPU plain on a head of (a)'s frame (1 epoch,
    batch 256, the same initial weights), then the same on its first
    quarter with TF32 left on, which must fail; (c): the same in bf16
    (batch 16,384, 2 epochs on a larger head), then on its first half
    with bf16-rounded products, which must fail."""
    import h2o3_tpu_torch as h2o
    for label, n, params, control, what in (
            ("b", N_DL_HEAD, dict(epochs=1.0), dl_tf32_control,
             "TF32 on the card"),
            ("c", N_DL_BF16_HEAD, dict(epochs=2.0,
                                       mini_batch_size=DL_BF16_BATCH),
             dl_bf16_rounded_control, "bf16-rounded products")):
        head = {k: v[:n] for k, v in cols.items()}
        t0 = time.perf_counter()

        def run(label=label, params=params, head=head):
            return dl_card_vs_cpu(
                lambda: h2o.DeepLearningEstimator(**params, **DL), head,
                domains, "label", dev, label)
        dl_check(run(f"phase23{label} {n}-row head {params}"))
        # each control on a part of its head (for the run's time since
        # phase 27 came): the first quarter of (b)'s (16 steps of 64),
        # half of (c)'s (4 steps of 8); both part from the CPU at step 0
        part = 4 if label == "b" else 2
        head = {k: v[:n // part] for k, v in head.items()}
        n = n // part
        with control(torch):
            dl_control(run(f"phase23{label} {n}-row head {params}",
                           head=head), what)
        say(f"phase23{label}: {time.perf_counter() - t0:.3f} s")


def dl_surface_fits(delay):
    """Phase 23(d)'s fits: (label, response, parameters, held against
    the CPU)."""
    return (
        ("tanh", Y, dict(activation="Tanh"), True),
        ("maxout multinomial", "late", dict(activation="Maxout"), True),
        ("tanh with dropout", Y, dict(activation="TanhWithDropout",
                                      input_dropout_ratio=0.1), False),
        ("maxout with dropout", "late", dict(
            activation="MaxoutWithDropout"), False),
        ("nesterov ramp l1 l2 regression", "delay", dict(
            adaptive_rate=False, rate=0.002, momentum_start=0.5,
            momentum_stable=0.9, momentum_ramp=2e4, l1=1e-5, l2=1e-4),
         True),
        ("regression", "delay", {}, True),
        ("autoencoder", None, dict(autoencoder=True, hidden=[16]), True),
    )


def phase_dl_surface(torch, dev, cols, domains, delay):
    """Phase 23(d): the DL surface on the first N_DL_SURFACE airlines rows
    (P = 263 after one-hot): Tanh and Maxout, with dropout, momentum SGD
    with Nesterov and a ramp under L1/L2, regression, the autoencoder and
    ``anomaly``, early stopping with a validation frame, a ``checkpoint=``
    restart and 3-fold CV; each on the card, and each without dropout
    against the CPU plain fit on the same rows. Returns the launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    n = N_DL_SURFACE
    scols = {k: v[:n] for k, v in cols.items()}
    scols["delay"] = delay[:n]
    scols["late"] = np.digitize(delay[:n], [0.0, 15.0]).astype(np.int32)
    sdoms = dict(domains, late=["l0_early", "l1_ontime", "l2_late"])
    x = [c for c in cols if c != Y]
    kernels.reset_counts()
    t0 = time.perf_counter()
    for label, y, params, held in dl_surface_fits(delay):
        kw = {**DL_SURFACE, **params}

        def build(kw=kw):
            return h2o.DeepLearningEstimator(**kw)
        if held:
            res = dl_card_vs_cpu(build, scols, sdoms, y, dev,
                                 f"phase23d {label}", x=x)
            dl_check(res)
            m, fr, extra = res["m_card"], res["fr"], "held against the CPU"
        else:
            fr = h2o.Frame.from_numpy(scols, domains=sdoms, device=dev)
            m = build().train(fr, y=y, x=x)
            extra = "dropout: card only"
        tm = m.training_metrics
        check(np.isfinite(tm["MSE"]), f"DL {label}: training MSE")
        if params.get("autoencoder"):
            err = m.anomaly(fr).col("reconstruction_error").host_view()
            check(err.shape == (n,) and np.isfinite(err).all(),
                  "DL autoencoder: anomaly scores")
            extra += f", anomaly mean {err.mean():.6f}"
        say(f"phase23d {label}: training MSE {tm['MSE']:.6f}, "
            f"{m._steps_trained} steps; {extra}")
    # early stopping with a validation frame
    vcols = {k: v[n:n + n // 4] for k, v in cols.items()}
    # Tanh: no rectifier tie flips, so card and CPU keep one history
    stop = dict(DL_SURFACE, activation="Tanh", epochs=50, stopping_rounds=2,
                stopping_tolerance=0.1)
    ms = []
    for d in (dev, "cpu"):
        fr = h2o.Frame.from_numpy(scols, domains=sdoms, device=d)
        vf = h2o.Frame.from_numpy(vcols, domains=domains, device=d)
        ms.append(h2o.DeepLearningEstimator(**stop).train(
            fr, y=Y, x=x, validation_frame=vf))
    hc, hp = (m.output["scoring_history"] for m in ms)
    check([h["step"] for h in hc] == [h["step"] for h in hp]
          and all(abs(a["loss"] - b["loss"]) <= DL_METRIC_TOL * b["loss"]
                  for a, b in zip(hc, hp)),
          f"DL early stopping: card history {hc} vs CPU {hp}")
    vm = ms[0].validation_metrics
    check(vm is not None and abs(vm["AUC"] - ms[1].validation_metrics["AUC"])
          <= DL_METRIC_TOL, "DL validation AUC card vs CPU")
    say(f"phase23d early stopping (Tanh): stopped at step {ms[0]._steps_trained} "
        f"of 50 epochs (history {[(h['step'], round(h['loss'], 6)) for h in hc]}"
        f"), validation AUC {vm['AUC']:.6f} on {vm['nobs']} rows, equal "
        f"card vs CPU within {DL_METRIC_TOL}")
    # checkpoint restart on the card, dropout on: the continuation is the
    # straight fit bit for bit (the generator state carries over)
    fr = h2o.Frame.from_numpy(scols, domains=sdoms, device=dev)
    ck = dict(DL_SURFACE, activation="RectifierWithDropout",
              input_dropout_ratio=0.1)
    donor = h2o.DeepLearningEstimator(**ck).train(fr, y=Y, x=x)
    cont = h2o.DeepLearningEstimator(**dict(ck, epochs=4),
                                     checkpoint=donor).train(fr, y=Y, x=x)
    straight = h2o.DeepLearningEstimator(**dict(ck, epochs=4)).train(
        fr, y=Y, x=x)
    check(same_net(cont, straight) and cont._steps_trained
          == straight._steps_trained > donor._steps_trained,
          "DL checkpoint: the continuation is not the straight fit")
    say(f"phase23d checkpoint: {donor._steps_trained} steps + restart to "
        f"{cont._steps_trained} bit-equal to the straight 4-epoch fit "
        "(dropout on)")
    # 3-fold CV, card vs CPU
    res = dl_card_vs_cpu(lambda: h2o.DeepLearningEstimator(**dict(
        DL_SURFACE, activation="Tanh", nfolds=3)), scols, sdoms, Y, dev,
        "phase23d 3-fold CV (Tanh), the main model", x=x)
    dl_check(res)
    a = res["m_card"].cross_validation_metrics
    b = res["m_cpu"].cross_validation_metrics
    check(abs(a["AUC"] - b["AUC"]) <= DL_METRIC_TOL
          and abs(a["logloss"] - b["logloss"]) <= DL_METRIC_TOL * b["logloss"],
          f"DL CV metrics card {a} vs CPU {b}")
    say(f"phase23d 3-fold CV (Tanh): AUC {a['AUC']:.6f} (CPU {b['AUC']:.6f}), "
        f"logloss {a['logloss']:.6f}; (d) {time.perf_counter() - t0:.3f} s")
    return dict(kernels.LAUNCHES)


def phase_dl(torch, dev, cols, domains, delay):
    """Phase 23: DeepLearning (no kernel: cuBLAS products with TF32 off,
    bf16 GEMMs at a batch of 16,384, plain torch). Returns the launches of
    its three paths (every kernel 0 on each)."""
    t0 = time.perf_counter()
    paths, mcols, mdoms = phase_dl_bench(torch, dev)
    secs = {"a, c": time.perf_counter() - t0}
    phase_dl_heads(torch, dev, mcols, mdoms)
    del mcols
    secs["b, c heads"] = time.perf_counter() - t0 - sum(secs.values())
    paths["deeplearning_surface"] = phase_dl_surface(torch, dev, cols,
                                                     domains, delay)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    for p, c in paths.items():
        check(not any(c.values()), f"{p}: a kernel launched")
    say("phase23: " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s; every kernel 0 launches "
        f"on {', '.join(paths)}")
    return paths


# -------------------------------------------------------------- phase 24

def same_output(a, b) -> bool:
    """Two models' outputs, metrics or statistics equal bit for bit
    (nested dicts, lists, numpy arrays and numbers)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_output(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(same_output, a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


# output entries that hold DKV keys: a refit's are new keys (a process-wide
# counter numbers them), so a refit is held on their count alone
KEY_OUTPUTS = ("cv_model_keys", "cv_predictions_keys", "cv_holdout_frame_key",
               "cv_fold_assignment_key", "output_frame", "weights_keys",
               "biases_keys")


def keyless(output: dict) -> dict:
    """``output`` with each DKV-key entry replaced by its count of keys."""
    return {k: (len(v) if isinstance(v, list) else v is not None)
            if k in KEY_OUTPUTS else v for k, v in output.items()}


def refit_check(torch, build, model, fit, label, fields=()) -> float:
    """A refit on the card bit-equal to ``model`` (output but its DKV
    keys, training metrics, for Naive Bayes statistics, and the model
    attributes named in ``fields``); returns its seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fit(build())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tm = (lambda m: None if m.training_metrics is None
          else m.training_metrics.to_dict())
    check(same_output(keyless(again.output), keyless(model.output))
          and same_output(tm(again), tm(model))
          and all(same_output(getattr(again, f, None),
                              getattr(model, f, None))
                  for f in ("stats",) + tuple(fields)),
          f"{label}: the refit is not bit-equal")
    return secs


def head_frames(cols, domains, n, dev):
    """The first ``n`` rows as a frame on the card and on the CPU."""
    import h2o3_tpu_torch as h2o
    head = {k: v[:n] for k, v in cols.items()}
    return [h2o.Frame.from_numpy(head, domains=domains, device=d)
            for d in (dev, "cpu")]


def rel_gap(a, b, floor: float = 0.0) -> float:
    """max |a − b| / max(floor, |b|) (0 for empty inputs)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(floor, np.abs(b))).max())


def near_ties(X, C) -> np.ndarray:
    """Rows whose two smallest squared distances to the centers ``C``
    differ by at most 1e-5 of their scale (float64)."""
    X, C = X.astype(np.float64), C.astype(np.float64)
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(2)
    s = np.sort(d2, axis=1)
    return (s[:, 1] - s[:, 0]) <= 1e-5 * ((X * X).sum(1)
                                          + (C * C).sum(1).max())


def kmeans_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """KMeans card vs CPU plain at the tests' tolerances; returns what
    was held, as a line."""
    from h2o3_tpu_torch.parallel.device import fetch
    check(m_card.output["iterations"] == m_cpu.output["iterations"],
          f"{label}: steps card {m_card.output['iterations']} vs CPU "
          f"{m_cpu.output['iterations']}")
    gap = rel_gap(m_card.output["centers_std"], m_cpu.output["centers_std"],
                  1.0)
    check(gap <= KM_CENTER_TOL, f"{label}: centers {gap:.3g}")
    a, b = m_card.training_metrics, m_cpu.training_metrics
    mgap = max(rel_gap(a[k], b[k]) for k in
               ("totss", "tot_withinss", "betweenss"))
    check(mgap <= KM_METRIC_TOL, f"{label}: metrics {mgap:.3g}")
    n = frs[1].nrows
    got, want = (m.predict(fr).col("predict").host_view()
                 for m, fr in zip((m_card, m_cpu), frs))
    X = fetch(m_cpu._design(frs[1]).X)[:n]
    ties = near_ties(X, fetch(m_cpu.centers_std))
    check(np.array_equal(got[~ties], want[~ties]),
          f"{label}: assignments differ off the near-ties")
    return (f"{n}-row head card vs CPU plain: {m_card.output['iterations']}"
            f" steps both, centers {gap:.3g} (<= {KM_CENTER_TOL}), metrics "
            f"{mgap:.3g} (<= {KM_METRIC_TOL}), assignments equal off "
            f"{int(ties.sum())} near-tie rows ({int((got != want).sum())} "
            "differ)")


def eig_gaps(vals) -> np.ndarray:
    """Each leading eigenvalue's relative gap to its neighbours."""
    v = np.asarray(vals, np.float64)
    up = np.concatenate([[np.inf], 1 - v[1:] / v[:-1]])
    down = np.concatenate([1 - v[1:] / v[:-1], [np.inf]])
    return np.minimum(up, down)


def signed_like(a, b) -> np.ndarray:
    """``a``'s columns with the signs of ``b``'s."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.sign((a * b).sum(0))
    return a * np.where(s == 0, 1.0, s)


def least_cosine(Va, Vb) -> float:
    """The least cosine of the principal angles between two column
    spaces."""
    Va, Vb = np.asarray(Va, np.float64), np.asarray(Vb, np.float64)
    return float(np.linalg.svd(np.linalg.qr(Va)[0].T @ np.linalg.qr(Vb)[0],
                               compute_uv=False).min())


def vectors_card_vs_cpu(vals_card, vals_cpu, V_card, V_cpu, label) -> str:
    """Standard deviations or singular values (√λ) within EIG_TOL; each
    vector within VEC_TOL up to sign where its eigenvalue lies 10% from
    its neighbours; the whole column space within VEC_TOL."""
    vgap = rel_gap(vals_card, vals_cpu)
    check(vgap <= EIG_TOL, f"{label}: values {vgap:.3g}")
    far = eig_gaps(np.asarray(vals_cpu, np.float64) ** 2) >= 0.1
    vec = rel_gap(signed_like(V_card, V_cpu)[:, far],
                  np.asarray(V_cpu)[:, far], 1.0)
    check(vec <= VEC_TOL, f"{label}: vectors {vec:.3g}")
    cos = least_cosine(V_card, V_cpu)
    check(cos >= 1 - VEC_TOL, f"{label}: subspace least cosine {cos}")
    return (f"values {vgap:.3g} (<= {EIG_TOL}), {int(far.sum())} of "
            f"{len(far)} vectors 10% apart within {vec:.3g} up to sign "
            f"(<= {VEC_TOL}), subspace least cosine 1 - {1 - cos:.3g}")


def pca_frame_arrays(n: int, seed: int = 13):
    """(b)'s rows: n x P_PCA float32, a rank-RANK_PCA signal U·S·V' with
    singular values falling by 0.95 a component, plus uniform noise at 1%
    of the smallest (256 levels: one random byte a cell, the cheapest
    draw of 784M), all from RandomState(seed); built 64 columns at a
    time, each column contiguous."""
    r = np.random.RandomState(seed)
    V = np.linalg.qr(r.randn(P_PCA, RANK_PCA))[0].astype(np.float32)
    s = (0.95 ** np.arange(RANK_PCA)).astype(np.float32)
    Us = r.randn(n, RANK_PCA).astype(np.float32) * s
    amp = np.float32(0.01 * s[-1])
    cols = {}
    for lo in range(0, P_PCA, 64):
        hi = min(P_PCA, lo + 64)
        levels = np.frombuffer(r.bytes(n * (hi - lo)), np.uint8).reshape(
            hi - lo, n)
        blk = V[lo:hi] @ Us.T                 # [columns, n]
        blk += amp * (levels * np.float32(1 / 127.5) - np.float32(1))
        cols.update({f"x{lo + j}": blk[j] for j in range(hi - lo)})
    return cols


def phase_kmeans(torch, dev, higgs):
    """Phase 24(a): KMeans on phase 22(a)'s HIGGS frame (11M x 28, the
    response left out; k = 10, Furthest, standardized, 20 steps at
    most): the fit, a refit, one Lloyd step timed against its byte
    bound; on 1M rows PlusPlus, Random, estimate_k, 3-fold CV and
    user_points; the host float64 constrained fit on 10,000 rows; a head
    card vs CPU. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import kmeans
    cols = {k: v for k, v in higgs[0].items() if k != "y"}
    domains = {}
    fr = higgs[3]
    x = list(cols)
    build = lambda: h2o.KMeansEstimator(**KMEANS)  # noqa: E731
    model, secs, counts, peak = timed_fit(torch,
                                          lambda: build().train(fr, x=x))
    check_launches(counts, {}, "KMeans")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr, x=x),
                       "KMeans")
    tm = model.training_metrics
    steps = model.output["iterations"]
    check(np.isfinite(np.asarray(model.output["centers"])).all()
          and tm["nobs"] == N_HIGGS and 0 < tm["betweenss"] < tm["totss"],
          "KMeans centers and metrics")
    say(f"phase24a KMeans k={KMEANS['k']} {KMEANS['init']} on {N_HIGGS} x "
        f"{P_HIGGS}: train {secs:.3f} s (refit {t_re:.3f} s, bit-equal), "
        f"{steps} steps, {N_HIGGS * steps / secs:.6g} row-steps/s, "
        f"tot_withinss {tm['tot_withinss']:.6g}, betweenss/totss "
        f"{tm['betweenss'] / tm['totss']:.6f}, peak device memory "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    X = model._design(fr).X
    w = fr.valid_weights()
    C = model.centers_std
    t = time_ms(torch, lambda: kmeans.lloyd_step(X, w, C, KMEANS["k"]),
                reps=5)
    b_bytes = N_HIGGS * P_HIGGS * 4 / HBM_BYTES_PER_S * 1e3
    b_ops = 2.0 * N_HIGGS * P_HIGGS * KMEANS["k"] / F32_OPS_PER_S * 1e3
    say(f"phase24a one Lloyd step: {spread(t)} device, host-paced "
        f"{t['host_paced_ms']:.4f} ms (bound {max(b_bytes, b_ops):.4f} ms:"
        f" X read once {b_bytes:.4f}, float32 operations {b_ops:.4f})")
    del X, w, C, model, fr
    head = {k: v[:N_KM_HEAD] for k, v in cols.items()}
    fh = h2o.Frame.from_numpy(head, device=dev)
    kmeans_fits = (
        ("PlusPlus", dict(KMEANS, init="PlusPlus")),
        ("Random", dict(KMEANS, init="Random")),
        ("estimate_k", dict(KMEANS, estimate_k=True)),
        ("3-fold CV", dict(KMEANS, nfolds=3)),
        ("user_points", dict(KMEANS, user_points=h2o.Frame.from_numpy(
            {k: v[:KMEANS["k"]] for k, v in head.items()}, device=dev))))
    for label, params in kmeans_fits:
        b = lambda p=params: h2o.KMeansEstimator(**p)  # noqa: E731
        m, secs, c, _ = timed_fit(torch, lambda: b().train(fh))
        check_launches(c, {}, f"KMeans {label}")
        counts = {k: counts[k] + c[k] for k in counts}
        refit_check(torch, b, m, lambda e: e.train(fh), f"KMeans {label}")
        mt = m.training_metrics
        check(np.isfinite(mt["tot_withinss"]) and mt["nobs"] == N_KM_HEAD,
              f"KMeans {label} metrics")
        extra = ""
        if params.get("nfolds"):
            check(m.cross_validation_metrics["centroid_stats"] is None
                  and len(m._cv_models) == 3, "KMeans CV metrics")
            extra = (f", CV tot_withinss "
                     f"{m.cross_validation_metrics['tot_withinss']:.6g}")
        say(f"phase24a KMeans {label} on {N_KM_HEAD} rows: {secs:.3f} s "
            f"(refit bit-equal), k "
            f"{m.output['k']}, {m.output['iterations']} steps, "
            f"tot_withinss {mt['tot_withinss']:.6g}{extra}")
    cons = {k: v[:N_KM_CONS] for k, v in cols.items()}
    fc = h2o.Frame.from_numpy(cons, device=dev)
    m, secs, c, _ = timed_fit(
        torch, lambda: h2o.KMeansEstimator(**KM_CONS).train(fc))
    counts = {k: counts[k] + c[k] for k in counts}
    sizes = m.training_metrics["centroid_stats"]["size"]
    check(min(sizes) >= KM_CONS["cluster_size_constraints"][0],
          f"constrained sizes {sizes}")
    m_cpu = h2o.KMeansEstimator(**KM_CONS).train(
        h2o.Frame.from_numpy(cons, device="cpu"))
    check(m_cpu.training_metrics["centroid_stats"]["size"] == sizes,
          "constrained sizes card vs CPU")
    say(f"phase24a KMeans cluster_size_constraints (>= "
        f"{KM_CONS['cluster_size_constraints'][0]}) on {N_KM_CONS} rows: "
        f"{secs:.3f} s, sizes {[int(v) for v in sizes]} (the CPU's "
        "equal)")
    frs = head_frames(cols, domains, N_UNSUP_CPU, dev)
    ms = [build().train(f) for f in frs]
    say("phase24a KMeans " + kmeans_card_vs_cpu(*ms, frs, "KMeans head"))
    return counts


def phase_pca(torch, dev, cols, domains):
    """Phase 24(b): PCA at MNIST's width (1M x 784, k = 50) by GramSVD
    and Randomized, the Gram timed against its bound and eigh timed; PCA
    and SVD on 1M airlines rows through the one-hot design; each with a
    refit and a head card vs CPU. Returns the launches of the PCA and
    SVD paths."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    from h2o3_tpu_torch.models import pca
    t0 = time.perf_counter()
    pcols, t_gen = made_ahead("pca", lambda: pca_frame_arrays(N_PCA))
    fr = h2o.Frame.from_numpy(pcols, device=dev)
    say(f"phase24b {N_PCA} x {P_PCA} rank-{RANK_PCA} rows made ahead "
        f"(waited {t_gen:.3f} s), on the card in "
        f"{time.perf_counter() - t0 - t_gen:.3f} s")
    paths = {"pca": {}, "svd": {}}
    models = {}
    for method in ("GramSVD", "Randomized"):
        build = lambda m=method: h2o.PCAEstimator(  # noqa: E731
            k=K_PCA, pca_method=m, seed=1)
        model, secs, counts, peak = timed_fit(torch,
                                              lambda: build().train(fr))
        check_launches(counts, {}, f"PCA {method}")
        paths["pca"] = {k: paths["pca"].get(k, 0) + v
                        for k, v in counts.items()}
        t_re = refit_check(torch, build, model, lambda e: e.train(fr),
                           f"PCA {method}")
        pv = np.asarray(model.output["pct_variance"])
        check(np.isfinite(pv).all() and (np.diff(pv) <= 1e-6).all(),
              f"PCA {method} pct_variance")
        models[method] = model
        say(f"phase24b PCA {method} k={K_PCA} on {N_PCA} x {P_PCA}: train "
            f"{secs:.3f} s (refit {t_re:.3f} s, bit-equal), "
            f"cum_pct_variance {model.output['cum_pct_variance'][-1]:.6f}"
            f", pct_variance[:3] {[round(float(v), 6) for v in pv[:3]]}, "
            f"peak {peak / 2**30:.3f} GiB")
    cos = least_cosine(models["Randomized"].V.cpu(), models["GramSVD"].V.cpu())
    X = build_datainfo(fr, fr.names, standardize=True).X
    w = fr.valid_weights()
    t_gram = time_ms(torch, lambda: pca.weighted_gram(X, w), reps=3)
    xtx, wsum = pca.weighted_gram(X, w)
    cov = xtx / (wsum - 1.0)
    t_eigh = time_ms(torch, lambda: pca.eig_desc(cov), reps=3)
    b_bytes = N_PCA * P_PCA * 4 / HBM_BYTES_PER_S * 1e3
    b_ops = 2.0 * N_PCA * P_PCA * P_PCA / F32_OPS_PER_S * 1e3
    say(f"phase24b Randomized vs GramSVD: top-{K_PCA} subspace least "
        f"cosine {cos:.6f}; the Gram {spread(t_gram)} device (bound "
        f"{max(b_bytes, b_ops):.4f} ms: bytes {b_bytes:.4f}, float32 "
        f"operations {b_ops:.4f}); eigh of the {P_PCA} x {P_PCA} "
        f"covariance {spread(t_eigh)}")
    del X, w, xtx, cov, models, fr
    for method in ("GramSVD", "Randomized"):
        frs = head_frames(pcols, {}, N_UNSUP_CPU, dev)
        ms = [h2o.PCAEstimator(k=K_PCA, pca_method=method, seed=1).train(f)
              for f in frs]
        say(f"phase24b PCA {method} {N_UNSUP_CPU}-row head card vs CPU "
            "plain: " + vectors_card_vs_cpu(
                ms[0].output["std_deviation"], ms[1].output["std_deviation"],
                ms[0].output["eigenvectors"], ms[1].output["eigenvectors"],
                f"PCA {method} head"))
    del pcols, frs, ms
    # the one-hot design on airlines rows
    head = {k: v[:N_DIMRED] for k, v in cols.items() if k != Y}
    fa = h2o.Frame.from_numpy(head, domains=domains, device=dev)
    for algo, build in (
            ("pca", lambda: h2o.PCAEstimator(k=10,
                                             use_all_factor_levels=False)),
            ("svd", lambda: h2o.SVDEstimator(nv=10,
                                             transform="standardize"))):
        model, secs, counts, _ = timed_fit(torch, lambda: build().train(fa))
        check_launches(counts, {}, algo)
        paths[algo] = {k: paths[algo].get(k, 0) + v
                       for k, v in counts.items()}
        t_re = refit_check(torch, build, model, lambda e: e.train(fa), algo)
        P = len(model.output["coef_names"])
        frs = head_frames(head, domains, N_UNSUP_CPU, dev)
        ms = [build().train(f) for f in frs]
        if algo == "pca":
            got = vectors_card_vs_cpu(
                ms[0].output["std_deviation"], ms[1].output["std_deviation"],
                ms[0].output["eigenvectors"], ms[1].output["eigenvectors"],
                "PCA airlines head")
            what = ("cum_pct_variance "
                    f"{model.output['cum_pct_variance'][-1]:.6f}")
        else:
            got = vectors_card_vs_cpu(ms[0].output["d"], ms[1].output["d"],
                                      ms[0].output["v"], ms[1].output["v"],
                                      "SVD airlines head")
            what = f"d[:3] {[round(v, 3) for v in model.output['d'][:3]]}"
        say(f"phase24b {algo.upper()} on {N_DIMRED} airlines rows (P = {P}):"
            f" {secs:.3f} s (refit {t_re:.3f} s, bit-equal), {what}; "
            f"{N_UNSUP_CPU}-row head card vs CPU plain: {got}")
    return paths


def reconstruction(model, fr) -> np.ndarray:
    """A GLRM's A·Y of ``fr``'s rows, [nrows, P] on the host."""
    rec = model.reconstruct(fr)
    return np.stack([rec.col(c).host_view()
                     for c in model.output["coef_names"]], 1)


def glrm_card_vs_cpu(m_card, m_cpu, frs, label, signed: bool) -> str:
    """GLRM card vs CPU plain at the tests' tolerances."""
    check(m_card.output["iterations"] == m_cpu.output["iterations"],
          f"{label}: steps card {m_card.output['iterations']} vs CPU "
          f"{m_cpu.output['iterations']}")
    og = rel_gap(m_card.output["objective"], m_cpu.output["objective"])
    check(og <= GLRM_OBJ_TOL, f"{label}: objective {og:.3g}")
    n = frs[1].nrows
    ay = [reconstruction(m, fr) for m, fr in zip((m_card, m_cpu), frs)]
    ag = rel_gap(ay[0], ay[1], 1.0)
    check(ag <= GLRM_AY_TOL, f"{label}: A·Y {ag:.3g}")
    Ya, Yb = (np.asarray(m.output["archetypes"]).T for m in (m_card, m_cpu))
    yg = rel_gap(Ya if signed else signed_like(Ya, Yb), Yb, 1.0)
    check(yg <= GLRM_Y_TOL, f"{label}: archetypes {yg:.3g}")
    return (f"{n}-row head card vs CPU plain: {m_card.output['iterations']} "
            f"steps both, objective {og:.3g} (<= {GLRM_OBJ_TOL}), A·Y "
            f"{ag:.3g} (<= {GLRM_AY_TOL}), archetypes"
            f"{'' if signed else ' up to sign'} {yg:.3g} (<= {GLRM_Y_TOL})")


def glrm_columns(cols, n: int, seed: int = 24):
    """The first ``n`` airlines rows without the response, GLRM_NA of
    the numeric cells NA (float64 NaN) from RandomState(seed)."""
    r = np.random.RandomState(seed)
    out = {}
    for k, v in cols.items():
        if k == Y:
            continue
        v = v[:n]
        if k in NUMERIC:
            v = np.where(r.rand(n) < GLRM_NA, np.nan, v.astype(np.float64))
        out[k] = v
    return out


def phase_glrm(torch, dev, cols, domains):
    """Phase 24(c): GLRM on 1M airlines rows (P = 265, all levels), 5%
    of the numeric cells NA: k = 10, standardized, quadratic, ridge 0.1
    on both sides, 50 steps at most; a refit, the batched k x k solve
    timed; L1 and NonNegative on a head, each card vs CPU. Returns the
    path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    from h2o3_tpu_torch.models import glrm
    gcols = glrm_columns(cols, N_DIMRED)
    fr = h2o.Frame.from_numpy(gcols, domains=domains, device=dev)
    build = lambda: h2o.GLRMEstimator(**GLRM)  # noqa: E731
    model, secs, counts, peak = timed_fit(torch, lambda: build().train(fr))
    check_launches(counts, {}, "GLRM")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr), "GLRM")
    P = len(model.output["coef_names"])
    check(np.isfinite(model.output["objective"]), "GLRM objective")
    di = build_datainfo(fr, model.features, standardize=True,
                        use_all_factor_levels=True)
    mask = glrm.cell_mask(fr, di)
    G = mask @ glrm._pairs(model.Y.T)
    b = (di.X * mask) @ model.Y.T
    t_solve = time_ms(torch, lambda: glrm._ridge_solve(G, b, 0.1), reps=3)
    say(f"phase24c GLRM k={GLRM['k']} on {N_DIMRED} airlines rows (P = {P}, "
        f"{GLRM_NA:.0%} of the numeric cells NA): train {secs:.3f} s (refit "
        f"{t_re:.3f} s, bit-equal), {model.output['iterations']} steps, "
        f"objective {model.output['objective']:.6g}, peak device memory "
        f"{peak / 2**30:.3f} GiB (one [N, k, P] float32 einsum of the "
        f"reference's form: {REF_EINSUM_GB} GB); the batched {N_DIMRED} x "
        f"{GLRM['k']} x {GLRM['k']} solve (LU, torch.linalg.solve) "
        f"{spread(t_solve)}")
    del di, mask, G, b, fr
    frs = head_frames(gcols, domains, N_UNSUP_CPU, dev)
    ms = [build().train(f) for f in frs]
    say("phase24c GLRM quadratic " + glrm_card_vs_cpu(*ms, frs,
                                                      "GLRM head", False))
    for label, params in GLRM_HEAD_FITS:
        kw = dict(GLRM, init="Random", seed=3, **params)
        m, s, c, _ = timed_fit(torch, lambda k=kw: h2o.GLRMEstimator(
            **k).train(frs[0]))
        counts = {k: counts[k] + c[k] for k in counts}
        m_cpu = h2o.GLRMEstimator(**kw).train(frs[1])
        say(f"phase24c GLRM {label} ({s:.3f} s on the card): "
            + glrm_card_vs_cpu(m, m_cpu, frs, f"GLRM {label}", True))
    return counts


def nb_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """Naive Bayes card vs CPU plain: the statistics at the tests'
    tolerances, the card's probabilities against the CPU's scoring of
    the same statistics; the CPU fit's probability gap printed."""
    from h2o3_tpu_torch.parallel.device import fetch
    a, b = m_card.stats, m_cpu.stats
    sg = max([rel_gap(a["priors"], b["priors"])]
             + [rel_gap(x, y) for x, y in zip(a["cat_tables"],
                                              b["cat_tables"])])
    check(sg <= NB_STAT_TOL, f"{label}: priors / tables {sg:.3g}")
    mg = 0.0
    for mu_a, sd_a, mu, sd in zip(a["num_mu"], a["num_sd"], b["num_mu"],
                                  b["num_sd"]):
        mu, sd = np.asarray(mu, np.float64), np.asarray(sd, np.float64)
        ms = mu * mu + sd * sd
        mg = max(mg, float((np.abs(mu_a - mu) / np.sqrt(ms)).max()),
                 float((np.abs(sd_a - sd) * sd / ms).max()))
    bound = frs[1].nrows * 2.0 ** -24
    check(mg <= bound, f"{label}: moments {mg:.3g}")
    p_card = fetch(m_card._probs(frs[0]))
    pg = float(np.abs(p_card - fetch(m_card._probs(frs[1]))).max())
    check(pg <= NB_PROB_TOL, f"{label}: probabilities {pg:.3g}")
    fit_gap = float(np.abs(p_card - fetch(m_cpu._probs(frs[1]))).max())
    return (f"{frs[1].nrows}-row head card vs CPU plain: priors and tables "
            f"{sg:.3g} (<= {NB_STAT_TOL}), moments {mg:.3g} (<= "
            f"{bound:.3g} of their scale), the same statistics "
            f"scored {pg:.3g} (<= {NB_PROB_TOL}); the CPU fit's "
            f"probabilities {fit_gap:.3g} away (printed)")


def phase_naivebayes(torch, dev, cols, domains, ccols, cdomains):
    """Phase 24(d): Naive Bayes on phase 4's 5M airlines rows →
    IsDepDelayed (laplace 1): AUC, train and predict seconds, a refit;
    the Covertype schema (7 classes): logloss; 3-fold CV on 1M rows;
    heads card vs CPU. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    build = lambda: h2o.NaiveBayesEstimator(**NB)  # noqa: E731
    model, secs, counts, peak = timed_fit(torch,
                                          lambda: build().train(fr, y=Y))
    check_launches(counts, {}, "Naive Bayes")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr, y=Y),
                       "Naive Bayes")
    t0 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.col("p1").host_view()
    auc = model.training_metrics["AUC"]
    check(np.isfinite(p1).all() and abs(host_auc(p1, cols[Y] == 1) - auc)
          <= 5e-3 and auc > 0.6, f"Naive Bayes AUC {auc}")
    say(f"phase24d Naive Bayes laplace=1 on {N_MAIN} airlines rows: train "
        f"{secs:.3f} s (refit {t_re:.3f} s, bit-equal), predict "
        f"{t_pred:.3f} s, AUC {auc:.6f}, logloss "
        f"{model.training_metrics['logloss']:.6f}, peak "
        f"{peak / 2**30:.3f} GiB")
    frs = head_frames(cols, domains, N_UNSUP_CPU, dev)
    ms = [build().train(f, y=Y) for f in frs]
    say("phase24d Naive Bayes airlines " + nb_card_vs_cpu(*ms, frs,
                                                          "NB airlines"))
    cfr = h2o.Frame.from_numpy(ccols, domains=cdomains, device=dev)
    m, s, c, _ = timed_fit(torch, lambda: build().train(cfr, y="Cover_Type"))
    counts = {k: counts[k] + c[k] for k in counts}
    ll, err = m.training_metrics["logloss"], m.training_metrics["error_rate"]
    majority = 1 - max(COVTYPE_COUNTS) / N_COVTYPE
    check(np.isfinite(ll) and 0 <= err <= 1,
          f"Covertype logloss {ll}, error {err}")
    frs = head_frames(ccols, cdomains, N_UNSUP_CPU, dev)
    ms = [build().train(f, y="Cover_Type") for f in frs]
    say(f"phase24d Naive Bayes on the {N_COVTYPE}-row Covertype schema (7 "
        f"classes): {s:.3f} s, logloss {ll:.6f}, error rate {err:.6f} "
        f"(the majority class's {majority:.6f}; the 44 one-hot columns "
        "enter as Gaussian numerics); " + nb_card_vs_cpu(
            *ms, frs, "NB Covertype"))
    del cfr
    fh = h2o.Frame.from_numpy({k: v[:N_NB_CV] for k, v in cols.items()},
                              domains=domains, device=dev)
    m, s, c, _ = timed_fit(torch, lambda: h2o.NaiveBayesEstimator(
        nfolds=3, seed=1, **NB).train(fh, y=Y))
    counts = {k: counts[k] + c[k] for k in counts}
    cv = m.cross_validation_metrics["AUC"]
    check(abs(cv - m.training_metrics["AUC"]) <= 0.01, f"NB CV AUC {cv}")
    say(f"phase24d Naive Bayes 3-fold CV on {N_NB_CV} rows: {s:.3f} s, CV "
        f"AUC {cv:.6f} (training {m.training_metrics['AUC']:.6f})")
    return counts


def te_columns(cols, n: int):
    """The first ``n`` airlines rows and a modulo fold column."""
    out = {k: v[:n] for k, v in cols.items()}
    out["fold"] = np.arange(n) % N_TE_FOLDS
    return out


def te_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """Target Encoder card vs CPU plain: maps and every transform
    EXACT."""
    for col, m in m_cpu.enc_maps.items():
        q = m_card.enc_maps[col]
        check(np.array_equal(q["sum"], m["sum"])
              and np.array_equal(q["cnt"], m["cnt"])
              and q["prior"] == m["prior"], f"{label}: {col} maps")
    for kw in ({"as_training": True}, {}):
        a, b = (m.transform(fr, **kw) for m, fr in zip((m_card, m_cpu), frs))
        check(a.names == b.names and all(
            np.array_equal(a.col(c).host_view(), b.col(c).host_view(),
                           equal_nan=True) and a.col(c).domain ==
            b.col(c).domain for c in b.names), f"{label}: transform {kw}")
    return (f"{frs[1].nrows}-row head card vs CPU plain: maps and "
            "encodings EXACT")


def phase_targetencoder(torch, dev, cols, domains):
    """Phase 24(e): the Target Encoder on phase 4's 5M airlines rows
    (Origin, Dest, UniqueCarrier → IsDepDelayed; kfold over a 5-fold
    modulo column, blending, noise 0.01, seed 1234): fit and
    transform(as_training=True) seconds, a refit; ``none`` and ``loo`` on
    a head; each head card vs CPU EXACT. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    tcols = te_columns(cols, N_MAIN)
    fr = h2o.Frame.from_numpy(tcols, domains=domains, device=dev)
    x = list(TE_COLS)
    build = lambda: h2o.TargetEncoderEstimator(**TE)  # noqa: E731
    model, secs, _, _ = timed_fit(torch, lambda: build().train(fr, y=Y, x=x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(fr, as_training=True)
    torch.cuda.synchronize()
    t_tr = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check_launches(counts, {}, "Target Encoder")
    again = build().train(fr, y=Y, x=x)
    check(all(np.array_equal(again.enc_maps[c]["sum"],
                             model.enc_maps[c]["sum"]) for c in x),
          "Target Encoder: the refit is not bit-equal")
    enc = [out.col(f"{c}_te").host_view() for c in x]
    check(out.names == fr.names + [f"{c}_te" for c in x]
          and all(np.isfinite(e).all() for e in enc),
          "Target Encoder encodings")
    say(f"phase24e Target Encoder kfold ({N_TE_FOLDS} folds) on {N_MAIN} "
        f"airlines rows, {', '.join(x)}: fit {secs:.3f} s (refit bit-equal)"
        f", transform(as_training=True) {t_tr:.3f} s, encodings' means "
        f"{[round(float(e.mean()), 6) for e in enc]}")
    del fr, out
    frs = head_frames(tcols, domains, N_UNSUP_CPU, dev)
    for handling in ("kfold", "none", "loo"):
        kw = dict(TE, data_leakage_handling=handling)
        ms = [h2o.TargetEncoderEstimator(**kw).train(f, y=Y, x=x)
              for f in frs]
        say(f"phase24e Target Encoder {handling}: " + te_card_vs_cpu(
            *ms, frs, f"TE {handling}"))
    return counts


def phase_unsupervised(torch, dev, cols, domains, ccols, cdomains, higgs):
    """Phase 24: KMeans (on ``higgs_frame``'s data), PCA and SVD, GLRM,
    Naive Bayes and the Target Encoder (no kernel: cuBLAS products with
    TF32 off, cuSOLVER factorizations, fixed-point segment sums, plain
    torch). Returns the launches of its six paths (every kernel 0 on
    each)."""
    t0 = time.perf_counter()
    paths = {"kmeans": phase_kmeans(torch, dev, higgs)}
    secs = {"a": time.perf_counter() - t0}
    paths.update(phase_pca(torch, dev, cols, domains))
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    paths["glrm"] = phase_glrm(torch, dev, cols, domains)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    paths["naivebayes"] = phase_naivebayes(torch, dev, cols, domains, ccols,
                                           cdomains)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    paths["targetencoder"] = phase_targetencoder(torch, dev, cols, domains)
    secs["e"] = time.perf_counter() - t0 - sum(secs.values())
    for p, c in paths.items():
        check(not any(c.values()), f"{p}: a kernel launched")
    say("phase24: " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s; every kernel 0 launches "
        f"on {', '.join(paths)}")
    return paths


# ---------------------------------------------------------------- phase 25


@contextlib.contextmanager
def stage_seconds(torch, stages):
    """Seconds spent in named functions while the block runs: ``stages``
    maps a label to (module or class, attribute) pairs; each call waits
    for the device before and after. Yields the label → seconds dict."""
    secs = {label: 0.0 for label in stages}
    patches = []
    for label, targets in stages.items():
        for owner, name in targets:
            fn = getattr(owner, name)

            def timed(*a, _fn=fn, _label=label, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    secs[_label] += time.perf_counter() - t0
            patches.append(mock.patch.object(owner, name, timed))
    with contextlib.ExitStack() as stack:
        for pt in patches:
            stack.enter_context(pt)
        yield secs


def level_launches(n_trees: int, max_depth: int) -> dict:
    """Each level kernel once a level of every tree (trees are laid out
    at the depth bucket), the others 0."""
    from h2o3_tpu_torch.models.tree import bucket_depth
    n = n_trees * bucket_depth(max_depth)
    return {k: n for k in LEVEL_KERNELS}


def gam_f64_fixed_point(model, frame):
    """The float64 PIRLS fixed point on ``model``'s float32 design of
    ``frame`` (on the host; six steps from the model's coefficients):
    (the model's coefficients' and scores' distances to it, cond(A))."""
    from h2o3_tpu_torch.models.gam import penalty_matrix
    from h2o3_tpu_torch.models.model import adapt_domain
    X = model._design(frame).double().cpu()[:frame.nrows]
    fam, rc = model.family, frame.col(model.output["response"])
    yv = (np.maximum(adapt_domain(rc, model.output["domain"]), 0)
          if model.output["category"] == "Binomial" else rc.host_view())
    import torch
    y = torch.from_numpy(np.asarray(yv, np.float64))
    n_lin = X.shape[1] - 1 - sum(len(s["means"]) for s in model.gam_spec)
    Pm = torch.from_numpy(penalty_matrix(n_lin, model.gam_spec,
                                         model.params)).double()
    Pm += 1e-7 * torch.eye(X.shape[1], dtype=torch.float64)
    c = torch.from_numpy(np.asarray(model.coef, np.float64))
    for _ in range(6):
        eta = X @ c
        mu = fam.linkinv(eta)
        d = fam.dmu_deta(eta, mu)
        z = eta + (y - mu) / d
        wi = d * d / fam.variance(mu)
        A = (X * wi[:, None]).T @ X / X.shape[0] + Pm
        c = torch.linalg.solve(A, X.T @ (wi * z) / X.shape[0])
    p64 = fam.linkinv(X @ c).numpy()
    key = "p1" if model.output["category"] == "Binomial" else "predict"
    return (float(np.abs(np.asarray(model.coef, np.float64)
                         - c.numpy()).max()),
            float(np.abs(model._score_raw(frame)[key] - p64).max()),
            float(torch.linalg.cond(A)))


def gam_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """GAM card vs CPU plain: knots EXACT, centering means within 1e-12,
    PIRLS steps equal; coefficients and predictions within the tests'
    tolerances or, on a worse-conditioned design, within 4x the CPU
    fit's own distance to the float64 PIRLS fixed point (the float32
    Cholesky's error, which LAPACK and cuSOLVER make apart; the card's
    own distance is held to the same bound)."""
    for a, b in zip(m_card.gam_spec, m_cpu.gam_spec):
        check(np.array_equal(a["knots"], b["knots"])
              and np.abs(a["means"] - b["means"]).max() <= 1e-12,
              f"{label}: knots or means")
    check(m_card.output["pirls_iterations"] ==
          m_cpu.output["pirls_iterations"], f"{label}: PIRLS steps")
    cg = float(np.abs(m_card.coef - m_cpu.coef).max())
    key = "p1" if m_cpu.output["category"] == "Binomial" else "predict"
    pg = float(np.abs(m_card._score_raw(frs[0])[key]
                      - m_cpu._score_raw(frs[1])[key]).max())
    ec, ep, cond = gam_f64_fixed_point(m_cpu, frs[1])
    ec_card, ep_card, _ = gam_f64_fixed_point(m_card, frs[1])
    ctol, ptol = max(GAM_COEF_TOL, 4 * ec), max(GAM_PRED_TOL, 4 * ep)
    check(max(cg, ec_card) <= ctol and max(pg, ep_card) <= ptol,
          f"{label}: coefficients {cg} (card to float64 {ec_card}), "
          f"predictions {pg} (card {ep_card}); limits {ctol}, {ptol}")
    return (f"{frs[1].nrows}-row head card vs CPU plain: knots EXACT, PIRLS "
            f"steps equal ({m_cpu.output['pirls_iterations']}), "
            f"coefficients {cg:.3g}, predictions {pg:.3g} (limits {ctol:.3g}"
            f", {ptol:.3g}: the CPU fit {ec:.3g} and {ep:.3g} from the "
            f"float64 fixed point, the card's {ec_card:.3g} and "
            f"{ep_card:.3g}; cond(A) {cond:.3g})")


def sin_columns(n: int, seed: int = 4):
    """tests/test_gam.py's planted signal: x ~ U(-3, 3), lin ~ N(0, 1),
    f = sin(1.7x) + 0.5·lin, y = f + N(0, 0.15²). Returns (cols, f)."""
    r = np.random.RandomState(seed)
    x = r.uniform(-3, 3, n)
    lin = r.randn(n)
    f = np.sin(1.7 * x) + 0.5 * lin
    return {"x": x, "lin": lin, "y": f + r.randn(n) * 0.15}, f


def phase_gam(torch, dev, higgs):
    """Phase 25(a): GAM on phase 22(a)'s HIGGS frame (11M x 28, nothing
    cut), binomial, x0..x2 as splines; the basis on its own; one Gram
    pass against its bound; a head card vs CPU; the planted-signal
    gaussian GAM on N_GAM_SIN rows. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import gam as gam_mod
    from h2o3_tpu_torch.ops.gram import gram
    cols, domains, _, fr = higgs
    x = [c for c in cols if c != "y"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = [gam_mod._spline_block(fr, {"col": c, "knots": gam_mod.gam_knots(
        fr.col(c).host_view(), k)}, fr.nrows_padded)[0]
        for c, k in zip(GAM_HIGGS["gam_columns"], GAM_HIGGS["num_knots"])]
    torch.cuda.synchronize()
    t_basis = time.perf_counter() - t0
    del blocks
    build = lambda: h2o.GAMEstimator(**GAM_HIGGS)  # noqa: E731
    model, secs, counts, peak = timed_fit(
        torch, lambda: build().train(fr, y="y", x=x))
    check_launches(counts, {}, "GAM")
    t_re = refit_check(torch, build, model,
                       lambda e: e.train(fr, y="y", x=x), "GAM")
    auc = model.training_metrics["AUC"]
    steps = model.output["pirls_iterations"]
    check(len(model.coef) == P_GAM and np.isfinite(model.coef).all()
          and auc > 0.8, f"GAM: P {len(model.coef)}, AUC {auc}")
    say(f"phase25a GAM binomial on {N_HIGGS} x {P_HIGGS} (x0..x2 splines, "
        f"10 knots, P = {P_GAM}): train {secs:.3f} s (refit {t_re:.3f} s, "
        f"bit-equal), the three bases alone {t_basis:.3f} s, {steps} PIRLS "
        f"steps, AUC {auc:.6f}, residual deviance "
        f"{model.output['residual_deviance']:.8g}, peak "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    X1 = model._design(fr)
    w = fr.valid_weights()
    z = torch.ones_like(w)
    t = time_ms(torch, lambda: gram(X1, w, z), reps=5)
    n, P = X1.shape
    b_bytes = n * (P + 2) * 4 / HBM_BYTES_PER_S * 1e3
    b_ops = 2.0 * n * P * P / F32_OPS_PER_S * 1e3
    say(f"phase25a one Gram pass [{n}, {P}]: {spread(t)} device, host-paced "
        f"{t['host_paced_ms']:.4f} ms (bound {max(b_bytes, b_ops):.4f} ms: "
        f"bytes {b_bytes:.4f}, float32 operations {b_ops:.4f})")
    del X1, w, z
    frs = head_frames(cols, domains, N_P25_HEAD, dev)
    hb = lambda: h2o.GAMEstimator(**GAM_HIGGS_HEAD)  # noqa: E731
    ms = [hb().train(f, y="y", x=x) for f in frs]
    say("phase25a GAM HIGGS (beta_epsilon 1e-3) " + gam_card_vs_cpu(
        *ms, frs, "GAM HIGGS"))
    scols, f = sin_columns(N_GAM_SIN)
    sfr = h2o.Frame.from_numpy(scols, device=dev)
    sb = lambda: h2o.GAMEstimator(**GAM_SIN)  # noqa: E731
    m, s, c, _ = timed_fit(torch, lambda: sb().train(sfr, y="y",
                                                     x=["lin", "x"]))
    check_launches(c, {}, "GAM gaussian")
    counts = {k: counts[k] + c[k] for k in counts}
    refit_check(torch, sb, m, lambda e: e.train(sfr, y="y", x=["lin", "x"]),
                "GAM gaussian")
    rmse = float(np.sqrt(np.mean((m.predict(sfr).col("predict").host_view()
                                  - f) ** 2)))
    g = h2o.GLMEstimator(lambda_=0.0).train(sfr, y="y", x=["lin", "x"])
    g_rmse = float(np.sqrt(np.mean((g.predict(sfr).col("predict")
                                    .host_view() - f) ** 2)))
    check(rmse < 0.15 and g_rmse > 0.4,
          f"GAM planted signal: RMSE {rmse}, GLM {g_rmse}")
    frs = head_frames(scols, {}, N_P25_HEAD, dev)
    ms = [sb().train(fh, y="y", x=["lin", "x"]) for fh in frs]
    say(f"phase25a GAM gaussian on {N_GAM_SIN} rows, sin(1.7x) + 0.5·lin "
        f"planted: {s:.3f} s (refit bit-equal), RMSE to the truth {rmse:.6f} "
        f"(< 0.15; a GLM's {g_rmse:.6f} > 0.4); "
        + gam_card_vs_cpu(*ms, frs, "GAM gaussian"))
    return counts


def rulefit_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """RuleFit card vs CPU plain (sample_rate 1): rules and winsor bounds
    EXACT, GLM coefficients and predictions at the tests' tolerances."""
    keys = ("model", "tree", "lo", "hi", "name", "lang", "support")
    rules = [[{k: r[k] for k in keys} for r in m.rules]
             for m in (m_card, m_cpu)]
    check(rules[0] == rules[1] and m_card.winsor == m_cpu.winsor,
          f"{label}: rules or winsor bounds differ")
    ca, cb = (np.array(list(m.glm_model.coefficients.values()))
              for m in (m_card, m_cpu))
    key = "p1" if m_cpu.output["category"] == "Binomial" else "predict"
    pa, pb = (m._score_raw(fr)[key] for m, fr in zip((m_card, m_cpu), frs))
    cg, pg = float(np.abs(ca - cb).max()), float(np.abs(pa - pb).max())
    check(cg <= RF_COEF_TOL and pg <= RF_PRED_TOL,
          f"{label}: coefficients {cg}, predictions {pg}")
    return (f"{frs[1].nrows}-row head card vs CPU plain at sample_rate 1: "
            f"{len(m_cpu.rules)} rules and the winsor bounds EXACT, GLM "
            f"coefficients {cg:.3g} (<= {RF_COEF_TOL}), predictions "
            f"{pg:.3g} (<= {RF_PRED_TOL})")


def rule_columns(n: int, seed: int = 3):
    """tests/test_torch_rulefit.py's tie-free data: continuous x1, x2, x3
    (3% NA), a 5-level c, y = 3 where x1 > 5 and x2 < 3, + 0.5·x3 + 1 on
    level "c" + noise, as a binomial IsDepDelayed-like "y" (its sign
    against the median). Returns (columns, domains)."""
    r = np.random.RandomState(seed)
    x1, x2 = r.uniform(0, 10, n), r.uniform(0, 10, n)
    x3 = r.randn(n)
    cat = r.randint(0, 5, n)
    f = (np.where((x1 > 5) & (x2 < 3), 3.0, 0.0) + 0.5 * x3
         + (cat == 2) * 1.0 + r.randn(n) * 0.3)
    x3[r.rand(n) < 0.03] = np.nan
    return ({"x1": x1, "x2": x2, "x3": x3, "c": cat,
             "y": (f > np.median(f)).astype(np.int32)},
            {"c": list("abcde"), "y": ["lo", "hi"]})


def infogram_columns(n: int, seed: int = 12):
    """tests/test_torch_infogram.py's tie-free data: y ~ logistic(1.6·x1
    + x2 + 0.4·x3 + 0.8·[c = q]), x4 noise, g (protected) following x1.
    Returns (columns, domains)."""
    r = np.random.RandomState(seed)
    x1, x2, x3, x4 = (r.uniform(-2, 2, n) for _ in range(4))
    g = (x1 + 0.7 * r.randn(n) > 0).astype(int) + (r.rand(n) < 0.3)
    c = r.randint(0, 4, n)
    eta = 1.6 * x1 + 1.0 * x2 + 0.4 * x3 + 0.8 * (c == 1)
    y = (r.rand(n) < 1 / (1 + np.exp(-eta))).astype(np.int32)
    return ({"x1": x1, "x2": x2, "x3": x3, "x4": x4, "c": c, "g": g,
             "y": y}, {"c": list("pqrs"), "g": ["u", "v", "w"],
                       "y": ["no", "yes"]})


def phase_rulefit(torch, dev, cols, domains):
    """Phase 25(b): RuleFit with the reference's defaults on the first
    N_RULEFIT airlines rows → IsDepDelayed: the seconds of its stages,
    rules, AUC, the top five rules; DRF and linear-only on a head; the
    head's rules card vs CPU. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import rulefit as rf_mod
    from h2o3_tpu_torch.models.gbm import GBMEstimator
    from h2o3_tpu_torch.models.glm import GLMEstimator
    head = {k: v[:N_RULEFIT] for k, v in cols.items()}
    fr = h2o.Frame.from_numpy(head, domains=domains, device=dev)
    build = lambda: h2o.RuleFitEstimator(**RULEFIT)  # noqa: E731
    stages = {"trees": [(GBMEstimator, "train")],
              "rule frame": [(rf_mod, "rule_masks"), (rf_mod, "rule_columns"),
                             (rf_mod, "linear_columns")],
              "GLM": [(GLMEstimator, "train")]}
    with stage_seconds(torch, stages) as st:
        model, secs, counts, peak = timed_fit(
            torch, lambda: build().train(fr, y=Y))
    want = level_launches(50, 3)
    check_launches(counts, want, "RuleFit")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr, y=Y),
                       "RuleFit")
    auc = model.training_metrics["AUC"]
    n_rules = model.output["n_rules"]
    check(0 < n_rules <= 400 and auc > 0.6 and len(model.linear_cols) == 7,
          f"RuleFit: {n_rules} rules, AUC {auc}")
    say(f"phase25b RuleFit defaults (GBM, length 3, 50 trees, sample_rate "
        f"0.8, rules and linear, lambda search) on {N_RULEFIT} airlines rows"
        f": train {secs:.3f} s (refit {t_re:.3f} s, bit-equal): trees "
        f"{st['trees']:.3f} s, rule frame {st['rule frame']:.3f} s, GLM "
        f"{st['GLM']:.3f} s; {n_rules} rules, "
        f"{len(model.rule_importance)} terms kept, AUC {auc:.6f}, peak "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    for d in model.rule_importance[:5]:
        text = d["rule"] if len(d["rule"]) <= 160 else \
            d["rule"][:157] + "..."
        say(f"phase25b rule {d['coefficient']:+.6f} (support "
            f"{d['support']:.4f}): {text}")
    del fr
    frs = head_frames(cols, domains, N_RULEFIT_HEAD, dev)
    for label, kw in (("DRF", dict(algorithm="drf")),
                      ("linear", dict(model_type="linear"))):
        m, s, c, _ = timed_fit(torch, lambda: h2o.RuleFitEstimator(
            **RULEFIT, **kw).train(frs[0], y=Y))
        n_trees = 0 if label == "linear" else 50
        check_launches(c, level_launches(n_trees, 3) if n_trees else {},
                       f"RuleFit {label}")
        check(np.isfinite(m._score_raw(frs[0])["p1"]).all(),
              f"RuleFit {label} scores")
        say(f"phase25b RuleFit {label} on {N_RULEFIT_HEAD} rows: {s:.3f} s, "
            f"{m.output['n_rules']} rules, AUC "
            f"{m.training_metrics['AUC']:.6f}")
    # card vs CPU on tie-free data: airlines' integer columns hold
    # near-tie splits, which fixed-point and float32 sums may order apart
    frs = head_frames(*rule_columns(N_RULEFIT_HEAD), N_RULEFIT_HEAD, dev)
    ms = [h2o.RuleFitEstimator(**RULEFIT, sample_rate=1.0).train(f, y="y")
          for f in frs]
    say("phase25b RuleFit (tests' data) " + rulefit_card_vs_cpu(
        *ms, frs, "RuleFit"))
    return counts


def selection_card_vs_cpu(m_card, m_cpu, label) -> str:
    """ModelSelection card vs CPU plain: the chosen set at every size
    equal, r2 within 1e-5 relative."""
    a, b = m_card.result(), m_cpu.result()
    check([r["predictors"] for r in a] == [r["predictors"] for r in b],
          f"{label}: chosen sets differ")
    gap = rel_gap([r["r2"] for r in a], [r["r2"] for r in b])
    check(gap <= SEL_R2_TOL, f"{label}: r2 {gap}")
    return f"sets equal at {len(a)} sizes, r2 {gap:.3g} (<= {SEL_R2_TOL})"


def anova_card_vs_cpu(m_card, m_cpu, label) -> str:
    """ANOVA-GLM card vs CPU plain: df EXACT, each statistic within
    2^-16 of the full deviance, each p-value between the chi-square
    tails that bound allows."""
    from scipy.stats import chi2
    bound = ANOVA_LR_TOL * m_cpu.output["full_deviance"]
    worst = 0.0
    for a, b in zip(m_card.anova_table, m_cpu.anova_table):
        check(a["term"] == b["term"] and a["df"] == b["df"],
              f"{label}: terms or df")
        gap = abs(a["deviance"] - b["deviance"])
        worst = max(worst, gap)
        lo, hi = (chi2.sf(max(b["deviance"] + s * bound, 0.0), b["df"])
                  for s in (1, -1))
        check(gap <= bound and lo <= a["p_value"] <= hi,
              f"{label}: {a['term']} statistic {gap}")
    return (f"{len(m_cpu.anova_table)} terms, df EXACT, statistics "
            f"{worst:.3g} apart (<= {bound:.3g}, 2^-16 of the deviance)")


def phase_selection(torch, dev, higgs):
    """Phase 25(c): ModelSelection maxr and ANOVA-GLM on the first N_SEL
    HIGGS rows; backward and allsubsets over x0..x6 and the ANOVA table
    on a head card vs CPU. Returns the two paths' launches."""
    import h2o3_tpu_torch as h2o
    hcols, domains, beta, _ = higgs
    cols = {k: v[:N_SEL] for k, v in hcols.items()}
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    x = [c for c in cols if c != "y"]
    build = lambda: h2o.ModelSelectionEstimator(**SEL_MAXR)  # noqa: E731
    model, secs, counts, peak = timed_fit(
        torch, lambda: build().train(fr, y="y", x=x))
    check_launches(counts, {}, "ModelSelection")
    t_re = refit_check(torch, build, model,
                       lambda e: e.train(fr, y="y", x=x), "ModelSelection")
    fits = model.output["n_glm_fits"]
    # the k largest |beta|, up to what 1M rows resolve: a tie within two
    # standard errors of a coefficient may go either way
    order = np.argsort(-np.abs(beta))
    se = 2.0 / np.sqrt(N_SEL * 0.19)
    for r in model.result():
        k = r["size"]
        sure = {f"x{i}" for i in order[:k]
                if abs(beta[i]) - abs(beta[order[k]]) > se}
        near = {f"x{i}" for i in order
                if abs(abs(beta[i]) - abs(beta[order[k - 1]])) <= se}
        got = set(r["predictors"])
        check(sure <= got and got <= sure | near,
              f"ModelSelection size {k}: {sorted(got)}, beta's "
              f"{sorted(sure)} (+ one of {sorted(near)})")
    say(f"phase25c ModelSelection maxr (3 of {len(x)}) on {N_SEL} HIGGS rows"
        f": {fits} GLM fits in {secs:.3f} s ({secs / fits * 1e3:.2f} ms a "
        f"fit; refit {t_re:.3f} s, bit-equal), peak {peak / 2**30:.3f} GiB; "
        + "; ".join(f"size {r['size']} {r['predictors']} r2 {r['r2']:.6f}"
                    for r in model.result())
        + f"; the largest |beta|: "
        + ", ".join(f"x{i} {beta[i]:+.3f}" for i in order[:4]))
    ab = lambda: h2o.ANOVAGLMEstimator()  # noqa: E731
    am, asecs, ac, apeak = timed_fit(
        torch, lambda: ab().train(fr, y="y", x=list(SEL_X)))
    check_launches(ac, {}, "ANOVA-GLM")
    t_are = refit_check(torch, ab, am, lambda e: e.train(
        fr, y="y", x=list(SEL_X)), "ANOVA-GLM")
    check(fr.names == list(cols), "ANOVA-GLM changed the caller's frame")
    for r in am.anova_table:
        if ":" not in r["term"] and abs(beta[int(r["term"][1:])]) > 0.1:
            check(r["p_value"] < 1e-6, f"ANOVA {r['term']} p {r['p_value']}")
    n_terms = len(am.anova_table)
    check(n_terms == 28 and am.output["n_glm_fits"] == 29, "ANOVA terms")
    say(f"phase25c ANOVA-GLM over x0..x6 with pairwise products on {N_SEL} "
        f"rows: {n_terms} terms, 29 GLM fits in {asecs:.3f} s (refit "
        f"{t_are:.3f} s, bit-equal), peak {apeak / 2**30:.3f} GiB; "
        + ", ".join(f"{r['term']} {r['deviance']:.6g} (p {r['p_value']:.3g})"
                    for r in am.anova_table[:7]))
    del fr
    frs = head_frames(hcols, domains, N_P25_HEAD, dev)
    for mode in ("backward", "allsubsets"):
        ms = [h2o.ModelSelectionEstimator(mode=mode).train(
            f, y="y", x=list(SEL_X)) for f in frs]
        say(f"phase25c ModelSelection {mode} over x0..x6, {N_P25_HEAD}-row "
            f"head card vs CPU plain: " + selection_card_vs_cpu(
                *ms, f"ModelSelection {mode}"))
    ms = [ab().train(f, y="y", x=list(SEL_X)) for f in frs]
    say("phase25c ANOVA-GLM head card vs CPU plain: "
        + anova_card_vs_cpu(*ms, "ANOVA-GLM"))
    return counts, ac


def phase_isotonic(torch, dev, cols):
    """Phase 25(d): Isotonic Regression of the departure delay on
    DepTime over phase 4's N_MAIN rows; thresholds EXACT card vs CPU at
    full size. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    icols = {"DepTime": cols["DepTime"], "delay": airlines_delay(N_MAIN)}
    frs = [h2o.Frame.from_numpy(icols, device=d) for d in (dev, "cpu")]
    build = lambda: h2o.IsotonicRegressionEstimator()  # noqa: E731
    model, secs, counts, _ = timed_fit(
        torch, lambda: build().train(frs[0], y="delay", x=["DepTime"]))
    check_launches(counts, {}, "Isotonic")
    t_re = refit_check(torch, build, model, lambda e: e.train(
        frs[0], y="delay", x=["DepTime"]), "Isotonic")
    cpu = build().train(frs[1], y="delay", x=["DepTime"])
    check(np.array_equal(model.tx, cpu.tx) and np.array_equal(model.ty,
                                                               cpu.ty),
          "Isotonic thresholds card vs CPU")
    n_t = len(model.tx)
    slope = np.polyfit(model.tx.astype(np.float64), model.ty, 1)[0]
    mse = model.training_metrics["MSE"]
    check(0 < n_t <= 2400 and np.all(np.diff(model.ty) >= 0)
          and 0.02 < slope < 0.04, f"Isotonic: {n_t} thresholds, slope "
                                   f"{slope}")
    say(f"phase25d Isotonic Regression delay ~ DepTime on {N_MAIN} rows: "
        f"{secs:.3f} s (refit {t_re:.3f} s, bit-equal), {n_t} thresholds, "
        f"slope {slope:.5f} a minute (0.03 planted), MSE {mse:.6f}; "
        "thresholds and fitted values EXACT card vs CPU plain")
    return counts


def infogram_card_vs_cpu(m_card, m_cpu, label) -> str:
    """Infogram card vs CPU plain: relevance within 1e-5, raw CMI within
    2e-6, admissible sets equal."""
    ta, tb = (m.output["infogram_table"] for m in (m_card, m_cpu))
    rel = max(abs(a["relevance"] - b["relevance"]) for a, b in zip(ta, tb))
    cmi = max(abs(a["cmi_raw"] - b["cmi_raw"]) for a, b in zip(ta, tb))
    check([r["column"] for r in ta] == [r["column"] for r in tb]
          and rel <= IG_REL_TOL and cmi <= IG_CMI_TOL
          and m_card.admissible_features == m_cpu.admissible_features,
          f"{label}: relevance {rel}, cmi {cmi}, admissible "
          f"{m_card.admissible_features} vs {m_cpu.admissible_features}")
    return (f"relevance {rel:.3g} (<= {IG_REL_TOL}), raw CMI {cmi:.3g} "
            f"(<= {IG_CMI_TOL}), admissible {m_cpu.admissible_features} "
            "equal")


def phase_infogram(torch, dev, cols, domains):
    """Phase 25(e): the core and the fair Infogram on the first
    N_INFOGRAM airlines rows → IsDepDelayed; heads card vs CPU. Returns
    the path's launches (both fits)."""
    import h2o3_tpu_torch as h2o
    head = {k: v[:N_INFOGRAM] for k, v in cols.items()}
    fr = h2o.Frame.from_numpy(head, domains=domains, device=dev)
    # card vs CPU on tie-free data, as RuleFit's (phase 25(b))
    frs = head_frames(*infogram_columns(N_P25_HEAD), N_P25_HEAD, dev)
    counts = None
    for label, kw in (("core", {}),
                      ("fair", {"protected_columns": ["UniqueCarrier"]})):
        build = lambda kw=kw: h2o.InfogramEstimator(**INFOGRAM, **kw)  # noqa
        model, secs, c, peak = timed_fit(torch, lambda: build().train(fr,
                                                                      y=Y))
        fits = model.output["gbm_fits"]
        check_launches(c, level_launches(fits * 10, 5), f"Infogram {label}")
        counts = c if counts is None else {k: counts[k] + c[k]
                                           for k in counts}
        t_re = refit_check(torch, build, model, lambda e: e.train(fr, y=Y),
                           f"Infogram {label}")
        adm = model.admissible_features
        # CRSDepTime is DepTime less U(-10, 60) minutes: in the core
        # infogram each carries what the other would add, so neither's
        # net information clears 0.1; the carrier's does. With the
        # carrier protected, both times are admissible.
        rel = {r["column"]: r for r in model.output["infogram_table"]}
        if label == "core":
            times = [rel[c] for c in ("DepTime", "CRSDepTime")]
            check("UniqueCarrier" in adm
                  and max(r["relevance"] for r in times) == 1.0
                  and max(r["cmi"] for r in times) < 0.1,
                  f"Infogram core: admissible {adm}")
        else:
            check({"DepTime", "CRSDepTime"} <= set(adm),
                  f"Infogram fair: admissible {adm}")
        say(f"phase25e Infogram {label} on {N_INFOGRAM} airlines rows: "
            f"{fits} GBM fits in {secs:.3f} s (refit {t_re:.3f} s, "
            f"bit-equal), peak {peak / 2**30:.3f} GiB, admissible {adm}; "
            + ", ".join(f"{r['column']} {r['relevance']:.4f}/{r['cmi']:.4f}"
                        for r in model.output["infogram_table"]))
        hkw = {"protected_columns": ["g"]} if kw else {}
        ms = [h2o.InfogramEstimator(**INFOGRAM, **hkw).train(f, y="y")
              for f in frs]
        say(f"phase25e Infogram {label} on {N_P25_HEAD} rows of the tests' "
            "data, card vs CPU plain: " + infogram_card_vs_cpu(
                *ms, f"Infogram {label}"))
    return counts


def phase_glm_wrappers(torch, dev, cols, domains, higgs):
    """Phase 25: GAM (on ``higgs_frame``'s data), RuleFit, ModelSelection
    and ANOVA-GLM, Isotonic Regression and Infogram. Returns the launches
    of their six paths (the level kernels on RuleFit's and Infogram's,
    every kernel 0 on the others)."""
    t0 = time.perf_counter()
    paths = {"gam": phase_gam(torch, dev, higgs)}
    secs = {"a": time.perf_counter() - t0}
    paths["rulefit"] = phase_rulefit(torch, dev, cols, domains)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    paths["modelselection"], paths["anovaglm"] = phase_selection(
        torch, dev, higgs)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    paths["isotonic"] = phase_isotonic(torch, dev, cols)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    paths["infogram"] = phase_infogram(torch, dev, cols, domains)
    secs["e"] = time.perf_counter() - t0 - sum(secs.values())
    for p in ("gam", "modelselection", "anovaglm", "isotonic"):
        check(not any(paths[p].values()), f"{p}: a kernel launched")
    say("phase25: " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s")
    return paths


# ---------------------------------------------------------------- phase 26


def cox_columns(n: int, seed: int = 26):
    """Survival data with a known beta: ten standard normal covariates,
    a 5-level categorical ``c5`` (COX_CAT_BETA against its first level),
    strata ``s4`` (4 levels) scaling an exponential baseline hazard with
    a median near COX_MEDIAN days, entry times U(0, 300) days with only
    rows surviving past their entry kept (left truncation: the
    ``start`` column), censoring at entry + Exp(COX_CENSOR_MEAN) and at
    3650 days, times rounded to whole days (many ties). Returns
    (columns, domains, beta of the design's 14 columns)."""
    r = np.random.RandomState(seed)
    beta = np.r_[COX_NUM_BETA, COX_CAT_BETA]
    m = int(n * 1.4) + 1000
    X = r.randn(m, 10)
    c5 = r.randint(0, 5, m)
    s4 = r.randint(0, 4, m)
    eta = X @ COX_NUM_BETA + np.r_[0.0, COX_CAT_BETA][c5]
    lam = np.log(2) / COX_MEDIAN * np.array([1.0, 1.3, 0.8, 1.6])[s4]
    t = -np.log(r.rand(m)) / (lam * np.exp(eta))
    entry = r.uniform(0, 300, m)
    cens = np.minimum(entry + r.exponential(COX_CENSOR_MEAN, m), 3650.0)
    keep = np.flatnonzero((t > entry) & (cens > entry))[:n]
    check(len(keep) == n, "cox_columns: too few rows survive their entry")
    obs = np.minimum(t, cens)[keep]
    cols = {f"x{i}": X[keep, i].astype(np.float32) for i in range(10)}
    cols.update(c5=c5[keep].astype(np.int32), s4=s4[keep].astype(np.int32),
                start=np.floor(entry[keep]),
                stop=np.clip(np.ceil(obs), 1, 3650),
                event=(t[keep] <= cens[keep]).astype(np.int32))
    domains = {"c5": [f"c{i}" for i in range(5)],
               "s4": [f"s{i}" for i in range(4)], "event": ["0", "1"]}
    return cols, domains, beta


def cox_risk_arrays(fr):
    """The host inputs of ``coxph._risk_structure`` for ``fr``."""
    codes = np.nan_to_num(fr.col("s4").host_view()).astype(np.int64)
    return (fr.col("start").to_numpy(), fr.col("stop").to_numpy(),
            np.nan_to_num(fr.col("event").to_numpy()), codes)


def cox_card_vs_cpu(m_card, m_cpu, label) -> str:
    """CoxPH card vs CPU plain at tests/test_torch_coxph.py's
    tolerances: coefficients COX_COEF_TOL, se_coef COX_SE_REL,
    loglik COX_LOGLIK_REL, concordance COX_CONC_TOL."""
    se = lambda m: np.array([t["se_coef"]  # noqa: E731
                             for t in m.output["coefficients_table"]])
    dc = float(np.abs(m_card.coef - m_cpu.coef).max())
    ds = rel_gap(se(m_card), se(m_cpu))
    dl = abs(m_card.output["loglik"] / m_cpu.output["loglik"] - 1)
    dk = abs(m_card.training_metrics["concordance"]
             - m_cpu.training_metrics["concordance"])
    check(dc <= COX_COEF_TOL and ds <= COX_SE_REL and dl <= COX_LOGLIK_REL
          and dk <= COX_CONC_TOL,
          f"{label}: coef {dc}, se {ds}, loglik {dl}, concordance {dk}")
    return (f"coef {dc:.3g} (<= {COX_COEF_TOL}), se_coef {ds:.3g} "
            f"(<= {COX_SE_REL}), loglik {dl:.3g} (<= {COX_LOGLIK_REL}), "
            f"concordance {dk:.3g} (<= {COX_CONC_TOL})")


def scan_gaps(torch, dev, fr) -> str:
    """How far the card's prefix sums of w·exp(eta) over the rows sorted
    by stop time are from float64 ``np.cumsum``: the port's float64
    block products (``coxph.prefix_sums``) and a float32 ``cumsum``."""
    from h2o3_tpu_torch.models.coxph import prefix_sums
    order = np.lexsort((-fr.col("stop").to_numpy(),
                        fr.col("s4").host_view()))
    v = np.exp(0.3 * fr.col("x0").to_numpy())[order]
    want = np.cumsum(v)
    got64 = prefix_sums(torch.from_numpy(v[:, None]).to(dev))[:, 0]
    got32 = torch.cumsum(torch.from_numpy(v.astype(np.float32)).to(dev), 0)
    return (f"prefix sums over {len(v)} rows: float64 block products "
            f"{rel_gap(got64.cpu().numpy(), want):.3g}, float32 cumsum "
            f"{rel_gap(got32.cpu().numpy(), want):.3g} of the float64 "
            "cumsum (relative)")


def phase_coxph(torch, dev):
    """Phase 26(a): CoxPH on N_COX rows from ``cox_columns`` (strata,
    left truncation, heavy ties), Efron then Breslow; the risk structure
    card vs CPU EXACT and a fit card vs CPU plain on a head. Returns the
    path's launches (both fits)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import coxph
    cols, domains, beta = cox_columns(N_COX)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    t0 = time.perf_counter()
    rs = coxph._risk_structure(*cox_risk_arrays(fr))
    t_rs = time.perf_counter() - t0
    say(f"phase26a CoxPH data: {N_COX} rows, {int(cols['event'].sum())} "
        f"events, {rs['n_groups']} tie groups (stratum, day); "
        f"_risk_structure {t_rs:.3f} s on the host; " + scan_gaps(
            torch, dev, fr))
    counts = None
    for ties in ("efron", "breslow"):
        build = lambda ties=ties: h2o.CoxPHEstimator(  # noqa: E731
            ties=ties, **COX)
        model, secs, c, peak = timed_fit(
            torch, lambda: build().train(fr, y="event"))
        check_launches(c, {}, f"CoxPH {ties}")
        counts = c if counts is None else {k: counts[k] + c[k]
                                           for k in counts}
        t_re = refit_check(torch, build, model,
                           lambda e: e.train(fr, y="event"), f"CoxPH {ties}",
                           fields=("coef",))
        se = np.array([t["se_coef"]
                       for t in model.output["coefficients_table"]])
        z = (model.coef - beta) / se
        if ties == "efron":
            check(np.abs(z).max() <= 4.0,
                  f"CoxPH efron: (coef - beta)/se {np.round(z, 2)}")
        say(f"phase26a CoxPH {ties} on {N_COX} rows: "
            f"{model.output['iterations']} Newton iterations in {secs:.3f} s "
            f"(refit {t_re:.3f} s, bit-equal), peak {peak / 2**30:.3f} GiB, "
            f"concordance {model.training_metrics['concordance']:.6f}, "
            f"loglik {model.output['loglik']:.6f}; (coef - beta)/se_coef "
            + " ".join(f"{v:+.2f}" for v in z)
            + ("" if ties == "efron" else
               f" (max |coef - beta| {np.abs(model.coef - beta).max():.4f}:"
               " Breslow's pull toward 0 under heavy ties, not bounded)"))
    hcols, hdomains, _ = cox_columns(N_P26_HEAD, seed=27)
    frs = head_frames(hcols, hdomains, N_P26_HEAD, dev)
    a, b = (coxph._risk_structure(*cox_risk_arrays(f)) for f in frs)
    check(all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a),
          "CoxPH risk structure card vs CPU")
    ms = [h2o.CoxPHEstimator(**COX).train(f, y="event") for f in frs]
    say(f"phase26a CoxPH efron on a {N_P26_HEAD}-row head, card vs CPU "
        "plain: risk structure EXACT, " + cox_card_vs_cpu(*ms, "CoxPH head"))
    return counts


def svm_columns(n: int, seed: int = 3):
    """tests/test_torch_psvm.py's data: a nonlinear two-class boundary in
    x0, x1 with a categorical shift (x2, x3 noise). Returns (columns,
    domains)."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    c = r.randint(0, 3, n)
    f = np.sin(2 * X[:, 0]) + X[:, 1] ** 2 - 1 + 0.5 * (c == 2) \
        + 0.3 * r.randn(n)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "x3": X[:, 3],
            "c": c.astype(np.int32), "y": (f > 0).astype(np.int32)}
    return cols, {"c": ["u", "v", "w"], "y": ["neg", "pos"]}


def psvm_card_vs_cpu(m_card, m_cpu, frs, label) -> str:
    """PSVM card vs CPU plain at tests/test_torch_psvm.py's tolerances:
    w_b PSVM_WB_TOL, decision values PSVM_DEC_TOL, AUC PSVM_AUC_TOL,
    the support vector counts equal."""
    dw = float(np.abs(m_card.w_b - m_cpu.w_b).max())
    dd = float(np.abs(m_card._score_raw(frs[0])["decision_function"]
                      - m_cpu._score_raw(frs[1])["decision_function"]).max())
    da = abs(m_card.training_metrics["AUC"] - m_cpu.training_metrics["AUC"])
    same = all(m_card.output[k] == m_cpu.output[k]
               for k in ("rank", "svs_count", "bsv_count"))
    check(dw <= PSVM_WB_TOL and dd <= PSVM_DEC_TOL and da <= PSVM_AUC_TOL
          and same, f"{label}: w_b {dw}, decision {dd}, AUC {da}, counts "
                    f"{same}")
    return (f"w_b {dw:.3g} (<= {PSVM_WB_TOL}), decision values {dd:.3g} "
            f"(<= {PSVM_DEC_TOL}), AUC {da:.3g} (<= {PSVM_AUC_TOL}), "
            f"svs_count {m_card.output['svs_count']} equal")


def phase_psvm(torch, dev, ccols, cdomains):
    """Phase 26(b): PSVM on phase 13's Covertype rows, class "2" against
    the rest, at the defaults (rank 256); a GLM's AUC beside it; ICF and
    one Newton step timed; a head card vs CPU plain on the tests' data.
    Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    from h2o3_tpu_torch.models import psvm
    cols = {k: v for k, v in ccols.items() if k != "Cover_Type"}
    cols["y"] = (ccols["Cover_Type"] == 1).astype(np.int32)
    fr = h2o.Frame.from_numpy(cols, domains={"y": ["rest", "2"]},
                              device=dev)
    x = [k for k in cols if k != "y"]
    build = lambda: h2o.PSVMEstimator()  # noqa: E731
    model, secs, counts, peak = timed_fit(
        torch, lambda: build().train(fr, y="y"))
    check_launches(counts, {}, "PSVM")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr, y="y"),
                       "PSVM", fields=("w_b", "pivot_rows", "Linv_t"))
    auc = model.training_metrics["AUC"]
    check(auc > 0.7, f"PSVM AUC {auc}")
    glm = h2o.GLMEstimator(family="binomial").train(fr, y="y")
    # ICF and one Newton step, timed apart on the fit's design
    di = build_datainfo(fr, x, standardize=True, use_all_factor_levels=True)
    w = fr.valid_weights()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V, _, rank = psvm.icf(di.X, w, model.gamma,
                          model.output["rank"])
    torch.cuda.synchronize()
    t_icf = time.perf_counter() - t0
    V1 = torch.cat([V, torch.ones_like(V[:, :1])], 1) * w[:, None]
    y = torch.where(torch.from_numpy(np.pad(
        cols["y"], (0, fr.nrows_padded - fr.nrows))).to(dev) == 1, 1.0, -1.0)
    w_b = torch.from_numpy(model.w_b).to(dev)
    step = time_ms(torch, lambda: psvm._newton_step(w_b, V1, y, w))
    ops = 2.0 * N_COVTYPE * (rank + 1) ** 2
    bound = max(ops / F32_OPS_PER_S, V1.numel() * 4 / HBM_BYTES_PER_S) * 1e3
    say(f"phase26b PSVM on Covertype {N_COVTYPE} x {len(x)}, class 2 "
        f"({int(cols['y'].sum())} rows) vs the rest: rank "
        f"{model.output['rank']}, ICF {t_icf:.3f} s, "
        f"{model.output['iterations']} Newton steps, a step "
        f"{spread(step)} (host-paced {step['host_paced_ms']:.4g} ms) against "
        f"its bound {bound:.4g} ms ({ops:.4g} float32 operations), "
        f"svs_count {model.output['svs_count']}, bsv_count "
        f"{model.output['bsv_count']}, AUC {auc:.6f} (a binomial GLM's "
        f"{glm.training_metrics['AUC']:.6f}), train {secs:.3f} s (refit "
        f"{t_re:.3f} s, bit-equal), peak {peak / 2**30:.3f} GiB")
    hcols, hdomains = svm_columns(N_PSVM_HEAD)
    frs = head_frames(hcols, hdomains, N_PSVM_HEAD, dev)
    ms = [build().train(f, y="y") for f in frs]
    say(f"phase26b PSVM on {N_PSVM_HEAD} rows of the tests' data, card vs "
        "CPU plain: " + psvm_card_vs_cpu(*ms, frs, "PSVM head"))
    del V, V1, di
    return counts


def agg_columns(n: int, seed: int = 5):
    """tests/test_torch_aggregator.py's data: two Gaussian blobs in three
    columns with NAs, and a categorical. Returns (columns, domains)."""
    r = np.random.RandomState(seed)
    X = np.concatenate([r.randn(n // 2, 3), r.randn(n - n // 2, 3) + 3])
    X[r.rand(n) < 0.01, 1] = np.nan
    return ({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
             "k": r.randint(0, 3, n).astype(np.int32)},
            {"k": ["p", "q", "s"]})


def phase_aggregator(torch, dev, higgs):
    """Phase 26(c): the Aggregator at its defaults on the first N_AGG
    rows of ``higgs_frame``'s features; a head card vs CPU plain on the
    tests' data. Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    hcols = higgs[0]
    x = [f"x{i}" for i in range(P_HIGGS)]
    fr = h2o.Frame.from_numpy({k: hcols[k][:N_AGG] for k in x}, device=dev)
    build = lambda: h2o.AggregatorEstimator()  # noqa: E731
    model, secs, counts, peak = timed_fit(torch, lambda: build().train(fr))
    check_launches(counts, {}, "Aggregator")
    t_re = refit_check(torch, build, model, lambda e: e.train(fr),
                       "Aggregator", fields=("exemplar_assignment",))
    n_ex = model.output["num_exemplars"]
    total = model.aggregated_frame.col("counts").to_numpy().sum()
    check(n_ex <= 5000 and total == N_AGG,
          f"Aggregator: {n_ex} exemplars, counts sum {total}")
    t = model.timing
    say(f"phase26c Aggregator on {N_AGG} x {P_HIGGS} HIGGS rows: "
        f"{model.output['sweeps']} sweeps, final radius "
        f"{model.output['radius']:.6f}, {n_ex} exemplars (in [2500, 5000]: "
        f"{2500 <= n_ex <= 5000}), counts sum {int(total)}, {secs:.3f} s "
        f"(refit {t_re:.3f} s, bit-equal), peak {peak / 2**30:.3f} GiB; "
        f"the batches' distances and argmin on the card {t['device']:.3f} s, "
        f"the greedy loop on the host {t['host']:.3f} s "
        f"({t['host'] / max(t['host'] + t['device'], 1e-12):.1%} of the "
        "two)")
    acols, adomains = agg_columns(N_AGG_HEAD)
    frs = head_frames(acols, adomains, N_AGG_HEAD, dev)
    ms = [h2o.AggregatorEstimator(target_num_exemplars=300).train(f)
          for f in frs]
    same = np.array_equal(ms[0].exemplar_assignment,
                          ms[1].exemplar_assignment)
    if same:
        what = "exemplars, counts and assignment EXACT"
    else:
        flips = int((ms[0].exemplar_assignment
                     != ms[1].exemplar_assignment).sum())
        what = f"{flips} rows assigned apart (a distance at the radius)"
        for m in ms:
            check(m.aggregated_frame.col("counts").to_numpy().sum()
                  == N_AGG_HEAD and m.output["num_exemplars"] <= 300,
                  "Aggregator head: counts or exemplar count")
    say(f"phase26c Aggregator on {N_AGG_HEAD} rows of the tests' data, card "
        f"vs CPU plain: {ms[0].output['num_exemplars']} and "
        f"{ms[1].output['num_exemplars']} exemplars, {what}")
    return counts


def zipf_corpus(n_tokens: int, n_types: int, sent: int, seed: int = 8):
    """A Zipf(1.0) corpus over ``n_types`` words in sentences of ``sent``
    words, NA between sentences; W2V_TOPIC_FRAC of the sentences draw
    only from one of two planted 8-word topics. Returns (columns,
    domains, topics)."""
    r = np.random.RandomState(seed)
    n_sent = n_tokens // sent
    p = 1.0 / np.arange(1, n_types + 1)
    words = r.choice(n_types, (n_sent, sent), p=p / p.sum())
    topic = r.rand(n_sent) < W2V_TOPIC_FRAC
    which = r.randint(0, 2, n_sent)
    words[topic] = n_types + 8 * which[topic, None] + r.randint(
        0, 8, (int(topic.sum()), sent))
    codes = np.concatenate([words, np.full((n_sent, 1), -1)], 1).ravel()
    names = [f"w{i}" for i in range(n_types)] + \
        [f"t{k}_{j}" for k in range(2) for j in range(8)]
    topics = [[f"t{k}_{j}" for j in range(8)] for k in range(2)]
    return ({"words": codes.astype(np.int32)}, {"words": names}, topics)


def topic_columns(n_sent: int = 400, seed: int = 0):
    """tests/test_torch_word2vec.py's two-topic corpus (the reference
    test's): six words of one topic a sentence. Returns (columns,
    domains)."""
    r = np.random.RandomState(seed)
    words = []
    for _ in range(n_sent):
        words += list(r.choice(W2V_TOPICS[r.randint(2)], 6)) + [None]
    names = sorted(W2V_TOPICS[0] + W2V_TOPICS[1])
    codes = [names.index(w) if w else -1 for w in words]
    return {"words": np.asarray(codes, np.int32)}, {"words": names}


def w2v_step_timing(torch, dev, fr, batch: int) -> dict:
    """``word2vec._sgd_step``'s time at ``batch`` pairs on the card, on
    the fit's corpus and tree (W_in from the seed)."""
    from h2o3_tpu_torch.frame.frame import raw_columns
    from h2o3_tpu_torch.models import word2vec as w2v
    p = dict(w2v.Word2VecEstimator.DEFAULTS, **W2V)
    words = raw_columns(fr, ["words"])["words"]
    vocab, vcount, cen, ctx = w2v.corpus(
        words, p, np.random.RandomState(p["seed"]))
    P, C, M = w2v._build_huffman(vcount)
    W_in = w2v.draw_init_W_in(len(vocab), p["vec_size"], p["seed"]).to(dev)
    W_out = torch.zeros((len(vocab) - 1, p["vec_size"]), device=dev)
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa
    c = t(cen[:batch], torch.int64)
    k = t(ctx[:batch], torch.int64)
    pts, cds, msk = (t(P, torch.int64)[k], t(C, torch.float32)[k],
                     t(M, torch.bool)[k])
    return time_ms(torch, lambda: w2v._sgd_step(W_in, W_out, c, pts, cds,
                                                msk, 0.025))


def phase_word2vec(torch, dev):
    """Phase 26(d): Word2Vec at its defaults (one epoch) on a Zipf corpus
    of W2V_TOKENS tokens with two planted topics; a step timed at batch
    64 and 4096; the two-topic corpus of the tests card vs CPU plain.
    Returns the path's launches."""
    import h2o3_tpu_torch as h2o
    (cols, domains, topics), _ = made_ahead(
        "zipf", lambda: zipf_corpus(W2V_TOKENS, W2V_TYPES, W2V_SENT))
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    build = lambda: h2o.Word2VecEstimator(**W2V)  # noqa: E731
    model, secs, counts, peak = timed_fit(torch, lambda: build().train(fr))
    check_launches(counts, {}, "Word2Vec")
    # the refit on the corpus's first W2V_REFIT_TOKENS tokens (cut from
    # all of them for the run's time since phase 27 came)
    fr_head = h2o.Frame.from_numpy(
        {"words": cols["words"][:W2V_REFIT_TOKENS]}, domains=domains,
        device=dev)
    head = build().train(fr_head)
    t_re = refit_check(torch, build, head, lambda e: e.train(fr_head),
                       "Word2Vec", fields=("vectors",))
    say(f"phase26d Word2Vec refit held on the first {W2V_REFIT_TOKENS} "
        f"tokens (cut from {W2V_TOKENS} for the run's time since phase 27 "
        f"came; the fit above is of all of them)")
    held = []
    for topic in topics:
        for w in topic:
            syn = model.find_synonyms(w, count=3)
            held.append(sum(s in topic for s in syn))
    check(min(held) >= 2, f"Word2Vec planted topics: own-topic synonyms "
                          f"{held}")
    out = model.output
    steps = {b: w2v_step_timing(torch, dev, fr, b) for b in (64, 4096)}
    say(f"phase26d Word2Vec on a Zipf(1.0) corpus of {W2V_TOKENS} tokens "
        f"over {W2V_TYPES} types: vocabulary {out['vocab_size']}, "
        f"{out['pairs']} pairs, {out['steps']} steps at batch "
        f"{model.params['batch_size']} in {secs:.3f} s "
        f"({out['steps'] / secs:.1f} steps/s; the head's refit "
        f"{t_re:.3f} s, bit-equal), epoch loss {out['epoch_loss'][-1]:.6f}, peak "
        f"{peak / 2**30:.3f} GiB; planted words' own-topic synonyms in "
        f"the top 3: {held}; a step at batch "
        + ", at batch ".join(
            f"{b}: {spread(t)} on the card, host-paced "
            f"{t['host_paced_ms']:.4g} ms" for b, t in steps.items()))
    tcols, tdomains = topic_columns()
    frs = [h2o.Frame.from_numpy(tcols, domains=tdomains, device=d)
           for d in (dev, "cpu")]
    ms = [h2o.Word2VecEstimator(**W2V_TOPIC).train(f) for f in frs]
    gap = rel_gap(ms[0].vectors, ms[1].vectors,
                  floor=float(np.abs(ms[1].vectors).max()))
    own = [[sum(s in t for s in m.find_synonyms(w, 3))
            for t in W2V_TOPICS for w in t] for m in ms]
    check(gap <= W2V_REL and min(own[0]) >= 2 and min(own[1]) >= 2,
          f"Word2Vec head: vectors {gap}, own-topic synonyms {own}")
    say(f"phase26d Word2Vec on the tests' two-topic corpus "
        f"({ms[0].output['steps']} steps), card vs CPU plain: vectors "
        f"{gap:.3g} of the largest (<= {W2V_REL}); own-topic words in each "
        f"word's top 3: card {own[0]}, CPU {own[1]}")
    return counts


def phase_quantiles(torch, dev, higgs, cols, domains):
    """Phase 26(e): the device quantiles of HIGGS x0 (N_HIGGS rows)
    against ``np.quantile``, ``frame_quantiles`` of phase 4's N_MAIN
    airlines rows, a Q_HEAD-row head card vs CPU plain EXACT. Returns
    the path's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.quantiles import (column_quantiles,
                                                frame_quantiles)
    col = higgs[3].col("x0")
    q, secs, counts, _ = timed_fit(
        torch, lambda: column_quantiles(col, Q_PROBS))
    check_launches(counts, {}, "quantiles")
    want = np.quantile(col.host_view(), Q_PROBS)
    gap = float(np.abs(q - want).max())
    check(gap <= Q_GAP, f"quantiles of x0: {gap} from np.quantile")
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    tab, secs_f, c, _ = timed_fit(torch, lambda: frame_quantiles(fr))
    counts = {k: counts[k] + c[k] for k in counts}
    check_launches(counts, {}, "quantiles")
    head = {"x0": higgs[0]["x0"][:Q_HEAD]}
    qs = [column_quantiles(h2o.Frame.from_numpy(head, device=d).col("x0"),
                           Q_PROBS) for d in (dev, "cpu")]
    check(np.array_equal(*qs), f"quantiles head card vs CPU: {qs}")
    say(f"phase26e quantiles of HIGGS x0 ({N_HIGGS} rows, the device path): "
        f"{secs:.3f} s, {gap:.3g} from np.quantile of the float64 view; "
        f"frame_quantiles of {N_MAIN} airlines rows ({len(tab) - 1} "
        f"numeric columns) {secs_f:.3f} s; a {Q_HEAD}-row head card vs CPU "
        "plain EXACT")
    return counts


def phase_sort(torch, dev, cols, domains):
    """Phase 26(f): ``device_sort`` of phase 4's N_MAIN airlines rows by
    (UniqueCarrier, DepTime descending) against ``np.lexsort``, and a
    dimension-table join of JOIN_LEFT left keys against JOIN_RIGHT
    distinct right keys against a numpy join. Returns the path's
    launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops.sort import device_join_index, device_sort
    scols = dict(cols, rid=np.arange(N_MAIN, dtype=np.int32))
    fr = h2o.Frame.from_numpy(scols, domains=domains, device=dev)
    out, secs, counts, _ = timed_fit(torch, lambda: device_sort(
        fr, ["UniqueCarrier", "DepTime"], [True, False]))
    check_launches(counts, {}, "sort")
    want = np.lexsort((-cols["DepTime"], cols["UniqueCarrier"]))
    check(np.array_equal(out.col("rid").to_numpy(), want),
          "device_sort permutation vs np.lexsort")
    r = np.random.RandomState(31)
    lk = r.randint(0, JOIN_KEYS, JOIN_LEFT).astype(np.float32)
    rk = r.permutation(JOIN_KEYS)[:JOIN_RIGHT].astype(np.float32)
    lt, rt = (torch.from_numpy(a).to(dev) for a in (lk, rk))
    (li, ri), secs_j, c, _ = timed_fit(torch, lambda: device_join_index(
        lt, rt, JOIN_LEFT, JOIN_RIGHT))
    counts = {k: counts[k] + c[k] for k in counts}
    check_launches(counts, {}, "sort")
    pos = np.full(JOIN_KEYS, -1)
    pos[rk.astype(np.int64)] = np.arange(JOIN_RIGHT)
    hit = pos[lk.astype(np.int64)]
    check(np.array_equal(li, np.flatnonzero(hit >= 0))
          and np.array_equal(ri, hit[hit >= 0]), "join pairs vs numpy")
    say(f"phase26f device_sort of {N_MAIN} airlines rows by (UniqueCarrier, "
        f"DepTime descending): {secs:.3f} s, the permutation np.lexsort's "
        f"EXACTLY; device_join_index of {JOIN_LEFT} keys in [0, {JOIN_KEYS}) "
        f"against {JOIN_RIGHT} distinct keys: {len(li)} pairs in "
        f"{secs_j:.3f} s, the numpy join's EXACTLY")
    return counts


def phase_models26(torch, dev, cols, domains, ccols, cdomains, higgs):
    """Phase 26: CoxPH, PSVM, the Aggregator, Word2Vec, the device
    quantiles and the sort (no kernel). Returns the launches of their
    six paths (every kernel 0 on each)."""
    t0 = time.perf_counter()
    paths = {"coxph": phase_coxph(torch, dev)}
    secs = {"a": time.perf_counter() - t0}
    paths["psvm"] = phase_psvm(torch, dev, ccols, cdomains)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    paths["aggregator"] = phase_aggregator(torch, dev, higgs)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    paths["word2vec"] = phase_word2vec(torch, dev)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    paths["quantiles"] = phase_quantiles(torch, dev, higgs, cols, domains)
    secs["e"] = time.perf_counter() - t0 - sum(secs.values())
    paths["sort"] = phase_sort(torch, dev, cols, domains)
    secs["f"] = time.perf_counter() - t0 - sum(secs.values())
    for p, c in paths.items():
        check(not any(c.values()), f"{p}: a kernel launched")
    say("phase26: " + ", ".join(f"({k}) {v:.3f} s" for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s; every kernel 0 launches "
        f"on {', '.join(paths)}")
    return paths


# ------------------------------------------------- 27: orchestration


def grid_arrays():
    """bench.py bench_grid's rows: 500K x 6 numeric, a noisy linear N/Y
    response, from RandomState(9)."""
    r = np.random.RandomState(9)
    X = r.randn(N_GRID_ROWS, 6).astype(np.float32)
    yv = (X[:, 0] + 0.5 * X[:, 1] + 0.5 * r.randn(N_GRID_ROWS) > 0)
    cols = {f"x{i}": X[:, i] for i in range(6)}
    cols["y"] = yv.astype(np.int32)
    return cols


def grid_frame(dev):
    """bench.py bench_grid's frame (``grid_arrays``) on the card."""
    import h2o3_tpu_torch as h2o
    cols, _ = made_ahead("grid", grid_arrays)
    return h2o.Frame.from_numpy(cols, domains={"y": ["N", "Y"]}, device=dev)


def phase_grid(torch, dev, fr):
    """Phase 27(a)-(b): the grid's sequential walk, its launches, each
    model against a standalone fit, RandomDiscrete's order; the
    per-model cap. Returns the walk's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.automl.executor import Budget, train_capped
    n_combos = int(np.prod([len(v) for v in GRID_HYPER.values()]))
    grid, secs, counts, peak = timed_fit(torch, lambda: h2o.GridSearch(
        h2o.GBMEstimator, GRID_HYPER, **GRID_FIXED).train(fr, y="y"))
    check(len(grid.models) == n_combos and not grid.failures,
          f"grid: {len(grid.models)} models, failures {grid.failures}")
    per = n_combos * GRID_FIXED["ntrees"] * GRID_FIXED["max_depth"]
    check_launches(counts, {k: per for k in LEVEL_KERNELS}, "grid")
    say(f"phase27(a) grid: {n_combos} GBM combos on {N_GRID_ROWS} rows x 6 "
        f"in {secs:.3f} s, {n_combos / secs:.6g} models/s, peak "
        f"{peak / 2**30:.3f} GiB; each level kernel launched {per} times")
    for m in grid.models:
        alone = h2o.GBMEstimator(**GRID_FIXED, **m.output["grid_params"]
                                 ).train(fr, y="y")
        check(forests_equal(m.forest, alone.forest)
              and m.training_metrics["AUC"] == alone.training_metrics["AUC"],
              f"grid model {m.output['grid_params']} differs from its "
              "standalone fit")
    best = grid.sorted_models()[0]
    say(f"phase27(a) every grid model bit-equal to its standalone fit "
        f"(forest, training AUC); best {best.output['grid_params']} AUC "
        f"{best.training_metrics['AUC']:.6f}")
    rnd = h2o.GridSearch(h2o.GBMEstimator, GRID_HYPER, search_criteria={
        "strategy": "RandomDiscrete", "max_models": 5, "seed": 42},
        **GRID_FIXED).train(fr, y="y")
    order = [m.output["grid_params"] for m in rnd.models]
    check(order == list(GRID_RANDOM_ORDER),
          f"RandomDiscrete walked {order}, the reference "
          f"{list(GRID_RANDOM_ORDER)}")
    say("phase27(a) RandomDiscrete max_models=5 seed=42: 5 models in the "
        "reference's combo order")
    t0 = time.perf_counter()
    m = train_capped(h2o.GBMEstimator(ntrees=400, max_depth=6, seed=1), fr,
                     "y", None, Budget(10, 0, CAP_GBM_SECS))
    t_cap = time.perf_counter() - t0
    n_trees = int(m.forest.feat.shape[0])
    check(0 < n_trees < 400, f"the {CAP_GBM_SECS} s cap kept {n_trees} of "
                             "400 trees")
    t0 = time.perf_counter()
    try:
        train_capped(h2o.DeepLearningEstimator(hidden=[200, 200],
                                               epochs=1000, seed=1),
                     fr, "y", None, Budget(10, 0, CAP_DL_SECS))
        check(False, "DeepLearning ran past its cap")
    except TimeoutError as e:
        t_dl = time.perf_counter() - t0
        say(f"phase27(b) per-model cap: GBM(ntrees=400) under "
            f"{CAP_GBM_SECS} s kept {n_trees} trees ({t_cap:.3f} s); "
            f"DeepLearning(epochs=1000) under {CAP_DL_SECS} s cancelled at "
            f"a job.update after {t_dl:.3f} s: {e}")
    torch.cuda.synchronize()
    return counts


def automl_csv():
    """bench.py bench_automl's rows as CSV: all N_AUTOML airlines rows
    and their first N_AUTOML_HEAD."""
    cols, domains = airlines_arrays(N_AUTOML)
    head = {k: v[:N_AUTOML_HEAD] for k, v in cols.items()}
    return csv_bytes(cols, domains), csv_bytes(head, domains)


def automl_frames(torch, dev):
    """bench.py bench_automl's frame and its head, each written as CSV
    and read by ``stream_import_csv``."""
    import tempfile
    from h2o3_tpu_torch.io.stream import stream_import_csv
    (full, head), _ = made_ahead("automl_csv", automl_csv)
    frames = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in (("airlines", full), ("head", head)):
            path = f"{tmp}/{name}.csv"
            with open(path, "wb") as f:
                f.write(data)
            frames.append(stream_import_csv(path, device=dev))
    torch.cuda.synchronize()
    return frames


@contextlib.contextmanager
def step_meter(torch):
    """Each AutoML step's seconds and peak device memory, and the memory
    held after it, read around ``run_step`` (the steps run one at a
    time): yields {step id: (seconds, peak bytes, bytes after)}."""
    from h2o3_tpu_torch import automl
    real, seen = automl.run_step, {}

    def metered(aml, step, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return real(aml, step, *a, **kw)
        finally:
            torch.cuda.synchronize()
            seen[step.id] = (time.perf_counter() - t0,
                             torch.cuda.max_memory_allocated(),
                             torch.cuda.memory_allocated())
    with mock.patch.object(automl, "run_step", metered):
        yield seen


def leaderboard_rows(aml):
    """(step, algo, CV AUC, CV logloss, train seconds) of each
    leaderboard row, best first."""
    out = []
    for m in aml.leaderboard.sorted_models():
        cvm = m.default_metrics
        out.append((m.output.get("automl_step"), m.algo, cvm["AUC"],
                    cvm["logloss"], m.run_time))
    return out


def phase_automl(torch, dev, fr):
    """Phase 27(c): bench.py's AutoML config, its 300 s budget. Returns
    its launches."""
    import h2o3_tpu_torch as h2o
    budget = AUTOML["max_runtime_secs"]
    with step_meter(torch) as seen:
        aml = h2o.H2OAutoML(**AUTOML)
        leader, secs, counts, peak = timed_fit(
            torch, lambda: aml.train(y=Y, training_frame=fr))
    rows = leaderboard_rows(aml)
    n_models = sum(r[1] != "stackedensemble" for r in rows)
    say(f"phase27(c) AutoML max_models={AUTOML['max_models']} nfolds="
        f"{AUTOML['nfolds']} max_runtime_secs={budget:.0f} "
        f"on {N_AUTOML} airlines rows: wallclock {secs:.3f} s, {n_models} "
        f"models trained of {AUTOML['max_models']} planned, "
        f"{len(rows) - n_models} StackedEnsembles, peak "
        f"{peak / 2**30:.3f} GiB")
    if n_models < AUTOML["max_models"] // 2:
        say(f"phase27(c) SHORTFALL: trained {n_models}/"
            f"{AUTOML['max_models']} planned")
    for step, algo, auc, ll, rt in rows:
        s_, pk, after = seen.get(step, (None, None, None))
        extra = ""
        if s_ is not None:
            extra = (f", step {s_:.3f} s, step peak {pk / 2**30:.3f} GiB, "
                     f"held after {after / 2**30:.3f} GiB")
        say(f"phase27(c)   {step:<30} {algo:<16} CV AUC {auc:.6f} logloss "
            f"{ll:.6f} train {rt:.3f} s{extra}")
    trained = {r[0] for r in rows}
    for step in DEEP_STEPS:
        check(step in trained, f"the depth-15/20 step {step} was not "
                               f"trained in the {budget} s budget")
        s_, pk, _ = seen[step]
        say(f"phase27(c) depth-15/20 step {step}: {s_:.3f} s, peak "
            f"{pk / 2**30:.3f} GiB")
    for e in aml.event_log:
        if e["stage"] in ("timeout", "budget", "error"):
            say(f"phase27(c) event {e['stage']}: {e['message']}")
    check(not [e for e in aml.event_log if e["stage"] == "error"],
          "AutoML logged an error event")
    aucs = [r[2] for r in rows]
    check(aucs == sorted(aucs, reverse=True),
          "the leaderboard is not sorted by CV AUC")
    with_cv = {m.algo for m in aml.leaderboard.models
               if getattr(m, "_cv_holdout", None) is not None}
    if len(with_cv) >= 2:
        check({"StackedEnsemble_BestOfFamily",
               "StackedEnsemble_AllModels"} <= trained,
              f"a StackedEnsemble is missing: {sorted(trained)}")
    pred = aml.predict(fr)
    check({"predict", "p0", "p1"} <= set(pred.names),
          f"the leader's predictions have {pred.names}")
    p1 = pred.col("p1").to_numpy()
    check(np.isfinite(p1).all() and p1.shape == (N_AUTOML,),
          "the leader's p1 is not finite of the frame's rows")
    auc = leader.model_performance(fr)["AUC"]
    say(f"phase27(c) leader {rows[0][0]} ({rows[0][1]}): CV AUC "
        f"{rows[0][2]:.6f}, AUC on the frame {auc:.6f}; launches "
        f"{counts}")
    check(all(counts[k] > 0 for k in LEVEL_KERNELS)
          and all(counts[k] == 0 for k in counts if k not in LEVEL_KERNELS),
          f"AutoML launches {counts}")
    return counts


def phase_automl_repeat(torch, dev, fr):
    """Phase 27(d)-(e) on the head of (c)'s CSV: two budget-free runs
    bit-equal; the best-of-family metalearner card vs CPU. Returns (both
    runs' launches, the card metalearner's launches)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ml.ensemble import _level_one_columns, _with_response
    from h2o3_tpu_torch.ops import kernels
    runs, t_runs = [], []
    kernels.reset_counts()
    for _ in range(2):
        aml = h2o.H2OAutoML(**AUTOML_REPEAT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aml.train(y=Y, training_frame=fr)
        torch.cuda.synchronize()
        t_runs.append(time.perf_counter() - t0)
        runs.append(aml)
    counts = dict(kernels.LAUNCHES)
    a, b = runs
    steps_a = [m.output["automl_step"] for m in a.leaderboard.models]
    steps_b = [m.output["automl_step"] for m in b.leaderboard.models]
    check(steps_a == steps_b, f"AutoML steps differ: {steps_a} / {steps_b}")
    tab_a = [{k: v for k, v in r.items() if k != "model_id"}
             for r in a.leaderboard.as_table()]
    tab_b = [{k: v for k, v in r.items() if k != "model_id"}
             for r in b.leaderboard.as_table()]
    check(tab_a == tab_b, "the two AutoML leaderboards differ")
    pa = a.predict(fr).col("p1").to_numpy()
    pb = b.predict(fr).col("p1").to_numpy()
    check(np.array_equal(pa, pb), "the two leaders' p1 differ")
    say(f"phase27(d) AutoML {AUTOML_REPEAT} twice on the first "
        f"{fr.nrows} rows of (c)'s CSV (cut from {N_AUTOML} for the run's "
        f"time): {t_runs[0]:.3f} / {t_runs[1]:.3f} s, steps {steps_a} in "
        "the same order, leaderboards bit-equal (every metric), leader p1 "
        "bit-equal")
    se = next(m for m in a.leaderboard.models
              if m.output["automl_step"] == "StackedEnsemble_BestOfFamily")
    cols = {}
    for m in se.base_models:
        cols.update(_level_one_columns(m, None))
    fits = {}
    for d in (dev, "cpu"):
        l1 = _with_response(cols, fr.col(Y), Y, fr.nrows, torch.device(d))
        kernels.reset_counts()
        fits[str(d)] = h2o.GLMEstimator(lambda_=0.0).train(l1, y=Y)
        if d == dev:
            se_counts = dict(kernels.LAUNCHES)
    # the witness of float32 order: the CPU fit on the rows permuted, for
    # SE_WITNESS_PERMS permutations
    ycodes = fr.col(Y).host_view()
    witnesses = []
    for seed in range(1, SE_WITNESS_PERMS + 1):
        perm = np.random.default_rng(seed).permutation(fr.nrows)
        l1p = h2o.Frame.from_numpy(
            {**{k: np.asarray(v)[perm] for k, v in cols.items()},
             Y: np.where(np.isnan(ycodes[perm]), -1,
                         ycodes[perm]).astype(np.int32)},
            domains={Y: fr.col(Y).domain}, device="cpu")
        witnesses.append(coef_gap(
            h2o.GLMEstimator(lambda_=0.0).train(l1p, y=Y), fits["cpu"],
            "permuted metalearner"))
    gap = coef_gap(fits[str(dev)], fits["cpu"], "metalearner")
    tol = max(SE_COEF_TOL, 2.0 * max(witnesses))
    check(gap <= tol, f"metalearner card vs CPU: coefficients {gap:.3g} "
                      f"apart, over {tol:.3g}")
    check(all(v == 0 for v in se_counts.values()),
          f"the metalearner launched {se_counts}")
    say(f"phase27(e) best-of-family metalearner over "
        f"{[m.algo for m in se.base_models]} on {fr.nrows} level-one rows: "
        f"card vs CPU coefficients {gap:.3g} apart relative to max(1, |c|) "
        f"(<= {tol:.3g}: COEF_TOL {SE_COEF_TOL}, or twice the largest "
        f"witness, the CPU fit on the rows permuted by {SE_WITNESS_PERMS} "
        f"seeds: {', '.join(f'{w:.3g}' for w in witnesses)}); card "
        f"{fits[str(dev)].coefficients}, CPU {fits['cpu'].coefficients}")
    return counts, se_counts


def phase_deep_contributions(torch, dev, fr):
    """Phase 27(f): TreeSHAP of a depth-20 GBM (DEEP_SHAP; its trees kept
    as HeapTrees) on the head of (c)'s CSV: local accuracy on every row,
    and within 1e-5·max(1, |margin|) of the CPU plain version on the
    first DEEP_SHAP_CPU rows, as phase 21 holds the dense forests.
    Returns the fit's launches."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import rebin_for_scoring
    from h2o3_tpu_torch.frame.frame import raw_columns
    from h2o3_tpu_torch.models.tree import HeapTree, tree_depth
    from h2o3_tpu_torch.parallel.device import fetch
    model, secs, counts, peak = timed_fit(
        torch, lambda: h2o.GBMEstimator(**DEEP_SHAP).train(fr, y=Y))
    check(isinstance(model.forest, HeapTree)
          and tree_depth(model.forest) == DEEP_SHAP["max_depth"],
          f"the depth-20 GBM's forest is a {type(model.forest).__name__}")
    check(all(counts[k] > 0 for k in LEVEL_KERNELS)
          and all(counts[k] == 0 for k in counts if k not in LEVEL_KERNELS),
          f"depth-20 GBM launches {counts}")
    margin = fetch(model._margins(rebin_for_scoring(model.bm, fr)))[
        :fr.nrows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contrib = host_columns(model.predict_contributions(fr))
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    tol = 1e-5 * np.maximum(1.0, np.abs(margin))
    acc_gap = np.abs(contrib.sum(1) - margin)
    check((acc_gap <= tol).all(), f"depth-20 contributions: local accuracy "
                                  f"off by {acc_gap.max()}")
    raw = raw_columns(fr, fr.names)
    small = h2o.Frame.from_numpy({k: v[:DEEP_SHAP_CPU]
                                  for k, v in raw.items()}, device="cpu")
    want = host_columns(cpu_model(model).predict_contributions(small))
    err = np.abs(contrib[:DEEP_SHAP_CPU] - want)
    check((err <= tol[:DEEP_SHAP_CPU, None]).all(),
          f"depth-20 contributions card vs CPU plain: max |err| "
          f"{err.max()}")
    leaves = int((fetch(model.forest.leaf_w) > 0).sum())
    say(f"phase27(f) GBM {DEEP_SHAP} on {fr.nrows} rows: train {secs:.3f} "
        f"s, peak {peak / 2**30:.3f} GiB, HeapTree forest "
        f"{tuple(model.forest.feat.shape)}, {leaves} leaves with rows; "
        f"launches {counts}; predict_contributions {t_c:.3f} s, local "
        f"accuracy on every row (max |gap| {acc_gap.max():.3g}), card == "
        f"CPU plain on {DEEP_SHAP_CPU} rows within 1e-5*max(1, |margin|) "
        f"(max |err| {err.max():.3g})")
    return counts


def phase_orchestration(torch, dev):
    """Phase 27: (a)-(b) on the grid frame; (d)-(f) on the head of the
    AutoML CSV, then (c) on all of it. Returns the paths' launches."""
    t27 = time.perf_counter()
    fr = grid_frame(dev)
    grid_counts = phase_grid(torch, dev, fr)
    t_a = time.perf_counter() - t27
    del fr
    fr, head = automl_frames(torch, dev)
    t0 = time.perf_counter()
    repeat_counts, se_counts = phase_automl_repeat(torch, dev, head)
    deep_counts = phase_deep_contributions(torch, dev, head)
    t_d = time.perf_counter() - t0
    del head
    t0 = time.perf_counter()
    automl_counts = phase_automl(torch, dev, fr)
    t_c = time.perf_counter() - t0
    say(f"phase27: (a, b) {t_a:.3f} s, (d, e, f) {t_d:.3f} s, (c) "
        f"{t_c:.3f} s, together {time.perf_counter() - t27:.3f} s")
    return {"grid": grid_counts, "automl": automl_counts,
            "automl_repeat": repeat_counts, "stackedensemble": se_counts,
            "gbm_depth20": deep_counts}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import h2o3_tpu_torch  # noqa: F401 - fails outside the repository
    from h2o3_tpu_torch.core.kv import DKV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    make_ahead([("higgs", lambda: higgs_arrays(N_HIGGS)),
                ("mnist", lambda: mnist_shape_arrays(N_DL)),
                ("pca", lambda: pca_frame_arrays(N_PCA)),
                ("zipf", lambda: zipf_corpus(W2V_TOKENS, W2V_TYPES,
                                             W2V_SENT)),
                ("grid", grid_arrays), ("automl_csv", automl_csv)])

    def mark(label: str) -> None:
        # each phase starts with an empty DKV (the models a phase made
        # live only as long as its locals), its garbage collected and
        # the caching allocator's free blocks returned
        DKV.clear()
        gc.collect()
        torch.cuda.empty_cache()
        say(f"-- {label} at {time.perf_counter() - t_all:.1f} s")

    phase_toolchain(torch)

    from h2o3_tpu_torch.frame.binning import bin_frame
    import h2o3_tpu_torch as h2o
    cols, domains = airlines_arrays(N_MAIN)
    small = {k: v[:N_KERNEL] for k, v in cols.items()}
    fr_k = h2o.Frame.from_numpy(small, domains=domains, device=dev)
    x = [c for c in cols if c != "IsDepDelayed"]
    bm = bin_frame(fr_k, x, nbins=64, nbins_cats=1024)

    mark("phases 2-3")
    worst = phase_kernels(torch, dev, bm)
    phase_grow_tree(torch, dev, bm)
    mark("phase 4")
    model, fr, counts_gbm, t_main = phase_main(torch, dev, cols, domains)
    auc_one_card = model.training_metrics["AUC"]
    metrics_main = {k: model.training_metrics[k] for k in ("AUC", "logloss")}
    gbm_forest = on_cpu(model.forest)
    phase_profile(torch, dev, fr)
    mark("phase 5")
    records = phase_timing(torch, dev, model, counts_gbm)
    phase_drf_grow_tree(torch, dev, bm)
    gbm_model = model
    del fr_k, bm, model
    mark("phase 6")
    counts_drf, drf_model = phase_drf(torch, dev, fr)
    drf_forest = on_cpu(drf_model.forest)
    drf_auc = drf_model.training_metrics["AUC"]
    for rec in records:
        if rec["path"] == "drf":
            rec["launches"] = counts_drf[rec["name"]]
    head = {k: v[:N_DIST].copy() for k, v in cols.items()}

    mark("phases 7-9")
    ucols, udomains = criteo_arrays(N_UPLIFT)
    worst["histogram"] = phase_hist_kernel(torch, dev, ucols, udomains)
    umodel, ufr, counts_up = phase_uplift(torch, dev, ucols, udomains)
    records.append(phase_hist_timing(torch, dev, umodel, ufr, counts_up))
    del umodel, ufr, ucols

    mark("phases 10-12")
    counts_mesh, errs, bm = phase_mesh(torch, dev, fr, auc_one_card,
                                       gbm_forest)
    worst.update(errs)
    records += phase_shard_timing(torch, dev, bm, counts_mesh)
    del bm

    mark("phase 13")
    ccols, cdomains = covtype_arrays()
    mmodel, cfr, counts_gm = phase_multinomial(torch, dev, ccols, cdomains)
    records += timing_records(
        level_timing(torch, dev, mmodel.bm, LEVEL_KERNELS, N_COVTYPE),
        counts_gm, N_COVTYPE, "phase13 timing", "gbm_multinomial")
    del mmodel
    mark("phase 14")
    counts_dm = phase_multinomial_drf(torch, dev, cfr, ccols, cdomains)
    del cfr
    mark("phase 15")
    counts_dist = phase_distributions(
        torch, dev, head, airlines_delay(N_MAIN)[:N_DIST], domains)
    mark("phase 16")
    counts_stop = phase_stopping(torch, dev, head, domains)
    mark("phase 17")
    counts_cons = phase_constraints(torch, dev, fr, cols, domains)
    counts_off = phase_offset(torch, dev, cols, domains)
    counts_ckg, counts_ckd = phase_checkpoint(torch, dev, fr, gbm_forest,
                                              drf_forest, drf_auc)
    counts_cv = phase_cv(torch, dev, fr, t_main)
    phase_calibration(torch, dev, fr, domains)
    phase_runtime_cap(torch, dev, fr, cols, domains, gbm_forest,
                      metrics_main, drf_forest)
    mark("phase 18")
    counts_csv = phase_csv(torch, dev, cols, domains)
    paths = {"gbm": counts_gbm, "drf": counts_drf, "uplift": counts_up,
             "gbm_mesh": counts_mesh, "gbm_multinomial": counts_gm,
             "drf_multinomial": counts_dm, "gbm_distributions": counts_dist,
             "gbm_stopping": counts_stop, "gbm_constraints": counts_cons,
             "gbm_offset": counts_off, "gbm_checkpoint": counts_ckg,
             "drf_checkpoint": counts_ckd, "gbm_cv": counts_cv,
             "gbm_csv": counts_csv}
    secs = {}
    t19 = time.perf_counter()
    mark("phase 19")
    paths.update(phase_xgboost_histogram_types(torch, dev, fr, cols, domains,
                                               gbm_forest))
    secs[19] = time.perf_counter() - t19
    mark("phase 20")
    iso_paths, iso_record = phase_isolation_forests(torch, dev, cols, domains)
    paths.update(iso_paths)
    records.append(iso_record)
    secs[20] = time.perf_counter() - t19 - secs[19]
    mark("phase 21")
    paths["tree_scoring"] = phase_scoring(torch, dev, fr, cols, domains,
                                          gbm_model, drf_model)
    secs[21] = time.perf_counter() - t19 - secs[19] - secs[20]
    say("phases 19-21: " + ", ".join(f"phase {k} {v:.3f} s"
                                     for k, v in secs.items())
        + f", together {sum(secs.values()):.3f} s")
    del fr, gbm_model, drf_model
    mark("phase 22")
    t22 = time.perf_counter()
    higgs = higgs_frame(dev)
    paths.update(phase_glm(torch, dev, cols, domains, airlines_delay(N_MAIN),
                           ccols, cdomains, higgs))
    say(f"phase 22: {time.perf_counter() - t22:.3f} s")
    mark("phase 23")
    t23 = time.perf_counter()
    paths.update(phase_dl(torch, dev, cols, domains, airlines_delay(N_MAIN)))
    say(f"phase 23: {time.perf_counter() - t23:.3f} s")
    mark("phase 24")
    t24 = time.perf_counter()
    paths.update(phase_unsupervised(torch, dev, cols, domains, ccols,
                                    cdomains, higgs))
    say(f"phase 24: {time.perf_counter() - t24:.3f} s")
    mark("phase 25")
    t25 = time.perf_counter()
    paths.update(phase_glm_wrappers(torch, dev, cols, domains, higgs))
    say(f"phase 25: {time.perf_counter() - t25:.3f} s")
    mark("phase 26")
    t26 = time.perf_counter()
    paths.update(phase_models26(torch, dev, cols, domains, ccols, cdomains,
                                higgs))
    say(f"phase 26: {time.perf_counter() - t26:.3f} s")
    del higgs, ccols
    mark("phase 27")
    paths.update(phase_orchestration(torch, dev))
    for rec in records:
        rec["max_abs_err"] = worst[rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]]
                                   for p, c in paths.items()}
    say(f"chip_smoke total {time.perf_counter() - t_all:.3f} s")
    print(CARD, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        drop_ahead()
