"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase failure is caught):
  1. build: `nvcc` builds every kernel of the port from `oovrec_tpu_torch/csrc`,
     one process per source, all at once;
  2. kernels: each kernel against its plain PyTorch version on the card,
     exactly, on ragged, tied and all-masked shapes, k = 1 / 20 / 100 /
     512 / 600 / 1,024, B = 1 and 257, D = 1,000 / 2,048 (the user tile
     streamed) and ties across item ranges (top-k) and on integer-valued
     inputs at every CIN layer mode, odd and ragged shape and the edges of
     its geometry (L = 128 / 200, D = 1 / 128 / 200, a pair axis of 700,
     2,450 pairs at D = 128: several launches over D spans and column
     groups) (CIN); the CIN kernel also on random inputs to a stated
     tolerance and against a repeat run; then each timed at the main-path
     shapes beside its bound and a PyTorch yardstick;
  3. retrieval serving: BPR at embedding_size 64 with random-mapper OOV
     buckets over 110,000 users and 1,000,000 items (10 % new), 7-slice
     inductive eval and IV full-sort eval, fused path vs dense path to
     1e-9, with the top-k kernel's launch count read around the fused run;
  4. ranking serving: xDeepFM at its published widths (embedding_size 10,
     CIN 100/100/100, MLP 128/128/128) over 7 fields, 220,000 users and
     110,000 items (10 % new) with OOV buckets, 1,048,576 labelled rows in
     batches of 8,192: value eval (AUC, LogLoss) and the 7 value slices,
     CIN kernel vs plain slab path to 1e-6, with the CIN kernel's launch
     count read around each run; then a profile of one fused pass;
  5. ranking training: the same xDeepFM from another seed through
     `Trainer.fit` over the IV rows of the first 90 % of those rows, one
     epoch plus the frozen OOV-only sub-epoch (adam lr 1e-3, batches of
     8,192): 3 forward and 3 backward CIN launches a step, IV tables
     bitwise unchanged by the frozen sub-epoch and bucket tables moved, the
     loss falling, held-out AUC up, then the 7 value slices on the trained
     weights; 16 steps on the kernel path against the plain slab path from
     identical weights; wall ms per step and a profile of fused steps; then
     4 steps at cin_layer_size 200 through `fused_cin: auto` on the CIN
     kernels (two column groups a backward) against 4 on the slab path,
     the backward against its plain version at those layers' shapes, and
     one batch served on the forward kernel;
  6. retrieval training: BPR at embedding_size 64 over the serving scale,
     64 pairwise steps of 2,048 rows plus an OOV sub-epoch through
     `Trainer.fit`, then the 7-slice eval fused vs dense to 1e-9; then BPR
     with `learner: sparse_adam` on the device epoch (kernel 6);
  7. the CLI, the main path's own entry (`build/cli/`):
     A. `python -m oovrec_tpu_torch.cli.run` in the shared CLI child on the tracked
        corpus dataset/synth-ind: BPR (D 64), random-mapper OOV buckets,
        the OOV regime, the paper protocol (uni250), 1 epoch, the 7-slice
        inductive eval and `--results_json`; rc 0, finite metrics, all 7
        slices; `--eval_only` on its checkpoint reproduces it to 1e-9;
     B. `cli.run.main` in this process: xDeepFM at its published widths
        under the ranking protocol, 1 epoch, the CIN forward and backward
        kernels counted (> 0) and held against their plain versions at a
        training batch's and a uni250 test batch's shapes (2,048 and about
        100,000 rows); `--eval_only` with `--fused_cin` True and False
        agree on AUC, RMSE and the 7 value slices to 1e-6;
     C. an atomic-file family written here (the generator of
        tools/make_synth_dataset.py at 50,000 users x 100,000 items x
        1,000,000 rows) through `quick_start.run`: BPR at D 64 with 1,024
        buckets a side, `learner: sparse_adam` on the device epoch (kernel
        6 counted), full-sort eval, then `perform_inductive_eval` (kernel 1
        counted); the wall time of each stage; `--eval_only` with
        `use_fused_topk` True and False (perturbed hits off, as in phase
        3) agree to 1e-9;
  8. phase D, the embedders, at the published widths (BPR at D 64, DHE at
     128 hashes and towers of 512, xDeepFM at xDeepFM.yaml):
     D1. EXPERIMENTS.md:40-45 verbatim (lsh, the *_vector columns, 200
         buckets a side, OOV ratio 0.3, the inductive eval; 1 epoch)
         through `python -m oovrec_tpu_torch.cli.run` in the shared CLI child, its
         `--eval_only` equal to 1e-9, then the same command through
         `cli.run.main` with slsh, dnn, knn, dhe and fdhe (32 hashes); every
         run's 7 slices finite;
     D2. xDeepFM with lsh through `cli.run.main`, 1 epoch, the CIN kernels
         counted;
     D3. fdhe serving over phase 3's 1,000,000 items: the ids hashed on
         the card equal to the numpy hasher on every id, the tower pass
         over all items timed, the 7-slice eval fused vs dense to 1e-9;
     D4. the gathers' backward of `ops/embed_grad.py` (its kernel) and the
         routes it was measured against (BACKWARD_ROUTES: a call and device
         time, each repeated bit for bit), and BPR with lsh on the
         device epoch with sparse adam, auto == xla bit for bit.
  9. phase E, the paper's other three models at their published widths
     (WideDeep.yaml, DCNV2.yaml, DirectAU.yaml):
     E1. EXPERIMENTS.md:79, the ranking track (WideDeep, lsh over the
         *_vector columns, 200 buckets a side, OOV ratio 0.3; 2 epochs of
         8) through `python -m oovrec_tpu_torch.cli.run` in the shared CLI child:
         the training loss falls, the 7 slices are finite, `--eval_only`
         equal to 1e-9; then the same command through `cli.run.main`;
     E2. DCNv2 through `cli.run.main` on synth-ind (random mapper, 1
         epoch) stacked, parallel and with mixed experts, each
         `--eval_only` equal to 1e-9 and its BatchNorm statistics moved;
         stacked at `--worker=2` (batch prefetch) equal to `worker: 0`;
     E3. WideDeep, DCNv2 stacked and mixed through `Trainer.fit` at phase
         4's shape (one epoch + the frozen OOV sub-epoch): the loss falls,
         held-out AUC rises, the 7 value slices; 64 rows score alike alone
         and inside a batch of 8,192 in eval mode (1e-6); then WideDeep
         with a token_seq item field, 16 steps, the loss falling and the
         gathers' backward launched for the field's tables;
     E4. DirectAU at D 64: 64 pointwise steps of 2,048 rows + the OOV
         sub-epoch with adam and with `learner: sparse_adam` (kernel 6 on
         the host path); the serving cell's corpus, fused == dense on the 7
         slices and the full sort (1e-9); DirectAU on synth-ind through
         `cli.run.main`, `--eval_only` equal to 1e-9.
 10. phase F, the device-resident and scanned paths, each dense step
     replayed from its captured CUDA graph (`train/cuda_graph.py`):
     F1. xDeepFM at the ranking cell's shape on the plain device epoch
         through `Trainer.fit` (`device_epoch: true`; the frozen OOV
         sub-epoch on the host path): the loss falls, held-out AUC rises,
         CIN kernels 4 and 5 (3 + 3 a step) and the gathers' backward
         launched by their wrappers at the warm-ups and the captures;
         8 graphed steps against 8 eager ones on the same
         batches from the same weights, bit for bit (losses, parameters,
         moments); eager vs graphed ms a step, wall and device, with the
         busy share, and the kernels in each pass's profiler trace: the
         graphed pass calls no wrapper and its trace holds each kernel as
         often as the eager trace, which holds it as often as the eager
         wrappers launched it; a whole epoch's ms a step;
     F2. WideDeep and DCNv2 on the pointwise device epoch (uniform, one
         negative a row) at the same shape: the loss falls, DCNv2's
         BatchNorm statistics move; graphed == eager over 8 steps; times;
     F3. BPR with fdhe (128 hashes, towers of 512) hashed on the card
         (`dhe_on_device`) on the pairwise device epoch with `learner:
         sparse_adam` (kernel 6, eager by rule) and its OOV sub-epoch at
         the sparse phase's shape; one OOV batch's codes == the host
         hasher's; then BPR's dense step graphed == eager, and times; a
         dropped trainer's captures do not break the next capture;
     F4. `host_scan_steps` 64 against 1 on xDeepFM's host path: the same
         losses and weights bit for bit; then over 2 groups of 64
         batches K = 64 against K = 1 (both replaying) and K = 1 eagerly
         (what the grouping adds beyond the graph), wall, device and busy
         share, the replays' kernels counted in the traces;
     F5. the scanned eval against the per-batch eval over phase 3's
         900,000 IV items: the full sort on kernel 1 and uni100, the same
         metrics; walls and host syncs of each pass.
     Phases 5, 6, E3 and E4 and the sparse phase pin `device_epoch: False`
     and `host_scan_steps: 1` where they measure or watch the host path,
     and run its dense steps eagerly (`eager_steps`: they count launches a
     step, swap a kernel's route between steps, or time the eager step);
     the serving phases pin `device_eval: False` (`serving_cfg`).
 11. phase G, the trainer's leftovers and the first four context models:
     G1. xDeepFM at the ranking cell's shape under `adagrad`, `rmsprop`
         and adam with bf16 first moments (`optimizer_mu_dtype`), and adam
         with f32 ones to compare: 8 graphed steps == 8 eager ones bit
         for bit on the plain device epoch (moments and sums included),
         eager vs graphed wall and device ms a step; under each new rule
         8 steps on the CIN kernels against the slab path (losses 1e-5,
         parameters 1e-4), the loss falling;
     G2. BPR at D 64 over phase 3's 900,000 IV items on the host path,
         32 steps of 2,048 rows, without dynamic negatives and with 4 and
         16 candidates a slot: ms a step and the scorer's share; the picks
         == the argmax of a plain f64 scorer over the same candidates
         (near-ties excepted); then the 7-slice eval on kernel 1, fused ==
         dense;
     G3. `import_torch_checkpoint`: a `.pth` this phase writes in
         RecBole's key names seeds BPR (the `-m` entry, a subprocess) and
         xDeepFM (`cli.run.main`) on synth-ind, the import equal to the
         file bit for bit, 1 epoch, `--eval_only` == the run to 1e-9; then
         the committed JAX checkpoint (`tests/assets/jax_checkpoints/`,
         BPR, sparse_adam) read without flax through `load_data_and_model`
         and trained on for one epoch, kernel 6 on the resumed moments;
     G4. LR, FM, DeepFM and FFM at their YAML widths at the ranking cell's
         shape: a short fit (LR, FM, DeepFM on the pointwise device epoch,
         FFM on the host path) and the value eval; graphed == eager on the
         pointwise epoch (LR, FM, DeepFM) and on the host path (all four),
         and the ms a step of each.
 12. phase H, the rest of the context zoo:
     H1. DCN, AutoInt, FNN, PNN, AFM, FwFM, DSSM, FiGNN, EulerNet, NFM and
         KD_DAGFM (in `distillation`) at their YAML widths at the ranking
         cell's shape, the pointwise traffic of G4: 8 host steps (the
         graphed dense step) + the frozen OOV sub-epoch, finite losses,
         the gathers' backward launched, every non-OOV parameter the model
         reads moved (DCN's cross weights drawn at 1/10 of N(0, 1)),
         BatchNorm statistics moved (DCN, NFM), KD_DAGFM's teacher
         unchanged; the value eval on the
         held-out IV rows and the 7 value slices finite; 4 graphed host
         steps == 4 eager ones bit for bit, and the ms a step of each
         (wall, device, busy share);
     H2. `python -m oovrec_tpu_torch.cli.run --model=AutoInt
         --model_eval_type=ranking` on dataset/synth-ind for 1 epoch in
         a child process that prints its kernel launch counts as it ends
         (the gathers' backward launched there), `--eval_only` == the run
         to 1e-9.
 13. phase I, the sequential family:
     I1. GRU4Rec, SASRec, NARM, STAMP, FPMC and BERT4Rec at their YAML
         widths (embedding 64, GRU4Rec and NARM hidden 128, SASRec and
         BERT4Rec 2 layers of 2 heads, inner 256) on a corpus at
         MovieLens-1M's shape written here as an atomic `.inter` file
         (6,040 users, 3,706 items, 1,000,209 rows) and loaded through
         `create_dataset` and `data_preparation` (MAX_ITEM_LIST_LENGTH
         50: 994,169 examples, leave-one-out, the full-sort loaders,
         the write and the load timed apart): 64 steps of 2,048 rows through `Trainer.fit`
         (GRU4Rec, SASRec, NARM and STAMP on the plain device epoch that
         `auto` takes, FPMC and BERT4Rec on the host path, BERT4Rec's
         batches masked by MaskItemSequence), finite falling losses,
         every parameter moved, the gathers' backward launched; the
         scanned full-sort test pass over 6,040 examples, 256 a batch
         (GRU4Rec and SASRec: == the per-batch pass); 4 graphed steps ==
         4 eager ones bit for bit and the ms a step of the first; also
         MaskItemSequence's host ms a batch and GRU4Rec's valid pass at
         `eval_batch_size` 4,096 (one row a batch), stopped at 256 rows
         when it would pass 20 s;
     I2. `python -m oovrec_tpu_torch.cli.run --model=GRU4Rec` on
         dataset/synth-ind for 1 epoch in the shared CLI child, which prints its launch
         counts, `--eval_only` == the run to 1e-9.
 14. phase J, the rest of the plain sequence models, on I1's corpus:
     J1. Caser, NextItNet, DIN, DIEN, HGN, FOSSIL, TransRec, SHAN, NPE,
         HRM, CORE, SRGNN, GCSAN, LightSANs and SINE at their YAML widths
         through `Trainer.fit` (Caser and NextItNet 64 steps of 2,048 on
         the plain device epoch that `auto` takes, the others 32 on the
         host path; DIN, DIEN with its negatives drawn on the card, and
         TransRec with one sampled negative), finite falling losses, every
         parameter moved, the gathers' backward launched; 4 graphed steps
         == 4 eager ones bit for bit and the ms a step of the first; the
         scanned full-sort test pass over 6,040 examples (Caser, SRGNN and
         LightSANs: == the per-batch pass); for DIN and DIEN instead
         `predict` on the test examples against one uniform negative each
         (inside (0, 1), the AUC) and the full sort over blocks of targets
         for 64 users, timed and projected, == one unblocked block on 8
         users x 512 items to 1e-6;
     J2. `python -m oovrec_tpu_torch.cli.run --model=Caser` on
         dataset/synth-ind for 1 epoch in the shared CLI child, which prints its launch
         counts, `--eval_only` == the run to 1e-9.
 15. phase K, the last seven sequential models, on I1's interactions with
     ML-1M's item columns and an entity table written beside them:
     K1. an `.item` file (`genre:token_seq`, 1-6 of 18 genres an item, so
         the 5-slot cap is hit; `release_year:token`, 81 values) and an
         `.ent` file (3,706 rows of `ent_id:token`, `ent_vec:float_seq` 64
         wide) loaded with the interactions through `create_dataset`
         (`additional_feat_suffix: [ent]`) and `data_preparation`, timed
         apart; GRU4RecF, SASRecF, FDSA, RepeatNet, GRU4RecKG, KSR and
         S3Rec (pretraining) at their YAML widths with `selected_features:
         [genre, release_year]` and `preload_weight: {ent_id: ent_vec}`
         through `Trainer.fit` (GRU4RecF, SASRecF, FDSA and GRU4RecKG 64
         steps of 2,048 on the plain device epoch that `auto` takes,
         RepeatNet, KSR and S3Rec 32 on the host path), finite falling
         losses, every parameter moved but the frozen entity tables,
         which stay bit for bit (`weight_decay` 0), the gathers' backward
         launched; 4 graphed steps == 4 eager ones bit for bit (RepeatNet
         on rows that repeat an item) and the ms a step of the first; the
         scanned full-sort test pass over 6,040 examples (FDSA and KSR:
         == the per-batch pass);
     K2. `python -m oovrec_tpu_torch.cli.run --model=SASRecF
         --selected_features=[category]` on dataset/synth-ind for 1 epoch
         in the shared CLI child, which prints its launch counts, `--eval_only` == the
         run to 1e-9.
 16. phase L, the general models, on I1's interactions read as a general
     dataset (random order, RS 8:1:1 by user, full sort over 3,707
     items; set-up timed apart), in the order L2, L3, phase M, L1:
     ADMMSLIM's and NCEPLRec's numpy states are solved in a worker thread
     meanwhile;
     L1. Pop, Random, ItemKNN, EASE, ADMMSLIM, NCEPLRec and SLIMElastic:
         the state built from the training split (timed; SLIMElastic's
         coordinate descent on the card, its columns stopped by the rule
         or at max_iter counted), `Trainer.fit` through the traditional
         branch (one valid pass), the test pass, metrics in [0, 1]; a
         zero diagonal (EASE, ADMMSLIM, SLIMElastic), at most k non-zeros
         a row (ItemKNN), W >= 0 (SLIMElastic), the top item the most
         counted (Pop), the same scores twice (Random);
     L2. LightGCN, NGCF, SGL, SpectralCF, GCMC, DGCF and NCL at their
         YAML widths over the 1.6 M edges of the training split on the
         host path: the edge segment sum (`ops/embed_grad.py:
         segment_sum`) at LightGCN's edges against `scatter_rows_plain`
         and a repeat run, timed beside `index_add_` and its bound; 32
         steps of 2,048 through `Trainer.fit`, finite falling losses,
         every parameter moved, the kernel launched (segment sums and
         gathers' backward); the scanned full-sort test pass; 4 graphed
         steps == 4 eager ones bit for bit and the ms a step of the first;
     L3. `python -m oovrec_tpu_torch.cli.run --model=LightGCN`, then
         `--model=Pop` (then M3's two runs), on dataset/synth-ind for 1
         epoch in the shared CLI child, which prints each run's launch counts and
         wall, each `--eval_only` == its run to 1e-9.
 17. phase M, the rest of the general family, on L's corpus and split at
     the models' YAML widths:
     M1. NeuMF, DMF, SimpleX, FISM, NAIS, LINE, ConvNCF and NNCF: the
         state from the training split (timed: the padded histories,
         NNCF's neighbours, the training matrix), 16 host steps of 2,048
         rows (one uniform negative a row) through `Trainer.fit`, finite
         falling losses, every parameter moved (ConvNCF's `out` bias
         cancels in BPR's difference and stays), the gathers' backward
         launched (DMF gathers nothing); the scanned full-sort test pass
         over the whole test split (NAIS's and ConvNCF's over its first
         512 users, the whole split projected); their and NNCF's blocked
         full sort against the per-pair definition for 8 users, to 1e-5;
         4 graphed steps == 4 eager ones bit for bit and the ms a step of
         the first;
     M2. MultiVAE, MultiDAE, CDAE, RecVAE, MacridVAE, RaCT and ENMF on
         user batches of 2,048 (`UserTrainBatcher`, three an epoch, the
         last padded): two epochs through `Trainer.fit`, finite losses,
         every parameter the loss reads moved and the others unchanged;
         RaCT's `critic_pretrain` and `finetune`, 2 steps each from the
         pretrained actor, each leaving what it detaches unchanged bit for
         bit; the scanned test pass; 4 graphed steps == 4 eager ones bit
         for bit (the dropout generators seeded alike) and the ms a step
         of the first;
     M3. `python -m oovrec_tpu_torch.cli.run --model=MultiVAE`, then
         `--model=NeuMF`, on dataset/synth-ind for 1 epoch after L3's runs
         in the shared CLI child, each `--eval_only` == its run to 1e-9.
     Phase M launches none of kernels 1-6.
 18. phase N, the knowledge models, on I1's interactions with a seeded
     knowledge graph written beside them (every item linked to its own
     entity, about 60,000 entities, 40 relations, 500,000 triples, items
     the heads of 80 %, tails Zipf-skewed over the other entities; the
     KGAT paper's KGs hold 9-42 relations and 0.46-2.56 M triples) and
     read as a `KnowledgeBasedDataset` (random order, RS 8:1:1 by user,
     full sort over 3,707 items; set-up timed apart):
     N1. CKE, CFKG, KGAT, KGCN, KGNNLS, MKR, KTUP, RippleNet, KGIN and
         MCCLK at their YAML widths: `KGTrainBatcher`'s and `KGSampler`'s
         host ms a batch; the state from the training split (timed:
         KGAT's 2.6 M collaborative edges, the KGCN / KGNNLS neighbours,
         RippleNet's ripple sets, KGIN's and MCCLK's edges), 16 host steps
         of 2,048 rows with a triple and its negative tail a row through
         `Trainer.fit`, finite losses, every parameter moved, the gathers'
         backward launched (gathers and edge segment sums) and no other
         kernel; the scanned full-sort test pass over the whole test
         split; the blocked (KGCN, KGNNLS, KTUP, RippleNet) and hoisted
         (MKR) full sorts against the per-pair definition for 8 users and
         KGAT's per-relation projection table against the per-edge
         products on 65,536 edges, to 1e-6 of the largest; 4 graphed
         steps == 4 eager ones bit for bit and the ms a step of the first;
     N2. `python -m oovrec_tpu_torch.cli.run --model=CKE` on
         tests/assets/toy-kg at its YAML widths for 1 epoch after M3's
         runs in the shared CLI child, the gathers' backward launched,
         `--eval_only` == the run to 1e-9.
     Phase N launches none of kernels 1-6.
 19. phase O, the mesh (`oovrec_tpu_torch/parallel/`), in one child process
     of its own (`o_child`: one NCCL process group of one rank, TCP
     rendezvous on 127.0.0.1 at a free port, the ('data', 'model') mesh
     {1, 1}; the card holds one rank, NCCL takes no two on one device):
     O1. the psum and all-to-all exchanges of 2,048 ids into a 100,000 x
         64 table (`sharded_embedding.py`, S = 1): rows and gradients ==
         the plain gather's bit for bit, the collectives a call counted,
         the all-to-all's overflow 0, device ms a call (forward, and
         forward + backward) beside the plain gather's;
     O2. phase 3's IV full sort (BPR, D 64, random-mapper buckets, 110,000
         users x 1,000,000 items, 256 users a batch) through `EvalRunner`
         under `use_mesh: true`, kernel 1 on the rank: hits and metrics ==
         the plain run's bit for bit, wall ms a batch;
     O3. 16 eager mesh steps (`parallel/train_step.py:mesh_step`) of
         xDeepFM at its published widths (8,192 rows, kernels 4 and 5)
         and of BPR (2,048 rows) == the plain trainer's 16 (captured)
         steps bit for bit, losses and every parameter; ms a step and the
         gradients' all-reduce's share;
     O4. `cli.run.main` (the `-m` entry's) on dataset/synth-ind with
         `--use_mesh=True --num_processes=1 --process_id=0
         --coordinator_address=127.0.0.1:<port>`, 1 epoch: rank 0 writes
         the checkpoint, `--eval_only` under the mesh == the run to 1e-9;
     O5. one model of each loss class at its YAML widths (FM on O3's
         ranking rows; GRU4Rec, BERT4Rec and S3Rec's pretraining on K1's
         files; LightGCN, SGL, NCL, SimpleX, MultiVAE, RaCT, ENMF, DirectAU
         (kernel 1 on its full sort) and Pop on L's dataset; KGAT and
         MCCLK on N's), the datasets loaded by the child while phases L-P
         run (`o5_load`): 4 eager mesh steps of 2,048 rows (FM 8,192;
         user batches of 2,048) == the plain trainer's 4 captured steps
         bit for bit, losses and every parameter, then one test pass of
         each == bit for bit; ms a step of each.
     Kernels 1, 4 and 5 and the gathers' backward are counted on the mesh
     runs alone (`launches_o`).
 20. phase P, the surfaces users reach for after a run (it runs after N,
     before O), BPR at D 64 on dataset/synth-ind with phase A's OOV flags,
     full-sort evals of 256 users a batch on kernel 1 (`use_fused_topk`
     True):
     P1. `python -m oovrec_tpu_torch.cli.run_hyper` in the shared CLI
         child: the bayes search, 2 random trials and a TPE step over a
         `.hyper` file of `learning_rate` (loguniform) and
         `embedding_size` (choice [32, 64]), one epoch a trial: rc 0,
         kernel 1 launched by every trial, the trials equal to the port's
         `HyperTuning` replayed here on the recorded scores, the best
         trial's test metrics reproduced to 1e-9 by one run of its
         parameters with `use_fused_topk` False, the card's allocated
         bytes after the third trial within P_MEM_SLACK of those after the
         first;
     P2. `utils/case_study.py:case_study_from_checkpoint` on phase A's
         checkpoint for 256 users at k 10: its items equal kernel 1's
         top-10 over the same towers and training-history bitmap wherever
         the kernel's neighbouring scores differ by more than 1e-5 (the
         exempt ranks printed);
     P3. `utils/flops.py:get_flops` of xDeepFM at its published widths on
         8,192 rows, the CIN kernels launched, equal to the count of the
         same weights and batch on the CPU; `get_environment` and
         `get_device_usage` printed;
     P4. `cli/significance_test.py:significance_test` of two learning
         rates over 2 seeds, one epoch a run: finite values;
     P5. one epoch with `log_tensorboard: true`: the event files and their
         tags where `torch.utils.tensorboard` imports, else the writer off
         and nothing written (the script sets OOVREC_DISABLE_TENSORBOARD
         for every other run).
Every `python -m oovrec_tpu_torch.cli.<module>` above runs in one shared
CLI child (`cli_process`), started while the kernels build (with phase
O's child, which waits for its turn, and the profiler's set-up) and
stopped after phase P:
it runs the module as `__main__` once a request, with the launch counts
from 0, and prints each run's wall, launches and exit code, and each
search trial's launches and allocated bytes (one process start instead of
ten, a depth cut for the 750 s budget that drops no check).
Phase 2 also holds the gathers' backward kernel (`csrc/embed_grad.cu`)
against its plain version (bit for bit on integer-valued cotangents, to
1e-5 on random ones, against a repeat run) and times it; phase 6 profiles
the device-epoch step under each backward route and phase 5 the xDeepFM
step under the kernel and the index route.
Phase 2 also holds the CIN backward kernel against its plain version,
bit for bit on integer inputs and gradients (and against itself on a
repeat run), and times it per layer and for the 3-layer stack.
The last line is the device record; the line before it lists the kernels,
each with its launches on the earlier phases' paths (`launches`), on the
CLI phases (`launches_cli`) and on phase D's to O's parts
(`launches_d`, `launches_e`, `launches_f`, `launches_g`, `launches_h`,
`launches_i`, `launches_j`, `launches_k`, `launches_l`, `launches_m`,
`launches_n`, `launches_o`, `launches_p`),
each counted by the kernel's wrapper where it launches (`ops/launches.py`;
a CUDA graph's replays run no wrapper), and the kernels that phase F's to
N's graphed passes replayed, as their profiler traces show them
(`launches_f_trace` ... `launches_n_trace`); before them, phase F's to P's
times as JSON lines (`phase F times` ... `phase O times`, and phase P's
beside the card's name and power limit) and the edge segment sum's
numbers.

TF32 is switched off for matmuls and cuDNN below: the plain versions and
the dense path must compute in full f32, as the kernel does.
"""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from oovrec_tpu_torch.cli import quick_start
from oovrec_tpu_torch.cli import run as cli_run
from oovrec_tpu_torch.cli.inductive_eval import perform_inductive_eval
from oovrec_tpu_torch.config import Config, parse_cli_args
from oovrec_tpu_torch.data import dataset as dataset_module
from oovrec_tpu_torch.data.sequential import (
    SeqDatasetSplit,
    SeqFullSortEvalBatcher,
    SequentialDataset,
)
from oovrec_tpu_torch.data.transfer import to_device_batch
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
from oovrec_tpu_torch.data import (
    DatasetSplit,
    FullSortEvalBatcher,
    NegSampleEvalBatcher,
    PlainEvalBatcher,
    Sampler,
    TrainBatcher,
)
from oovrec_tpu_torch.data.dataloader import KGTrainBatcher, UserTrainBatcher
from oovrec_tpu_torch.eval import EvalRunner, InductiveEvaluator
from oovrec_tpu_torch.inductive import DHEHasher, InductiveSpec, RandomOOVMapper
from oovrec_tpu_torch.models import BPR, FieldSpec, get_model_class, xDeepFM
from oovrec_tpu_torch.models.layers import BatchNorm
from oovrec_tpu_torch.ops import embed_grad, launches, topk_score
from oovrec_tpu_torch.ops.cin_fused import (
    cin_layer,
    cin_layer_bwd,
    cin_layer_bwd_plain,
    cin_layer_plain,
    cin_layer_pooled,
    cin_layer_pooled_bwd,
    cin_layer_pooled_bwd_plain,
    cin_layer_pooled_plain,
    bwd_plan,
    fwd_geometry,
    fwd_plan,
)
from oovrec_tpu_torch.ops.topk_score import (
    K_CLASSES,
    NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    fused_topk_scores_plain,
    k_class,
    pack_bitplane,
    range_split,
    stream_users,
    unpack_bitmap,
)
from oovrec_tpu_torch.ops.siphash import siphash24_batch
from oovrec_tpu_torch.ops.siphash_device import MAX_HASH, dhe_codes_device
from oovrec_tpu_torch.ops.sparse_rows import sparse_adam_rows_kernel, sparse_adam_rows_plain
from oovrec_tpu_torch.train import Trainer
from oovrec_tpu_torch.train.sparse_update import coalesce_rows
from oovrec_tpu_torch.utils import cuda_build
from oovrec_tpu_torch.utils.enums import InputType
from oovrec_tpu_torch.utils.precision import set_policy
from oovrec_tpu_torch.utils.seeding import torch_generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = 2020
DEVICE = "cuda"
# published peaks of one H100 SXM: HBM3 bandwidth and dense FP32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the repo's real serving scale (tools/bench_inductive_eval.py:1-40)
N_OLD_USERS, N_NEW_USERS = 100_000, 10_000
N_OLD_ITEMS, N_NEW_ITEMS = 900_000, 100_000
B, D, K = 256, 64, 20
N_TEST_USERS, MAX_HIST, MAX_POS = 1024, 64, 16
TOPK = [3, 5, 10, 20]
# the ranking track: xDeepFM at its published widths
# (oovrec_tpu/config/model/xDeepFM.yaml) over the repo's CTR field layout
# (bench.py:515-562) with 10 % new users and items
N_CTR_OLD_USERS, N_CTR_NEW_USERS = 200_000, 20_000
N_CTR_OLD_ITEMS, N_CTR_NEW_ITEMS = 100_000, 10_000
CTR_B, CTR_BATCHES, CTR_D = 8192, 128, 10
CIN_SIZES, MLP_SIZES = (100, 100, 100), (128, 128, 128)
# random inputs, outputs of order 1: f32 sums taken in another order. The
# bf16 mode is held to the same bound, tighter than a bf16 tolerance: kernel
# and plain version round the same operands and products to bf16. The
# backward's outputs sum up to B*D terms, so each is held to CIN_TOL
# relative to max(1, its largest magnitude)
CIN_TOL = 1e-4
# random backward inputs: the incoming gradient is zeroed where the f64
# pre-activation lies within this band of 0, so that the ReLU mask there (a
# rounding matter between two summation orders) does not decide the result
CIN_MASK_BAND = 1e-3
# training: the ranking and retrieval trainers' batch sizes (bench.py's
# CTR_BATCH and the train_batch_size default) and the kernel-vs-plain
# training comparison
CTR_TRAIN_FRACTION = 0.9
BPR_TRAIN_B, BPR_TRAIN_STEPS = 2048, 64
COMPARE_STEPS, LOSS_RTOL, PARAM_ATOL = 16, 1e-5, 1e-4
# a CIN wider than one backward launch takes (L > 128): `fused_cin: auto`
# trains it on the kernels (two column groups a backward) and serves it
WIDE_CIN_SIZES, WIDE_STEPS = (200, 200, 200), 4
# the retrieval track's sparse-adam training (bench.py:61-65, 348-510): BPR
# at D = 64 over 200,000 users x 100,000 items, 1,024 random-mapper buckets
# a side, pairwise steps of 8,192 rows, 100 steps (bench.py's STEPS); each
# user in one of 64 groups, 90 % of its items from the group's slice, so the
# loss can fall; lr 1e-2 moves it within the one epoch (bench.py times the
# step at 1e-3)
SP_USERS, SP_ITEMS, SP_BUCKETS, SP_B, SP_STEPS = 200_000, 100_000, 1024, 8192, 100
SP_GROUPS, SP_IN_GROUP, SP_LR = 64, 0.9, 1e-2
# an element beyond PARAM_ATOL is explained when at some step its gradient
# differed between the paths by more than this (relative): more than f32
# summation rounding (about 1e-6 here) can do
EXPLAINED_GRAD_RTOL, MAX_EXPLAINED_FRACTION = 1e-3, 1e-5


def log(*args):
    print(*args, flush=True)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------- kernels


def exact_inputs(b, n, d, seed, tied=False):
    """Inputs whose f32 dot products are exact in any summation order, so
    kernel and plain must agree bit for bit. Column 0 gives every item a
    distinct fraction perm(i)·2⁻²⁰ (no ties) unless `tied`, where all
    scores are small integers (ties everywhere)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, 2, size=(b, d)).astype(np.float32)
    u[:, 0] = 1.0
    it = np.zeros((n, d), np.float32)
    cols = rng.integers(1, d, size=(n, 3))
    np.put_along_axis(it, cols, 1.0, axis=1)
    if not tied:
        it[:, 0] = rng.permutation(n).astype(np.float32) * 2.0**-20
    return (torch.from_numpy(u).to(DEVICE), torch.from_numpy(it).to(DEVICE))


def random_hist(b, n, h, seed):
    rng = np.random.default_rng(seed)
    hist = np.zeros((b, h), np.int64)
    hist_len = rng.integers(0, h + 1, size=b)
    for r in range(b):
        hist[r, : hist_len[r]] = rng.choice(np.arange(1, n), hist_len[r], replace=False)
    return torch.from_numpy(hist).to(DEVICE), torch.from_numpy(hist_len).to(DEVICE)


def check_exact(name, u, it, bm, k):
    kv, ki = fused_topk_scores(u, it, bm, k=k)
    sync()
    pv, pi = fused_topk_scores_plain(u, it, bm, k=k)
    require(kv.shape == (u.shape[0], k) and ki.dtype == torch.int32, f"{name}: shape")
    require(torch.equal(kv, pv), f"{name}: values differ from the plain version")
    require(torch.equal(ki, pi), f"{name}: indices differ from the plain version")
    return kv, ki


def lowest_index_ties(u, it, bm, vals, idx):
    """Every selected index is the lowest unexcluded item not selected
    before it among the items of its score."""
    scores = (u @ it.T).masked_fill(unpack_bitmap(bm, it.shape[0]), NEG_INF)
    for r in range(min(8, u.shape[0])):
        picked = set()
        for v, i in zip(vals[r].tolist(), idx[r].tolist()):
            same = torch.nonzero(scores[r] == v).flatten().tolist()
            first = next(j for j in same if j not in picked)
            require(i == first, f"tie row {r}: index {i}, lowest is {first}")
            picked.add(i)


def kernel_cases():
    """Kernel vs plain on the card, exactly."""
    cases = [
        # name, B, N, D, k, exclude_col0
        ("main", B, N_OLD_ITEMS + N_NEW_ITEMS, D, K, True),
        ("ragged", 37, 4099, 64, 10, False),
        ("odd-depth", 5, 700, 48, 20, True),
        ("n-below-k", 6, 13, 64, 20, True),
        ("depth-7", 11, 3000, 7, 20, True),
        ("k1", B, 200_000, D, 1, True),
        ("k100", 70, 200_003, D, 100, True),
        ("k512", 20, 100_001, D, 512, False),
        ("k512-n-below-k", 3, 300, D, 512, True),
        ("k600", 20, 100_001, D, 600, False),
        ("k1024-ragged", 7, 5003, D, 1024, True),
        ("deep-D2048", 37, 20_000, 2048, 20, True),  # the user tile streams
        ("deep-D1000-k600", 5, 10_000, 1000, 600, True),
        ("B1", 1, 300_000, D, K, True),
        ("B257", 257, 50_000, D, K, True),
    ]
    for i, (name, b, n, d, k, ex) in enumerate(cases):
        u, it = exact_inputs(b, n, d, seed=SEED + i)
        hist, hist_len = random_hist(b, n, min(64, n - 1), seed=SEED + 100 + i)
        bm = build_hist_bitmap(hist, hist_len, n, exclude_col0=ex)
        check_exact(name, u, it, bm, k)
        cls = k_class(k, d)
        log(f"kernel check {name}: B={b} N={n} D={d} k={k} exclude_col0={ex} "
            f"({topk_ranges(b, n, d, k)} item ranges, k class {cls}, user tile "
            f"{'streamed' if stream_users(cls, d) else 'whole'}): exact")

    # users with fewer than k live items: their tail slots hold the lowest
    # excluded items, in the kernel as in the plain version
    b, n, k = 9, 600, 20
    u, it = exact_inputs(b, n, 64, seed=SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    dense = torch.zeros((b, n), dtype=torch.bool, device=DEVICE)
    for r in range(b):
        live = rng.choice(np.arange(1, n), size=int(rng.integers(0, 2 * k)), replace=False)
        dense[r] = True
        dense[r, torch.from_numpy(live).to(DEVICE)] = False
    bm = torch.stack([pack_bitplane(m) for m in dense])
    kv, _ = check_exact("all-masked-tail", u, it, bm, k)
    require(bool((kv == NEG_INF).any()), "all-masked-tail: no dead slot exercised")
    log("kernel check all-masked-tail: exact, dead slots present")

    for name, b, n in (("tied", 64, 100_003), ("tied-ragged", 33, 5000)):
        u, it = exact_inputs(b, n, 64, seed=SEED + 9, tied=True)
        hist, hist_len = random_hist(b, n, 64, seed=SEED + 10)
        bm = build_hist_bitmap(hist, hist_len, n)
        kv, ki = check_exact(name, u, it, bm, K)
        lowest_index_ties(u, it, bm, kv, ki)
        log(f"kernel check {name}: B={b} N={n}: exact, ties to the lowest index")

    # every item scores the same: each range offers its lowest live items
    # and the merge must keep the lowest across range boundaries
    for name, b, n, k in (("tied-across-ranges", 40, 60_000, K),
                          ("tied-across-ranges-k100", 9, 60_000, 100)):
        u = torch.ones((b, D), device=DEVICE)
        it = torch.full((n, D), 0.5, device=DEVICE)
        hist, hist_len = random_hist(b, n, 64, seed=SEED + 11)
        bm = build_hist_bitmap(hist, hist_len, n)
        _, ki = check_exact(name, u, it, bm, k)
        live = ~unpack_bitmap(bm, n)
        for r in range(b):
            lowest = torch.nonzero(live[r]).flatten()[:k].to(torch.int32)
            require(torch.equal(ki[r], lowest), f"{name}: row {r} is not the lowest live items")
        ranges = topk_ranges(b, n, D, k)
        require(ranges > 1, f"{name}: one item range only")
        log(f"kernel check {name}: B={b} N={n} k={k}, {ranges} item ranges: exact, "
            "ties to the lowest index across range boundaries")


def topk_ranges(b, n, d, k):
    """The number of item ranges the top-k kernel splits N into."""
    cls = k_class(k, d)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return range_split(n, k, K_CLASSES[cls][0], b, n_sm)[1]


def time_ms(fn, inputs, reps):
    """Median ms of `fn(*inputs[r % len(inputs)])`, CUDA events, a
    synchronize after every launch."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        args = inputs[r % len(inputs)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn, inputs, n=10, reps=10):
    """Median ms a call of `fn` over n calls enqueued back to back between
    two events: the device's time, without the host's time of one call."""
    return time_ms(lambda *args: [fn(*args) for _ in range(n)], inputs, reps) / n


def kernel_timing():
    """Kernel, plain and library times at the main-path shapes on random
    f32 inputs, with the kernel's largest difference from the plain
    version (tolerance: 1e-4 absolute on scores of order 1, f32 sums of 64
    products taken in another order)."""
    n = N_OLD_ITEMS + N_NEW_ITEMS
    g = torch_generator(SEED, DEVICE)
    item_e = torch.randn((n, D), generator=g, device=DEVICE) / math.sqrt(D)
    inputs = []
    for i in range(3):
        user_e = torch.randn((B, D), generator=g, device=DEVICE)
        hist, hist_len = random_hist(B, n, MAX_HIST, seed=SEED + 20 + i)
        bm = build_hist_bitmap(hist, hist_len, n)
        inputs.append((user_e, item_e, bm))

    kv, ki = fused_topk_scores(*inputs[0], k=K)
    sync()
    pv, pi = fused_topk_scores_plain(*inputs[0], k=K)
    max_abs_err = float((kv - pv).abs().max())
    require(max_abs_err <= 1e-4, f"main shape: max |kernel - plain| {max_abs_err}")
    # an index may differ only where two scores are within the tolerance
    user_e, _, bm = inputs[0]
    plain_at_kernel = (user_e @ item_e.T).gather(1, ki.long())
    require(float((plain_at_kernel - pv).abs().max()) <= 1e-4,
            "main shape: kernel picked an item the plain version ranks lower")
    idx_agree = float((ki == pi).float().mean())

    def fused(u, it, m):
        return fused_topk_scores(u, it, m, k=K)

    def plain(u, it, m):
        return fused_topk_scores_plain(u, it, m, k=K)

    dense_masks = [unpack_bitmap(m, n) for _, _, m in inputs]

    def library(u, it, mask):  # yardstick only; the port never calls this
        return torch.topk((u @ it.T).masked_fill_(mask, NEG_INF), K, dim=1)

    ms = time_ms(fused, inputs, 30)
    plain_ms = time_ms(plain, inputs, 6)
    library_ms = time_ms(
        library, [(u, it, mk) for (u, it, _), mk in zip(inputs, dense_masks)], 30
    )
    # the selection's share grows with k, the score product does not
    by_k = {
        kk: time_ms(lambda u, it, m, kk=kk: fused_topk_scores(u, it, m, k=kk),
                    inputs, 20)
        for kk in (1, 10, 100)
    }
    by_k[K] = ms
    w = -(-n // 32)
    bytes_moved = 4 * (B * D + n * D + B * w) + 8 * B * K
    flops = 2 * B * n * D
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    log("kernel_ms by k: " + " ".join(f"k={kk}:{t:.4f}" for kk, t in sorted(by_k.items()))
        + f" (bound {max(t_bytes, t_ops):.4f} ms; k={K} / k=1: {ms / by_k[1]:.3f})")
    log(f"timing B={B} N={n} D={D} k={K}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (matmul + mask + torch.topk) "
        f"bytes_ms={t_bytes:.4f} ops_ms={t_ops:.4f} "
        f"max_abs_err={max_abs_err:.3e} index_agreement={idx_agree:.6f}")
    return {
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


# ----------------------------------------------------------------- serving


def build_model():
    spec = InductiveSpec(
        mapper="random", add_oov_buckets=True,
        n_user_buckets=100, n_item_buckets=100, hash_function="3round",
    )
    return BPR(
        N_OLD_USERS, N_OLD_ITEMS, D, spec, device=DEVICE,
        generator=torch_generator(SEED, DEVICE),
    )


@torch.no_grad()
def synth_interactions(model, mapper):
    """Seeded test users (a quarter new) with histories (≤ 64) and
    positives (≤ 16). Half of each user's positives and a few history items
    come from the user's top-24 old and top-24 new items under the model,
    so every slice and the history mask have something to show."""
    rng = np.random.default_rng(SEED)
    n_items = N_OLD_ITEMS + N_NEW_ITEMS
    n_new = N_TEST_USERS // 4
    users = np.concatenate([
        rng.choice(np.arange(1, N_OLD_USERS), N_TEST_USERS - n_new, replace=False),
        rng.choice(np.arange(N_OLD_USERS, N_OLD_USERS + N_NEW_USERS), n_new,
                   replace=False),
    ])
    ids = torch.arange(n_items, device=DEVICE)
    oov = users >= N_OLD_USERS
    batch = {
        "user_id": torch.from_numpy(users).to(DEVICE),
        "user_id_oov": torch.from_numpy(oov.astype(np.int64)).to(DEVICE),
    }
    if mapper is None:  # a DHE model: the ids hashed on the card
        item_e = model.all_item_embeddings(ids, item_dhe_ids=ids)
        batch["user_id_dhe_id"] = batch["user_id"]
    else:
        buckets = torch.from_numpy(
            np.where(np.arange(n_items) >= N_OLD_ITEMS,
                     mapper.item_buckets(np.arange(n_items)), 0)
        ).to(DEVICE)
        item_e = model.all_item_embeddings(ids, buckets)
        batch["user_id_bucket"] = torch.from_numpy(
            np.where(oov, mapper.user_buckets(users), 0)).to(DEVICE)
    scores = model.score_against(batch, item_e)
    # old and new items separately: bucket rows outscore the IV table at init
    top_old = torch.topk(scores[:, 1:N_OLD_ITEMS], 24, dim=1).indices + 1
    top_new = torch.topk(scores[:, N_OLD_ITEMS:], 24, dim=1).indices + N_OLD_ITEMS
    top = torch.cat([top_old, top_new], dim=1).cpu().numpy()
    del scores

    hist_u, hist_i, pos_u, pos_i = [], [], [], []
    for r, u in enumerate(users):
        n_pos = int(rng.integers(1, MAX_POS + 1))
        n_hist = int(rng.integers(0, MAX_HIST + 1))
        near = rng.permutation(top[r])
        far = rng.choice(np.arange(1, n_items), n_pos + n_hist, replace=False)
        pool = list(dict.fromkeys(np.concatenate([near[: n_pos // 2 + 4], far])))
        pos = pool[: n_pos]
        hist = pool[n_pos: n_pos + n_hist]
        pos_u += [u] * len(pos)
        pos_i += pos
        hist_u += [u] * len(hist)
        hist_i += hist
    as_split = lambda uu, ii, n_u, n_i: DatasetSplit(  # noqa: E731
        {"user_id": np.asarray(uu, np.int64), "item_id": np.asarray(ii, np.int64)},
        n_u, n_i,
    )
    n_users = N_OLD_USERS + N_NEW_USERS
    train = as_split(hist_u, hist_i, n_users, n_items)
    test = as_split(pos_u, pos_i, n_users, n_items)
    # the IV full-sort corpus: old users, old items
    keep_h = (np.asarray(hist_u) < N_OLD_USERS) & (np.asarray(hist_i) < N_OLD_ITEMS)
    keep_p = (np.asarray(pos_u) < N_OLD_USERS) & (np.asarray(pos_i) < N_OLD_ITEMS)
    iv_train = as_split(np.asarray(hist_u)[keep_h], np.asarray(hist_i)[keep_h],
                        N_OLD_USERS, N_OLD_ITEMS)
    iv_test = as_split(np.asarray(pos_u)[keep_p], np.asarray(pos_i)[keep_p],
                       N_OLD_USERS, N_OLD_ITEMS)
    return (train, test), (iv_train, iv_test)


def loader(splits, cfg):
    train, test = splits
    sampler = Sampler(["train", "test"], [train, test], seed=SEED)
    return FullSortEvalBatcher(test, sampler, cfg, phase="test")


def agree(a, b, what, tol=1e-9):
    require(list(a) == list(b), f"{what}: keys differ")
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            agree(x, y, f"{what}[{key}]", tol)
        else:
            require(abs(x - y) < tol, f"{what}[{key}]: {x} vs {y}")


def serving_cfg(fused, n_items, device_eval=False):
    """The serving eval's config; the per-batch eval unless `device_eval`
    (phase 3 times it a batch; phase F5 holds the scanned eval to it)."""
    return Config({
        "topk": TOPK, "seed": SEED, "eval_batch_size": B * n_items,
        "use_perturbed_hits": False, "use_fused_topk": "auto" if fused else False,
        "device_eval": device_eval,
    })


def serving():
    model = build_model()
    mapper = RandomOOVMapper(
        model.spec, N_OLD_USERS, N_OLD_ITEMS,
        N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS,
    )
    mapper.set_eval()
    t0 = time.perf_counter()
    ind_splits, iv_splits = synth_interactions(model, mapper)
    log(f"serving data: {len(ind_splits[1])} test positives, "
        f"{len(ind_splits[0])} history rows, {time.perf_counter() - t0:.1f} s")

    cfg = serving_cfg
    launches = seven_slices_fused_vs_dense(model, mapper, ind_splits, cfg)
    full_sort_fused_vs_dense(model, iv_splits)
    SERVING.update(model=model, iv_splits=iv_splits)  # phase F5
    # after the counted runs: where the time of the default (perturbed)
    # fused inductive eval goes on the device
    c = cfg(True, N_OLD_ITEMS + N_NEW_ITEMS)
    c["use_perturbed_hits"] = True
    breakdown(InductiveEvaluator(model, c, N_OLD_USERS, N_OLD_ITEMS, mapper=mapper),
              loader(ind_splits, c))
    return launches


def full_sort_fused_vs_dense(model, iv_splits, what="full-sort eval"):
    """The IV full-sort eval on the fused path (one top-k launch a batch)
    and on the dense path: equal to 1e-9. → the fused run's launches."""
    iv, counts = {}, {}
    for fused in (True, False):
        c = serving_cfg(fused, N_OLD_ITEMS)
        iv_loader = loader(iv_splits, c)
        runner = EvalRunner(model, c)
        topk_score.fused_topk_scores.launches = 0
        t0 = time.perf_counter()
        iv[fused] = runner.evaluate(iv_loader)
        sync()
        wall = time.perf_counter() - t0
        counts[fused] = n_launch = topk_score.fused_topk_scores.launches
        require(runner._use_fused(iv_loader.item_num) is fused, f"{what}: runner fused path")
        require(n_launch == (len(iv_loader) if fused else 0), f"{what}: launches {n_launch}")
        log(f"{what} {'fused' if fused else 'dense'}: {len(iv_loader)} batches, "
            f"{wall / len(iv_loader) * 1e3:.1f} ms per batch, kernel launches {n_launch}")
    log(f"[{what}] {dict(iv[True])}")
    agree(iv[True], iv[False], f"{what} fused vs dense")
    log(f"{what}: fused == dense (1e-9)")
    return counts[True]


def seven_slices_fused_vs_dense(model, mapper, ind_splits, cfg, what="inductive eval"):
    """The 7-slice inductive eval on the fused path and on the dense path:
    equal to 1e-9, the fused one launching the top-k kernel 4 times a
    batch. → the fused run's launch count."""
    results, counts = {}, {}
    for fused in (True, False):
        c = cfg(fused, N_OLD_ITEMS + N_NEW_ITEMS)
        test_loader = loader(ind_splits, c)
        require(test_loader.users_per_batch == B, "users_per_batch")
        ev = InductiveEvaluator(model, c, N_OLD_USERS, N_OLD_ITEMS, mapper=mapper)
        topk_score.fused_topk_scores.launches = 0
        sync()
        t0 = time.perf_counter()
        results[fused] = ev.evaluate_model(test_loader)
        sync()
        wall = time.perf_counter() - t0
        counts[fused] = topk_score.fused_topk_scores.launches
        require(ev._fused is fused, f"{what} fused path active: {ev._fused}")
        log(f"{what} {'fused' if fused else 'dense'}: {len(test_loader)} "
            f"user batches of {B}, {wall / len(test_loader) * 1e3:.1f} ms per batch "
            f"(wall, host included), kernel launches {counts[fused]}")
    launches = counts[True]
    require(launches == 4 * len(test_loader), f"{what}: fused launches {launches}")
    require(counts[False] == 0, f"{what}: the dense path launched the kernel")
    for s, r in results[True].items():
        log(f"[{s}] {dict(r)}")
    agree(results[True], results[False], f"{what} fused vs dense")
    require(results[True]["overall"]["hit@20"] > 0, f"{what}: overall hit@20 is 0")
    log(f"{what}: fused == dense on all 7 slices (1e-9)")
    return launches


def breakdown(evaluator, test_loader, what="fused inductive eval (perturbed hits on)",
              shares=(("top-k kernel", ("topk_range_kernel",)),)):
    """torch.profiler over one warm inductive eval pass: device time by
    kernel, a batch's wall and device time and the device's busy share of
    the wall time."""
    evaluator.evaluate_model(test_loader)  # warm: allocator, library load
    sync()
    n = len(test_loader)
    wall_ms, busy_ms = profiled(lambda: evaluator.evaluate_model(test_loader),
                                f"profile {what}: {n} batches", shares, gathers=False)
    log(f"  a batch: wall {wall_ms / n:.2f} ms under the profiler, device {busy_ms / n:.3f} ms")


GATHER_NODE = "_GatherRowsBackward"
# the gathers' backward measurements of phases D4 and 6, for the last lines
GATHER_RESULTS = {}


def trace_launches(rows):
    """Each registered kernel's launches in a profiler trace's device
    rows (time, name, count), by the name of its `__global__` function."""
    out = {fn.kernel: 0 for fn in launches.WRAPPERS.values()}
    for _, key, n in rows:
        for kernel in out:
            if re.search(rf"(^|[\s:]){kernel}[<(]", key):
                out[kernel] += n
    return out


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
RUN_SPAN = "chip_smoke.run"  # the span of a profiled run in its trace
LEAD_LAUNCHES = 256          # kernels a trace window opens with
EDGE_PAUSE_S = 0.1           # host pause between the window's edges and the run


def run_calls(events):
    """The CUDA API calls (launches, copies) inside a trace's RUN_SPAN:
    correlation id → name. A device record carries its call's correlation
    id (a graph replay's kernels, the replay's), so no device timestamp is
    compared with a host one."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.device_type() == cpu and e.name() == RUN_SPAN]
    return {e.correlation_id(): e.name() for e in events
            if e.device_type() == cpu and e.name().startswith("cu")
            and any(t0 <= e.start_ns() <= t1 for t0, t1 in spans)}


def lost_records(events):
    """The kernel-launch calls of a profiled run whose kernels left no
    device record: records the trace dropped, so it undercounts the
    kernels that ran."""
    on_device = {e.correlation_id() for e in events
                 if e.device_type() != torch.autograd.DeviceType.CPU}
    return sum(1 for c, name in run_calls(events).items()
               if name.startswith(LAUNCH_CALLS) and c not in on_device)


def node_device_us(events, suffix):
    """(device µs, calls) of the CPU spans named `...suffix` (an autograd
    node) whose kernels took the most device time: the device time of the
    kernels launched inside each span, on the span's thread, summed by span
    name, as `key_averages()` gives a name's device time total, without
    aggregating every event of the trace (seconds over a large trace)."""
    import bisect

    cpu = torch.autograd.DeviceType.CPU
    spans = {}  # thread → sorted [(start, end, name)]
    for e in events:
        if e.device_type() == cpu and e.name().endswith(suffix):
            spans.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns(), e.name()))
    for v in spans.values():
        v.sort()
    owner = {}  # correlation id of a call → the names of the spans around it
    for e in events:
        mine = spans.get(e.start_thread_id()) if e.device_type() == cpu else None
        if not mine or not e.name().startswith("cu"):
            continue
        t = e.start_ns()
        i = bisect.bisect_right(mine, (t, float("inf"), ""))
        # a thread's spans nest (the engine's evaluate_function span holds
        # the node's own) but never overlap otherwise: the spans around a
        # call are among the last few that started before it
        names = {name for t0, t1, name in mine[max(0, i - 8):i] if t0 <= t <= t1}
        if names:
            owner[e.correlation_id()] = names
    totals = {name: [0.0, 0] for v in spans.values() for _, _, name in v}
    for v in spans.values():
        for _, _, name in v:
            totals[name][1] += 1
    for e in events:
        if e.device_type() != cpu and e.correlation_id() in owner:
            for name in owner[e.correlation_id()]:
                totals[name][0] += e.duration_ns() / 1e3
    return max(((us, n) for us, n in totals.values()), default=(0.0, 0))


def device_rows(events):
    """(µs, name, count) of the device activities (kernels, copies) of a
    profiled run's calls, by name, the longest first."""
    calls = run_calls(events)
    rows = {}
    for e in events:
        if (e.device_type() != torch.autograd.DeviceType.CPU and e.name() != RUN_SPAN
                and e.correlation_id() in calls):
            us, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, name, n) for name, (us, n) in rows.items() if us > 0), reverse=True)


def profiled(run, what, shares=(), quiet=False, gathers=True):
    """torch.profiler around `run()`: the wall, the device's busy share of
    it, the largest device kernels and, for each (label, name prefixes) of
    `shares`, those kernels' share of the device time, launches and device
    ms a launch; where `gathers`, the device time under the gathers'
    backward node (`profiled.gathers_ms`, `node_device_us`: reading it
    through `key_averages` took 1-4 host s a trace, 18 s a run of the
    script). `profiled.lost`
    is the run's `lost_records`; the host seconds the profiler's stop and
    the reading of its trace took are logged."""
    from torch.profiler import ProfilerActivity, profile, record_function

    t_open = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace keeps the device records that fall inside its window
        # by their timestamps, which can be off from the host's clock by
        # milliseconds: a run's first kernels lost their records when the
        # window opened at the run (tools/torch_trace_records.py). The run
        # starts after LEAD_LAUNCHES small kernels, a synchronise and a
        # pause, and ends a pause before the window does.
        if DEVICE == "cuda":
            lead = torch.zeros(1, device=DEVICE)
            for _ in range(LEAD_LAUNCHES):
                lead.add_(1)
            sync()
            time.sleep(EDGE_PAUSE_S)
        with record_function(RUN_SPAN):
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if DEVICE == "cuda":
            time.sleep(EDGE_PAUSE_S)
        t_stop = time.perf_counter()
    t_read = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    profiled.lost = lost_records(events)

    # device activities only (kernels, copies), the lead-in's excluded: an
    # aten op's row repeats the device time of the kernels it launched
    rows = device_rows(events)
    busy_ms = sum(r[0] for r in rows) / 1e3
    profiled.kernels = trace_launches(rows)
    profiled.rows = rows
    t_rows = time.perf_counter()
    # the row gathers' backward (ops/embed_grad.py): the device time of the
    # kernels its autograd node launched, sort and segment sums included
    g_us, g_n = node_device_us(events, GATHER_NODE) if gathers else (0, 0)
    t_done = time.perf_counter()
    log(f"{what}, wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)"
        + (f"; {profiled.lost} launch calls lost their kernel records" if profiled.lost else "")
        + f"; host s: window {t_stop - t_open:.2f}, stop {t_read - t_stop:.2f}, events "
        f"{t_rows - t_read:.2f} ({len(events)})"
        + (f", the gathers' node {t_done - t_rows:.2f}" if gathers else ""))
    profiled.gathers_ms = g_us / 1e3 if gathers else None
    if gathers:
        log(f"  gathers' backward ({backward_route.name} route): {g_us / 1e3:.3f} ms "
            f"({100 * g_us / 1e3 / max(busy_ms, 1e-9):.1f} % of device time), {g_n} calls")
    for label, prefixes in shares:
        mine = [(us, n) for us, key, n in rows if any(p in key for p in prefixes)]
        ms = sum(us for us, _ in mine) / 1e3
        n = sum(c for _, c in mine)
        log(f"  {label}: {ms:.3f} ms ({100 * ms / max(busy_ms, 1e-9):.1f} % of device time), "
            f"{n} launches, {ms / max(n, 1):.4f} ms a launch")
    for us, key, count in ([] if quiet else rows[:12]):
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return wall_ms, busy_ms


# ------------------------------------------------------------ CIN kernel

# name, B, H, F, D, L, n_hidden, pool_all; n_hidden None is `cin_layer`
CIN_CASES = [
    ("layer0", CTR_B, 7, 7, CTR_D, 100, 50, False),
    ("layer1", CTR_B, 50, 7, CTR_D, 100, 50, False),
    ("layer2", CTR_B, 50, 7, CTR_D, 100, 0, True),
    ("direct", 1000, 7, 7, CTR_D, 100, 100, True),
    ("cin_layer", CTR_B, 50, 7, CTR_D, 100, None, False),
    ("depth16", 4096, 50, 7, 16, 100, 50, False),
    ("F39", 512, 50, 39, CTR_D, 100, 50, False),  # W 1950x100: 780 KB
    ("F39-cin_layer", 256, 39, 39, CTR_D, 100, None, False),
    ("ragged37", 37, 50, 7, CTR_D, 100, 50, False),
    ("ragged1000", 1000, 50, 7, CTR_D, 100, 0, True),
    ("odd-D7-L33", 300, 7, 7, 7, 33, 16, False),
    ("odd-D7-L33-last", 301, 16, 7, 7, 33, 0, True),
    ("odd-cin_layer", 37, 7, 7, 7, 33, None, False),
    # the edges of the geometry (ops/cin_fused.py:fwd_geometry, fwd_plan,
    # bwd_plan): 128 columns in one pass, 200 in two (two column groups in
    # the backward), one and 128 rows (b, d) a batch row, a pair axis of
    # 700; D = 200 in two spans, and A's rows at H = 350, D = 128 beyond
    # shared memory (two spans of 64)
    ("L128", 1000, 50, 7, CTR_D, 128, 64, False),
    ("L200", 700, 50, 7, CTR_D, 200, 100, False),
    ("L200-cin_layer", 300, 50, 7, CTR_D, 200, None, False),
    ("D1", 300, 50, 7, 1, 100, 50, False),
    ("D128", 20, 50, 7, 128, 100, 50, False),
    ("direct-H100", 1000, 100, 7, CTR_D, 100, 100, True),
    ("D200", 20, 50, 7, 200, 100, 50, False),
    ("D200-L200-direct", 9, 16, 7, 200, 200, 200, True),
    ("H350-D128", 8, 350, 7, 128, 100, 50, False),
]


def cin_inputs(b, h, f, d, l, seed, exact):
    """(a, b0, w, bias) on the card. `exact`: A, B0 in {-1, 0, 1}, W in
    {-2..2}, integer bias, so every product and sum is an exact integer in
    f32 (and in bf16 operands) and kernel and plain must agree bit for
    bit. Otherwise normal values scaled to outputs of order 1."""
    rng = np.random.default_rng(seed)
    if exact:
        arrays = (rng.integers(-1, 2, (b, h, d)), rng.integers(-1, 2, (b, f, d)),
                  rng.integers(-2, 3, (h * f, l)), rng.integers(-3, 4, l))
    else:
        arrays = (rng.standard_normal((b, h, d)), rng.standard_normal((b, f, d)),
                  rng.standard_normal((h * f, l)) / math.sqrt(h * f),
                  rng.standard_normal(l) * 0.1)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(DEVICE) for x in arrays)


def cin_pair(inputs, nh, pool_all, mxu):
    """(kernel outputs, plain outputs) as flat tensor lists."""
    if nh is None:
        got = [cin_layer(*inputs, mxu_dtype=mxu)]
        sync()
        return got, [cin_layer_plain(*inputs, mxu_dtype=mxu)]
    got = cin_layer_pooled(*inputs, mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    sync()
    want = cin_layer_pooled_plain(*inputs, mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    return ([t for t in got if t is not None], [t for t in want if t is not None])


def cin_cases():
    """The CIN kernel against its plain version on the card: bit for bit on
    exact inputs, to CIN_TOL on random ones, in both precision modes, and
    against itself on a repeat run."""
    for i, (name, b, h, f, d, l, nh, pool_all) in enumerate(CIN_CASES):
        errs = {}
        for mxu in ("float32", "bfloat16"):
            got, want = cin_pair(cin_inputs(b, h, f, d, l, SEED + 300 + i, True),
                                 nh, pool_all, mxu)
            require(len(got) == len(want) and all(
                g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
                f"cin {name} {mxu}: kernel differs from the plain version on exact inputs")
            inputs = cin_inputs(b, h, f, d, l, SEED + 400 + i, False)
            got, want = cin_pair(inputs, nh, pool_all, mxu)
            errs[mxu] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            require(errs[mxu] <= CIN_TOL, f"cin {name} {mxu}: max |kernel - plain| {errs[mxu]}")
            again, _ = cin_pair(inputs, nh, pool_all, mxu)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"cin {name} {mxu}: a repeat run gave other bits")
        spans = fwd_plan(b, h, f, d, l)
        geo = fwd_geometry(b, h, f, spans[0][1], l)
        log(f"cin check {name}: B={b} H={h} F={f} D={d} L={l} n_hidden={nh} "
            f"pool_all={pool_all} ({len(spans)} D span(s), {geo.tb} batch rows a block, "
            f"{geo.passes} pass(es) of {geo.cols} columns): exact (f32, bf16); random "
            f"max_abs_err f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; a repeat "
            "run gives the same bits")


def cin_library(a, b0, w, bias, nh=None, ps=0):
    """Yardstick only (the port never calls it): the slab path as
    torch.einsum + torch.matmul + relu (+ split and sum)."""
    bsz, h, d = a.shape
    z = torch.einsum("bhd,bfd->bhfd", a, b0).reshape(bsz, -1, d)
    o = torch.relu(torch.matmul(w.T, z) + bias[:, None])
    return o if nh is None else (o[:, :nh], o[:, ps:].sum(dim=2))


def cin_bound(layers):
    """(bound ms, bound_by) of the CIN layers (b, h, f, d, l, nh, lp): f32
    FMAs over the card's f32 rate against each input read and each output
    written once."""
    flops = sum(2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (b * h * d + b * f * d + h * f * l + l + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations"), t_ops, t_bytes


def cin_timing():
    """Per layer and per 3-layer forward at the serving shapes (B = 8192,
    D = 10), f32: kernel, plain and library ms beside the bound, with the
    kernel's largest difference from the plain version (tolerance CIN_TOL)."""
    f = 7
    modes = []  # (h, l, nh, pool_all) of the three layers
    h = f
    for i, size in enumerate(CIN_SIZES):
        last = i == len(CIN_SIZES) - 1
        modes.append((h, size, 0 if last else size // 2, last))
        h = size // 2
    sets = []
    for r in range(2):
        b0 = cin_inputs(CTR_B, f, f, CTR_D, 1, SEED + 500 + r, False)[1]
        layers = [cin_inputs(CTR_B, hh, f, CTR_D, ll, SEED + 510 + 10 * r + j, False)
                  for j, (hh, ll, _, _) in enumerate(modes)]
        sets.append((b0, layers))

    def forward(pooled_fn, b0, layers):
        hidden, parts = b0, []
        for (_, _, nh, pool_all), (_, _, w, bias) in zip(modes, layers):
            hidden, p = pooled_fn(hidden, b0, w, bias, n_hidden=nh, pool_all=pool_all)
            parts.append(p)
        return parts

    def library_pooled(a, b0, w, bias, n_hidden, pool_all):
        return cin_library(a, b0, w, bias, n_hidden, 0 if pool_all else n_hidden)

    out = {}
    err = 0.0
    for j, (hh, ll, nh, pool_all) in enumerate(modes):
        inputs = [(layers[j][0], b0, layers[j][2], layers[j][3]) for b0, layers in sets]
        got, want = cin_pair(inputs[0], nh, pool_all, "float32")
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(got, want)])
        kw = dict(n_hidden=nh, pool_all=pool_all)
        ms = time_ms(lambda *x: cin_layer_pooled(*x, **kw), inputs, 30)
        b2b_ms = back_to_back_ms(lambda *x: cin_layer_pooled(*x, **kw), inputs)
        plain_ms = time_ms(lambda *x: cin_layer_pooled_plain(*x, **kw), inputs, 10)
        lib_ms = time_ms(lambda *x: library_pooled(*x, **kw), inputs, 30)
        bound, by, t_ops, t_bytes = cin_bound(
            [(CTR_B, hh, f, CTR_D, ll, nh, ll - (0 if pool_all else nh))])
        log(f"cin timing layer {j}: B={CTR_B} H={hh} F={f} D={CTR_D} L={ll} "
            f"n_hidden={nh}: kernel_ms={ms:.4f} (back to back {b2b_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}; "
            f"ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    require(err <= CIN_TOL, f"cin serving layers: max |kernel - plain| {err}")

    fwd = [(b0, layers) for b0, layers in sets]
    layer_shapes = [(CTR_B, hh, f, CTR_D, ll, nh, ll - (0 if pa else nh))
                    for hh, ll, nh, pa in modes]
    bound, by, t_ops, t_bytes = cin_bound(layer_shapes)
    out["cin_layer_pooled"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda *x: forward(cin_layer_pooled, *x), fwd, 30),
        "plain_ms": time_ms(lambda *x: forward(cin_layer_pooled_plain, *x), fwd, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda *x: forward(library_pooled, *x), fwd, 30),
        "ms_back_to_back": back_to_back_ms(lambda *x: forward(cin_layer_pooled, *x), fwd),
    }
    out["cin_layer_pooled"]["ms_per_launch"] = out["cin_layer_pooled"]["ms"] / len(modes)
    log("cin timing 3-layer forward (3 launches): " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_pooled"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")

    # kernel 2 (`cin_layer`) at the widest serving layer
    hh, ll = modes[1][0], modes[1][1]
    inputs = [(layers[1][0], b0, layers[1][2], layers[1][3]) for b0, layers in sets]
    got, want = cin_pair(inputs[0], None, False, "float32")
    e2 = float((got[0] - want[0]).abs().max())
    require(e2 <= CIN_TOL, f"cin_layer: max |kernel - plain| {e2}")
    bound, by, t_ops, t_bytes = cin_bound([(CTR_B, hh, f, CTR_D, ll, ll, 0)])
    out["cin_layer"] = {
        "max_abs_err": e2,
        "ms": time_ms(cin_layer, inputs, 30),
        "plain_ms": time_ms(cin_layer_plain, inputs, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(cin_library, inputs, 30),
        "ms_back_to_back": back_to_back_ms(cin_layer, inputs),
    }
    out["cin_layer"]["ms_per_launch"] = out["cin_layer"]["ms"]
    log(f"cin_layer timing B={CTR_B} H={hh} F={f} D={CTR_D} L={ll}: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    return out


# --------------------------------------------------- CIN backward kernel


def cin_pre_f64(a, b0, w, bias, mxu):
    """The pre-activation (B, L, D) in f64 from the operands as the kernel
    rounds them: where a gradient may be masked."""
    bsz, h, d = a.shape
    a, b0, w = a.double(), b0.double(), w.double()
    if mxu == "bfloat16":
        r = lambda x: x.float().to(torch.bfloat16).double()  # noqa: E731
        a, b0, w = r(a), r(b0), r(w)
        z = r(a[:, :, None, :] * b0[:, None, :, :])
    else:
        z = a[:, :, None, :] * b0[:, None, :, :]
    z = z.reshape(bsz, -1, d)
    return torch.einsum("bkd,kl->bld", z, w) + bias.double()[None, :, None]


def cin_grads(inputs, nh, ps, seed, exact, mxu):
    """(gh, gp) for one layer: gh (B, nh, D) or None, gp (B, L - ps) or None.
    `exact`: integers in -3..3, so every sum of the backward is exact.
    Otherwise normal values, zeroed where |pre| < CIN_MASK_BAND."""
    a, _, w, _ = inputs
    b, _, d = a.shape
    l = w.shape[1]
    rng = np.random.default_rng(seed)
    if exact:
        gh, gp = rng.integers(-3, 4, (b, nh, d)), rng.integers(-3, 4, (b, l - ps))
    else:
        gh, gp = rng.standard_normal((b, nh, d)), rng.standard_normal((b, l - ps))
        near = (cin_pre_f64(*inputs, mxu).abs() < CIN_MASK_BAND).cpu().numpy()
        gh[near[:, :nh]] = 0
        gp[near[:, ps:].any(axis=2)] = 0
    dev = lambda x: torch.from_numpy(x.astype(np.float32)).to(DEVICE)  # noqa: E731
    return (dev(gh) if nh else None), (dev(gp) if l > ps else None)


def cin_bwd_err(got, want):
    """Largest |kernel - plain| of the four gradients, each relative to
    max(1, the plain gradient's largest magnitude)."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def cin_bwd_pair(inputs, grads, nh, pool_all, mxu):
    """(kernel gradients, plain gradients) of one layer; nh None is
    `cin_layer`, whose gradient is gh alone."""
    gh, gp = grads
    if nh is None:
        got = cin_layer_bwd(*inputs, gh, mxu_dtype=mxu)
        sync()
        return got, cin_layer_bwd_plain(*inputs, gh, mxu_dtype=mxu)
    kw = dict(mxu_dtype=mxu, n_hidden=nh, pool_all=pool_all)
    got = cin_layer_pooled_bwd(*inputs, gh, gp, **kw)
    sync()
    return got, cin_layer_pooled_bwd_plain(*inputs, gh, gp, **kw)


def cin_bwd_cases():
    """The CIN backward kernel against its plain version on the card: bit
    for bit on integer inputs and gradients, to CIN_TOL on random ones, in
    both precision modes, at every case of the forward."""
    for i, (name, b, h, f, d, l, nh, pool_all) in enumerate(CIN_CASES):
        ps = l if nh is None else (0 if pool_all else nh)
        n_hidden = l if nh is None else nh
        errs = {}
        for mxu in ("float32", "bfloat16"):
            inputs = cin_inputs(b, h, f, d, l, SEED + 300 + i, True)
            grads = cin_grads(inputs, n_hidden, ps, SEED + 600 + i, True, mxu)
            got, want = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            require(all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
                    f"cin bwd {name} {mxu}: kernel differs from the plain version on exact inputs")
            inputs = cin_inputs(b, h, f, d, l, SEED + 400 + i, False)
            grads = cin_grads(inputs, n_hidden, ps, SEED + 700 + i, False, mxu)
            got, want = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            errs[mxu] = cin_bwd_err(got, want)
            require(errs[mxu] <= CIN_TOL, f"cin bwd {name} {mxu}: relative error {errs[mxu]}")
            again, _ = cin_bwd_pair(inputs, grads, nh, pool_all, mxu)
            require(all(torch.equal(x, y) for x, y in zip(got, again)),
                    f"cin bwd {name} {mxu}: a repeat run gave other bits")
        cols, spans = bwd_plan(b, h, f, d, l)
        log(f"cin bwd check {name}: B={b} H={h} F={f} D={d} L={l} n_hidden={nh} "
            f"pool_all={pool_all} ({len(cols)} column group(s) x {len(spans)} D span(s)): "
            f"exact (f32, bf16); random error "
            f"f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; a repeat run "
            "gives the same bits")


def cin_bwd_bound(layers):
    """(bound ms, bound_by, ops ms, bytes ms) of CIN backward layers (b, h,
    f, d, l, nh, lp): three f32 products (pre, dW, dz) against each input
    (a, b0, w, bias, gh, gp) read and each output (da, db0, dw, dbias)
    written once."""
    flops = sum(3 * 2 * b * d * h * f * l for b, h, f, d, l, nh, lp in layers)
    nbytes = sum(4 * (2 * (b * h * d + b * f * d + h * f * l + l) + b * nh * d + b * lp)
                 for b, h, f, d, l, nh, lp in layers)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations"), t_ops, t_bytes


def autograd_yardstick(inputs, nh, ps, grads):
    """Yardstick only (the port never calls it): a closure that runs
    autograd's backward through the einsum + matmul slab path."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = cin_library(*leaves, nh, ps)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.numel()]

    def run():
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs], retain_graph=True)

    return run


def cin_bwd_timing():
    """The backward per layer and for the 3-layer stack at the training
    shapes (B = 8192, D = 10), f32: kernel, plain and library ms beside the
    bound, with the kernel's largest relative error against the plain
    version (tolerance CIN_TOL)."""
    f = 7
    modes = []
    h = f
    for i, size in enumerate(CIN_SIZES):
        last = i == len(CIN_SIZES) - 1
        nh, pool_all = (0, True) if last else (size // 2, False)
        modes.append((h, size, nh, pool_all))
        h = size // 2
    sets = []  # per input set: per layer (inputs, grads)
    for r in range(2):
        b0 = cin_inputs(CTR_B, f, f, CTR_D, 1, SEED + 800 + r, False)[1]
        layers = []
        for j, (hh, ll, nh, pool_all) in enumerate(modes):
            a, _, w, bias = cin_inputs(CTR_B, hh, f, CTR_D, ll, SEED + 810 + 10 * r + j, False)
            inputs = (a, b0, w, bias)
            ps = 0 if pool_all else nh
            layers.append((inputs, cin_grads(inputs, nh, ps, SEED + 900 + 10 * r + j,
                                             False, "float32")))
        sets.append(layers)

    out = {}
    err = 0.0
    shapes = []
    for j, (hh, ll, nh, pool_all) in enumerate(modes):
        ps = 0 if pool_all else nh
        kw = dict(n_hidden=nh, pool_all=pool_all)
        calls = [layers[j] for layers in sets]
        got, want = cin_bwd_pair(*calls[0], nh, pool_all, "float32")
        err = max(err, cin_bwd_err(got, want))
        ms = time_ms(lambda x, g: cin_layer_pooled_bwd(*x, *g, **kw), calls, 30)
        plain_ms = time_ms(lambda x, g: cin_layer_pooled_bwd_plain(*x, *g, **kw), calls, 10)
        yard = [(autograd_yardstick(x, nh, ps, (g[0], g[1])),) for x, g in calls]
        lib_ms = time_ms(lambda run: run(), yard, 30)
        shape = (CTR_B, hh, f, CTR_D, ll, nh, ll - ps)
        shapes.append(shape)
        bound, by, t_ops, t_bytes = cin_bwd_bound([shape])
        log(f"cin bwd timing layer {j}: B={CTR_B} H={hh} F={f} D={CTR_D} L={ll} "
            f"n_hidden={nh}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by}; ops {t_ops:.4f}, "
            f"bytes {t_bytes:.4f})")
        del yard
    require(err <= CIN_TOL, f"cin bwd training layers: relative error {err}")

    def stack(fn, *layers):
        return [fn(*x, *g, n_hidden=nh, pool_all=pa)
                for (x, g), (_, _, nh, pa) in zip(layers, modes)]

    def stack_library(*runs):
        return [run() for run in runs]

    yard = [tuple(autograd_yardstick(x, nh, 0 if pa else nh, g)
                  for (x, g), (_, _, nh, pa) in zip(layers, modes)) for layers in sets]
    bound, by, t_ops, t_bytes = cin_bwd_bound(shapes)
    out["cin_layer_pooled_bwd"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda *ls: stack(cin_layer_pooled_bwd, *ls), sets, 30),
        "plain_ms": time_ms(lambda *ls: stack(cin_layer_pooled_bwd_plain, *ls), sets, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(stack_library, yard, 30),
    }
    out["cin_layer_pooled_bwd"]["ms_per_launch"] = out["cin_layer_pooled_bwd"]["ms"] / len(modes)
    del yard
    log("cin bwd timing 3-layer backward (3 calls): " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_pooled_bwd"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")

    # kernel 3 (`cin_layer_bwd`) at the widest layer: every row hidden
    hh, ll = modes[1][0], modes[1][1]
    calls = []
    for r, layers in enumerate(sets):
        inputs = layers[1][0]
        calls.append((inputs, cin_grads(inputs, ll, ll, SEED + 950 + r, False, "float32")))
    got, want = cin_bwd_pair(*calls[0], None, False, "float32")
    e3 = cin_bwd_err(got, want)
    require(e3 <= CIN_TOL, f"cin_layer_bwd: relative error {e3}")
    yard = [(autograd_yardstick(x, None, 0, g),) for x, g in calls]
    bound, by, t_ops, t_bytes = cin_bwd_bound([(CTR_B, hh, f, CTR_D, ll, ll, 0)])
    out["cin_layer_bwd"] = {
        "max_abs_err": e3,
        "ms": time_ms(lambda x, g: cin_layer_bwd(*x, g[0]), calls, 30),
        "plain_ms": time_ms(lambda x, g: cin_layer_bwd_plain(*x, g[0]), calls, 10),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda run: run(), yard, 30),
    }
    out["cin_layer_bwd"]["ms_per_launch"] = out["cin_layer_bwd"]["ms"]
    del yard
    log(f"cin_layer_bwd timing B={CTR_B} H={hh} F={f} D={CTR_D} L={ll}: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out["cin_layer_bwd"].items()) + f" (ops {t_ops:.4f}, bytes {t_bytes:.4f})")
    return out


# ---------------------------------------------------------- ranking serving


def ctr_fields():
    return FieldSpec(
        token_names=("user_id", "item_id", "gender", "category", "hour"),
        token_dims=(N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, 3, 64, 25),
        float_names=("age", "price"),
        float_dims=(2, 2),
        user_token_idx=(0, 2),
        item_token_idx=(1, 3),
    )


def build_ranking_model(seed=SEED + 1, cin_sizes=CIN_SIZES, device=None):
    device = device or DEVICE
    spec = InductiveSpec(
        mapper="random", add_oov_buckets=True,
        n_user_buckets=100, n_item_buckets=100, hash_function="3round",
    )
    return xDeepFM(
        ctr_fields(), embedding_size=CTR_D, spec=spec, mlp_hidden_size=MLP_SIZES,
        dropout_prob=0.2, direct=False, cin_layer_size=cin_sizes,
        device=device, generator=torch_generator(seed, device),
    )


@torch.no_grad()
def synth_ctr(model, mapper, cfg):
    """Seeded users (age, gender) and items (category, price), 10 % of
    each new, and CTR_B * CTR_BATCHES rows with an hour. Labels come from
    the model's own logits (standardised) plus unit normal noise, so AUC
    sits well away from 0.5 and every slice holds both labels."""
    rng = np.random.default_rng(SEED + 2)
    n_u = N_CTR_OLD_USERS + N_CTR_NEW_USERS
    n_i = N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    user_feat = {
        "user_id": np.arange(n_u), "gender": rng.integers(1, 3, n_u),
        "age": rng.random(n_u).astype(np.float32), "age__bucket": np.ones(n_u, np.int64),
    }
    item_feat = {
        "item_id": np.arange(n_i), "category": rng.integers(1, 64, n_i),
        "price": rng.random(n_i).astype(np.float32), "price__bucket": np.ones(n_i, np.int64),
    }
    n = CTR_B * CTR_BATCHES
    inter = {
        "user_id": rng.integers(1, n_u, n), "item_id": rng.integers(1, n_i, n),
        "hour": rng.integers(0, 25, n),
    }
    split = DatasetSplit(inter, n_u, n_i, user_feat=user_feat, item_feat=item_feat)
    model.eval()
    fused, model.fused_cin = model.fused_cin, False
    logits = []
    for batch in PlainEvalBatcher(split, cfg):
        batch = mapper.annotate(batch, "user_id", "item_id")
        logits.append(model(to_device_batch(batch, DEVICE)).float().cpu().numpy())
    model.fused_cin = fused
    logit = np.concatenate(logits)[:n]
    z = (logit - logit.mean()) / logit.std() + rng.standard_normal(n)
    inter["label"] = (z > 0).astype(np.float32)
    ind = DatasetSplit(inter, n_u, n_i, user_feat=user_feat, item_feat=item_feat)
    iv_rows = (inter["user_id"] < N_CTR_OLD_USERS) & (inter["item_id"] < N_CTR_OLD_ITEMS)
    iv = DatasetSplit({k: v[iv_rows] for k, v in inter.items()},
                      N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, user_feat=user_feat, item_feat=item_feat)
    return ind, iv


def ranking():
    """xDeepFM value eval and 7 value slices, CIN kernel vs plain slab path.
    Returns the launch counts of the fused 7-slice run, the labelled rows
    and the mapper."""
    model = build_ranking_model()
    mapper = RandomOOVMapper(
        model.spec, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS,
        N_CTR_OLD_USERS + N_CTR_NEW_USERS, N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS,
    )
    mapper.set_eval()
    cfg = Config({"metrics": ["AUC", "LogLoss"], "seed": SEED,
                  "eval_batch_size": CTR_B, "metric_decimal_place": 12})
    set_policy(cfg["compute_dtype"])  # the default, f32
    t0 = time.perf_counter()
    ind, iv = synth_ctr(model, mapper, cfg)
    labels = ind.inter["label"]
    log(f"ranking data: {len(ind)} rows ({len(iv)} IV), positives {labels.mean():.4f}, "
        f"{time.perf_counter() - t0:.1f} s")

    def counted(what, run, loader):
        cin_layer_pooled.launches = cin_layer.launches = 0
        sync()
        t0 = time.perf_counter()
        result = run(loader)
        sync()
        wall = time.perf_counter() - t0
        counts = {"cin_layer_pooled": cin_layer_pooled.launches,
                  "cin_layer": cin_layer.launches}
        log(f"{what}: {len(loader)} batches of {CTR_B}, "
            f"{wall / len(loader) * 1e3:.1f} ms per batch (wall, host included), "
            f"kernel launches {counts}")
        return result, counts

    runs = {}
    n_layers = len(CIN_SIZES)
    for fused in (True, False):
        model.fused_cin = cfg["fused_cin"] if fused else False  # default "auto"
        tag = "fused" if fused else "plain"
        iv_loader = PlainEvalBatcher(iv, cfg)
        res_iv, c_iv = counted(f"value eval {tag}", EvalRunner(model, cfg).evaluate, iv_loader)
        ind_loader = PlainEvalBatcher(ind, cfg)
        ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
        res_ind, c_ind = counted(f"7-slice value eval {tag}", ev.evaluate_model, ind_loader)
        want = (n_layers if fused else 0)
        require(c_iv["cin_layer_pooled"] == want * len(iv_loader),
                f"value eval {tag}: CIN launches {c_iv}")
        require(c_ind["cin_layer_pooled"] == want * len(ind_loader),
                f"7-slice value eval {tag}: CIN launches {c_ind}")
        runs[fused] = (res_iv, res_ind, c_ind)
    log(f"[value eval] {dict(runs[True][0])}")
    for s, r in runs[True][1].items():
        log(f"[{s}] {dict(r)}")
    agree(runs[True][0], runs[False][0], "value eval fused vs plain", tol=1e-6)
    agree(runs[True][1], runs[False][1], "7-slice value eval fused vs plain", tol=1e-6)
    for s, r in runs[True][1].items():
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"slice {s}: {dict(r)}")
    require(runs[True][0]["auc"] > 0.6, f"value eval AUC {runs[True][0]['auc']}")
    log("ranking eval: fused == plain on AUC, LogLoss and all 7 slices (1e-6)")

    model.fused_cin = cfg["fused_cin"]
    breakdown(InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper),
              PlainEvalBatcher(ind, cfg), what="fused 7-slice value eval (xDeepFM)",
              shares=(("CIN forward kernel", ("cin_fused_kernel",)),))
    return runs[True][2], ind, mapper


# --------------------------------------------------------- ranking training


def ctr_train_cfg(**over):
    return Config(ctr_train_dict(**over))


def ctr_train_dict(**over):
    d = {
        "metrics": ["AUC", "LogLoss"], "valid_metric": "AUC", "seed": SEED,
        "eval_batch_size": CTR_B, "metric_decimal_place": 12,
        "train_batch_size": CTR_B, "learner": "adam", "learning_rate": 1e-3,
        "epochs": 1, "train_neg_sample_args": {"distribution": "none"},
        "train_oov": True, "oov_only_epoch": True, "oov_train_ratio": 0.2,
        "oov_feature_mask_rate": 0.2, "oov_freeze_embedding": True,
        # the host per-batch path (phases 5 and E3 measure it): `auto` would
        # take the plain device epoch at these 700,000+ rows
        "device_epoch": False, "host_scan_steps": 1,
    }
    d.update(over)
    return d


def rows_of(split, keep, n_users, n_items):
    return DatasetSplit({k: v[keep] for k, v in split.inter.items()}, n_users, n_items,
                        user_feat=split.user_feat, item_feat=split.item_feat)


def ctr_splits(ind):
    """→ (the IV rows of the first CTR_TRAIN_FRACTION of the labelled rows,
    the rest, the IV rows of the rest)."""
    n = len(ind)
    cut = int(CTR_TRAIN_FRACTION * n)
    row = np.arange(n)
    old = ((ind.inter["user_id"] < N_CTR_OLD_USERS)
           & (ind.inter["item_id"] < N_CTR_OLD_ITEMS))
    n_u, n_i = N_CTR_OLD_USERS + N_CTR_NEW_USERS, N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    return (rows_of(ind, (row < cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS),
            rows_of(ind, row >= cut, n_u, n_i),
            rows_of(ind, (row >= cut) & old, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS))


def ranking_training(ind, mapper):
    """xDeepFM through `Trainer.fit` on the card: one epoch over the IV rows
    of the first CTR_TRAIN_FRACTION of the rows plus the frozen OOV-only
    sub-epoch, from a seed other than the labels' model. → the CIN launch
    counts of the fit."""
    train, held, held_iv = ctr_splits(ind)
    cfg = ctr_train_cfg()
    model = build_ranking_model(SEED + 7)
    auc0 = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]

    trainer = eager_steps(Trainer(cfg, model))
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    require(loader.mode == "plain" and len(loader) > 1, f"train loader {loader.mode}")
    iv_names = [n for n in trainer.params if n not in trainer.oov_params]
    require(len(trainer.oov_params) == 4, f"OOV parameters {sorted(trainer.oov_params)}")
    inner, seen = trainer._train_epoch, {}

    def watched(loader, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        steps = trainer._global_step
        total = inner(loader, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["frozen" if frozen else "normal"] = {
            "losses": trainer.last_losses, "steps": trainer._global_step - steps,
            "moved": {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])},
        }
        return total

    trainer._train_epoch = watched
    cin_layer_pooled.launches = cin_layer_pooled_bwd.launches = 0
    cin_layer.launches = cin_layer_bwd.launches = 0
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    counts = {"cin_layer_pooled": cin_layer_pooled.launches,
              "cin_layer_pooled_bwd": cin_layer_pooled_bwd.launches,
              "cin_layer": cin_layer.launches, "cin_layer_bwd": cin_layer_bwd.launches}
    steps = trainer._global_step
    normal, frozen = seen["normal"], seen["frozen"]
    n_layers = len(CIN_SIZES)
    log(f"ranking training: {len(train)} rows, {normal['steps']} steps + {frozen['steps']} "
        f"frozen OOV steps of {CTR_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), "
        f"kernel launches {counts}")
    require(counts["cin_layer_pooled"] == n_layers * steps
            and counts["cin_layer_pooled_bwd"] == n_layers * steps,
            f"CIN launches {counts} over {steps} steps")
    require(normal["steps"] == len(loader) and frozen["steps"] > 0, "training steps")
    require(not frozen["moved"] & set(iv_names),
            f"the frozen sub-epoch moved IV tables {sorted(frozen['moved'] & set(iv_names))}")
    require(frozen["moved"] == trainer.oov_params,
            f"the frozen sub-epoch moved {sorted(frozen['moved'])}")
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(frozen["losses"]).all(), "loss not finite")
    require(last < first, f"loss did not fall: first tenth {first}, last tenth {last}")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"ranking training: loss first tenth {first:.5f} last tenth {last:.5f}, "
        f"frozen OOV loss {float(frozen['losses'].mean()):.5f}; held-out IV AUC "
        f"{auc0:.5f} before, {auc1:.5f} after; IV tables bitwise unchanged by the "
        f"frozen sub-epoch, bucket tables moved")
    require(auc1 > auc0, f"held-out AUC {auc0} before, {auc1} after")
    ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
    slices = ev.evaluate_model(PlainEvalBatcher(held, cfg))
    for s, r in slices.items():
        log(f"[trained {s}] {dict(r)}")
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"trained slice {s}: {dict(r)}")

    # where a training step's time goes, after the counted run
    profile_loader = TrainBatcher(rows_of(train, np.arange(len(train)) < 8 * CTR_B,
                                          N_CTR_OLD_USERS, N_CTR_OLD_ITEMS),
                                  None, cfg, InputType.POINTWISE)
    inner(profile_loader, 1)
    sync()
    wall_ms, _ = profiled(
        lambda: inner(profile_loader, 2),
        f"profile {len(profile_loader)} fused xDeepFM training steps",
        shares=(("CIN forward kernel", ("cin_fused_kernel",)),
                ("CIN backward kernels", ("cin_bwd_",)),
                ("  launch 1, rows (pre, dpre, dz, dA, dB0)", ("cin_bwd_rows_kernel",)),
                ("  launch 2, dW / dbias partials", ("cin_bwd_dw_kernel",)),
                ("  launch 3, partial sums", ("cin_bwd_reduce_kernel",))))
    log(f"ranking training profile: {wall_ms / len(profile_loader):.2f} ms per step "
        "under the profiler")
    # the same steps with the gathers' backward on torch's indexing route
    # (the port's before this kernel), for the share it took
    with backward_route("index"):
        inner(profile_loader, 3)
        sync()
        _, busy = profiled(lambda: inner(profile_loader, 4),
                           f"profile {len(profile_loader)} xDeepFM training steps, the "
                           "gathers' backward on the index route", quiet=True)
    log(f"ranking training profile, index route: {busy / len(profile_loader):.3f} ms of "
        f"device time a step, the gathers' backward "
        f"{profiled.gathers_ms / len(profile_loader):.3f} ms")
    kernel_vs_plain_training(train)
    wide_cin_training(train)
    return counts


def wide_cin_training(train):
    """xDeepFM at cin_layer_size WIDE_CIN_SIZES through `fused_cin: auto`:
    WIDE_STEPS training steps on the CIN kernels against the same steps on
    the slab path (`kernel_vs_plain_training`), each backward in two column
    groups (ops/cin_fused.py:bwd_plan); the backward kernel against its
    plain version at each trained layer's shape on one batch; then one
    batch served through the forward kernel (two column passes), equal to
    the slab path to CIN_TOL."""
    model, counts, wall, wall_plain, part, cfg, _ = kernel_vs_plain_training(
        train, WIDE_STEPS, WIDE_CIN_SIZES, SEED + 9)
    shapes = model.cin_layer_shapes(CTR_B)
    launches_bwd = sum(len(c) * len(s) for c, s in (bwd_plan(*x) for x in shapes))
    launches_fwd = sum(len(fwd_plan(*x)) for x in shapes)
    log(f"wide CIN training (cin_layer_size {WIDE_CIN_SIZES}, fused_cin auto): {WIDE_STEPS} "
        f"steps of {CTR_B} rows, {wall / WIDE_STEPS * 1e3:.2f} ms per step (wall, host "
        f"included; the slab path {wall_plain / WIDE_STEPS * 1e3:.2f}), kernel launches {counts}")
    require(counts["cin_layer_pooled"] == WIDE_STEPS * launches_fwd
            and counts["cin_layer_pooled_bwd"] == WIDE_STEPS * launches_bwd,
            f"wide CIN training launches {counts}, want {launches_fwd} forward and "
            f"{launches_bwd} backward a step")

    db = to_device_batch(next(iter(PlainEvalBatcher(part, cfg))), DEVICE)
    model.eval()
    with torch.no_grad():
        b0 = model.concat_embed_input_fields(db).float().contiguous()
        hidden, err = b0, 0.0
        for i, (conv, (nh, pool_all)) in enumerate(zip(model.conv1d_list, model._layer_modes())):
            inputs = (hidden, b0, conv.kernel.detach(), conv.bias.detach())
            grads = cin_grads(inputs, nh, 0 if pool_all else nh, SEED + 990 + i, False,
                              "float32")
            err = max(err, cin_bwd_err(*cin_bwd_pair(inputs, grads, nh, pool_all, "float32")))
            hidden, _ = cin_layer_pooled(*inputs, n_hidden=nh, pool_all=pool_all)
        log(f"wide CIN backward kernel vs plain at the trained layers' shapes {shapes}: "
            f"relative error {err:.3e}")
        require(err <= CIN_TOL, f"wide CIN backward: relative error {err}")
        cin_layer_pooled.launches = 0
        got = model.predict(db)
        launches = cin_layer_pooled.launches
        model.fused_cin = False
        want = model.predict(db)
        model.fused_cin = "auto"
    err = float((got - want).abs().max())
    log(f"wide CIN serving through auto: {launches} forward kernel launches for one batch of "
        f"{CTR_B}; max |kernel - slab| {err:.3e} on the predicted probabilities")
    require(launches == launches_fwd, f"wide CIN serving launches {launches}")
    require(err <= CIN_TOL, f"wide CIN serving: max |kernel - slab| {err}")


def kernel_vs_plain_training(train, steps=None, cin_sizes=CIN_SIZES, seed=SEED + 7, **over):
    """`steps` (default COMPARE_STEPS) training steps of xDeepFM at
    `cin_sizes` on the CIN kernel path and on the plain slab path from
    identical weights and dropout generators: per-step losses to LOSS_RTOL
    relative, parameters to PARAM_ATOL absolute. Returns the kernel path's
    model, CIN launch counts and wall seconds, the plain path's wall
    seconds, the rows, the config and the kernel path's losses.

    Adam scales each element's step by that element's own gradient history,
    so an element whose gradient at some step is decided by more than
    summation rounding (a ReLU mask at a pre-activation within rounding of
    0, or a gradient that cancels to within rounding of 0) can move by a
    fraction of lr on one path and not the other. Such elements are held
    apart: each one beyond PARAM_ATOL is printed with both values and the
    step at which its gradient differed between the paths by more than
    EXPLAINED_GRAD_RTOL relative; any element beyond PARAM_ATOL without
    such a step, or more than MAX_EXPLAINED_FRACTION of all elements, fails
    the phase."""
    steps = steps or COMPARE_STEPS
    part = rows_of(train, np.arange(len(train)) < steps * CTR_B,
                   N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    cfg = ctr_train_cfg(train_oov=False, **over)
    runs = {}
    for fused in (True, False):
        model = build_ranking_model(seed, cin_sizes)
        require(model.fused_cin == "auto", f"fused_cin {model.fused_cin}")
        model.fused_cin = cfg["fused_cin"] if fused else False
        trainer = eager_steps(Trainer(cfg, model))
        grads, step = [], trainer.optimizer.step

        def recording(params, g, state, trainable=None, grads=grads, step=step, **kw):
            grads.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable, **kw)

        trainer.optimizer.step = recording
        cin_layer_pooled.launches = cin_layer_pooled_bwd.launches = 0
        cin_layer.launches = cin_layer_bwd.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer._train_epoch(TrainBatcher(part, None, cfg, InputType.POINTWISE), 0)
        sync()
        wall = time.perf_counter() - t0
        counts = {"cin_layer_pooled": cin_layer_pooled.launches,
                  "cin_layer_pooled_bwd": cin_layer_pooled_bwd.launches,
                  "cin_layer": cin_layer.launches, "cin_layer_bwd": cin_layer_bwd.launches}
        require((counts["cin_layer_pooled_bwd"] > 0) is fused, f"CIN backward path {counts}")
        require(fused or not any(counts.values()), f"the slab path launched {counts}")
        runs[fused] = (trainer.last_losses,
                       {n: p.detach() for n, p in model.named_parameters()}, grads,
                       (model, counts, wall))
    (lk, pk, gk, fused_run), (lp, pp, gp, plain_run) = runs[True], runs[False]
    require(len(lk) == len(lp) == steps, f"steps {len(lk)}, {len(lp)}")
    what = ("kernel vs plain training" if cin_sizes == CIN_SIZES
            else f"kernel vs plain training (cin_layer_size {cin_sizes})")
    if over:
        what += f" {over}"
    compare_trajectories(
        what, ("kernel", "plain"), lk, lp, pk, pp,
        lambda n, i: torch.stack([g[n].flatten()[i] for g in gk]),
        lambda n, i: torch.stack([g[n].flatten()[i] for g in gp]))
    return fused_run + (plain_run[2], part, cfg, lk)


def compare_trajectories(what, names, la, lb, pa, pb, grad_a, grad_b):
    """Two COMPARE_STEPS training runs from identical weights: per-step
    losses `la`, `lb` to LOSS_RTOL relative, parameter dicts `pa`, `pb` to
    PARAM_ATOL absolute, each element beyond it explained by a step at which
    its gradient (`grad_a(name, flat index)`, `grad_b`: one value a step)
    differed between the runs by more than EXPLAINED_GRAD_RTOL, and at most
    MAX_EXPLAINED_FRACTION of all elements beyond it."""
    rel = np.abs(la - lb) / np.abs(lb)
    worst = max(((float((pa[n] - pb[n]).abs().max()), n) for n in pa))
    n_elements = sum(p.numel() for p in pa.values())
    beyond = []
    for n in pa:
        idx = torch.nonzero(((pa[n] - pb[n]).abs() > PARAM_ATOL).flatten()).flatten()
        for i in idx.tolist():
            a, b = grad_a(n, i), grad_b(n, i)
            grel = (a - b).abs() / torch.maximum(torch.maximum(a.abs(), b.abs()),
                                                  torch.tensor(1e-30, device=a.device))
            s = int(grel.argmax())
            beyond.append((n, i, float(pa[n].flatten()[i]), float(pb[n].flatten()[i]),
                           s, float(a[s]), float(b[s]), float(grel[s])))
    log(f"{what}, {len(la)} steps: loss max relative "
        f"difference {rel.max():.3e} (step {int(rel.argmax())}), parameters max "
        f"absolute difference {worst[0]:.3e} ({worst[1]}); {len(beyond)} of "
        f"{n_elements} elements beyond {PARAM_ATOL}")
    for n, i, va, vb, s, ga, gb, grel in beyond[:20]:
        log(f"  {n}[{i}]: {names[0]} {va:.6e}, {names[1]} {vb:.6e}; at step {s} its gradient "
            f"was {ga:.6e} ({names[0]}) vs {gb:.6e} ({names[1]}), relative difference "
            f"{grel:.3e}")
    require(rel.max() <= LOSS_RTOL, f"{what}: losses differ: step {int(rel.argmax())}, "
            f"{la[rel.argmax()]} vs {lb[rel.argmax()]}")
    unexplained = [b for b in beyond if b[-1] <= EXPLAINED_GRAD_RTOL]
    require(not unexplained, f"{what}: parameters differ beyond {PARAM_ATOL} where no "
            f"gradient of the element differed by more than rounding: {unexplained[:5]}")
    require(len(beyond) <= MAX_EXPLAINED_FRACTION * n_elements,
            f"{what}: {len(beyond)} elements beyond {PARAM_ATOL}")


# ------------------------------------------------------- retrieval training


def retrieval_training():
    """BPR through `Trainer.fit` at the serving scale, then the 7-slice eval
    on the trained weights, fused vs dense."""
    model = build_model()
    mapper = RandomOOVMapper(
        model.spec, N_OLD_USERS, N_OLD_ITEMS,
        N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS,
    )
    mapper.set_eval()
    rng = np.random.default_rng(SEED + 30)
    n_rows = BPR_TRAIN_STEPS * BPR_TRAIN_B
    train = DatasetSplit({"user_id": rng.integers(1, N_OLD_USERS, n_rows),
                          "item_id": rng.integers(1, N_OLD_ITEMS, n_rows)},
                         N_OLD_USERS, N_OLD_ITEMS)
    t0 = time.perf_counter()
    sampler = Sampler(["train"], [train], seed=SEED)
    cfg = Config({"seed": SEED, "topk": TOPK, "train_batch_size": BPR_TRAIN_B,
                  "learner": "adam", "learning_rate": 1e-3, "epochs": 1,
                  "train_oov": True, "oov_only_epoch": True, "oov_train_ratio": 0.2,
                  "oov_feature_mask_rate": 0.2, "device_epoch": False,
                  "host_scan_steps": 1})
    trainer = eager_steps(Trainer(cfg, model))
    loader = TrainBatcher(train, sampler, cfg, InputType.PAIRWISE)
    require(loader.mode == "pairwise" and len(loader) == BPR_TRAIN_STEPS, "BPR loader")
    require(trainer._maybe_device_epoch(loader) is None, "the host path is not driven")
    log(f"retrieval training data: {n_rows} rows, {time.perf_counter() - t0:.1f} s")
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    steps = trainer._global_step
    moved = {n for n in before if not torch.equal(before[n], trainer.params[n])}
    loss, oov_loss = trainer.train_loss_dict[0], trainer.oov_loss_dict.get(0)
    log(f"retrieval training: {steps} steps ({len(loader)} + {steps - len(loader)} OOV) of "
        f"{BPR_TRAIN_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), "
        f"mean loss {loss / len(loader):.5f}, OOV sub-epoch mean loss "
        f"{(oov_loss or float('nan')) / max(1, steps - len(loader)):.5f}")
    require(steps > BPR_TRAIN_STEPS and math.isfinite(loss) and oov_loss is not None
            and math.isfinite(oov_loss), "retrieval training")
    require({"user_embedding.weight", "item_embedding.weight"} <= moved
            and moved & trainer.oov_params, f"parameters that moved: {sorted(moved)}")
    ind_splits, _ = synth_interactions(model, mapper)
    seven_slices_fused_vs_dense(model, mapper, ind_splits, serving_cfg,
                                what="trained BPR inductive eval")


# ------------------------------------------------------------- kernel 6


def sparse_rows_inputs(v, d, n, seed, dup_runs=False, zero_ids=0, edges=False,
                       ids_dtype=torch.int64):
    """Tables (p, mu, nu) of (v, d) with moments as a trained table holds
    them, and one step's coalesced (sorted ids, row gradients) of n rows on
    the card. `dup_runs`: half the ids from v // 50 rows (long runs);
    `zero_ids`: that many distinct ids get all-zero coalesced rows; `edges`:
    the first and last table rows."""
    rng = np.random.default_rng(seed)
    dev = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)  # noqa: E731
    tables = (dev(rng.standard_normal((v, d))), dev(rng.standard_normal((v, d)) * 0.01),
              dev(rng.random((v, d)) * 1e-3))
    return tables, sparse_rows_step(rng, v, d, n, dup_runs, zero_ids, edges, ids_dtype)


def sparse_rows_step(rng, v, d, n, dup_runs=False, zero_ids=0, edges=False,
                     ids_dtype=torch.int64):
    ids = rng.integers(0, v, n)
    if dup_runs:
        ids[: n // 2] = rng.integers(0, max(1, v // 50), n // 2)
    if edges:
        ids[0], ids[-1] = 0, v - 1
    rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(DEVICE)
    sid, g = coalesce_rows(torch.from_numpy(ids).to(DEVICE), rows)
    if zero_ids:
        zero = torch.from_numpy(rng.choice(np.unique(ids), zero_ids, replace=False)).to(DEVICE)
        g[torch.isin(sid, zero)] = 0.0
    return sid.to(ids_dtype), g


# name, V, D, n, options
SPARSE_ROWS_CASES = [
    ("random", SP_USERS, D, SP_B, {}),
    ("dup-runs", SP_ITEMS, D, 2 * SP_B, dict(dup_runs=True)),
    ("zero-rows", 1000, D, 700, dict(zero_ids=50)),
    ("edges", 5000, D, 333, dict(edges=True)),
    ("n1", 10, D, 1, {}),
    ("D10", 3000, 10, 999, dict(dup_runs=True, zero_ids=5, edges=True)),
    ("odd-D13", 777, 13, 500, dict(dup_runs=True, zero_ids=5, edges=True)),
    ("int32-ids", SP_USERS, D, SP_B, dict(ids_dtype=torch.int32, edges=True)),
    # CLI phase C's item table (90,001 rows) and a step's item rows
    # (2,048 positives + 2,048 negatives)
    ("cli-c-items", 90_001, D, 4096, dict(dup_runs=True)),
    # E4's DirectAU tables on the host path: a pointwise step's 2,048 ids a
    # side into 100,000 users and 900,000 items
    ("directau-users", N_OLD_USERS, D, 2048, {}),
    ("directau-items", N_OLD_ITEMS, D, 2048, {}),
]


def sparse_rows_cases():
    """Kernel 6 against its plain version on the card, bit for bit, over two
    consecutive steps of each case; rows with an all-zero gradient and rows
    not in the step keep their bits."""
    for i, (name, v, d, n, opt) in enumerate(SPARSE_ROWS_CASES):
        tables, step = sparse_rows_inputs(v, d, n, SEED + 1000 + i, **opt)
        rng = np.random.default_rng(SEED + 1100 + i)
        k = [t.clone() for t in tables]
        p = [t.clone() for t in tables]
        for count in (7, 8):
            sid, g = step
            sparse_adam_rows_kernel(*k, sid, g, count, SP_LR)
            sync()
            sparse_adam_rows_plain(*p, sid, g, count, SP_LR)
            require(all(torch.equal(a, b) for a, b in zip(k, p)),
                    f"kernel 6 {name} step {count}: differs from the plain version")
            still = torch.ones(v, dtype=torch.bool, device=DEVICE)
            still[sid.long()[(g != 0).any(dim=1)]] = False
            require(all(torch.equal(a[still], t[still]) for a, t in zip(k, tables)),
                    f"kernel 6 {name}: an untouched row changed")
            tables = [t.clone() for t in k]
            step = sparse_rows_step(rng, v, d, n, **opt)
        log(f"kernel 6 check {name}: V={v} D={d} n={n} {opt}: exact over 2 steps")


def sparse_rows_timing():
    """Kernel 6 at the sparse training step's shapes (8,192 user ids into
    200,000 x 64, 16,384 item ids into 100,000 x 64; one step is two
    launches) beside its bound from the inputs' distinct rows, the plain
    version and, as a yardstick only, `torch.optim.SparseAdam.step` on the
    same rows as sparse COO gradients. SparseAdam puts eps inside the bias
    correction (eps·sqrt(bc2)), so it is not the same function and its
    output is not compared."""
    rng = np.random.default_rng(SEED + 1200)
    sides = {}
    for side, v, n in (("user", SP_USERS, SP_B), ("item", SP_ITEMS, 2 * SP_B)):
        tables, _ = sparse_rows_inputs(v, D, 1, SEED + 1210 + v)
        steps = [sparse_rows_step(rng, v, D, n) for _ in range(3)]
        sides[side] = (tables, steps)
    inputs = [tuple(steps[r] for _, steps in sides.values()) for r in range(3)]
    tabs = [tables for tables, _ in sides.values()]

    err = 0.0
    for (tables, _), (sid, g) in zip(sides.values(), inputs[0]):
        k = [t.clone() for t in tables]
        p = [t.clone() for t in tables]
        sparse_adam_rows_kernel(*k, sid, g, 10, SP_LR)
        sync()
        sparse_adam_rows_plain(*p, sid, g, 10, SP_LR)
        err = max([err] + [float((a - b).abs().max()) for a, b in zip(k, p)])
    require(err == 0.0, f"kernel 6 at the step's shapes: max |kernel - plain| {err}")

    def kernel(*steps):
        for t, (sid, g) in zip(tabs, steps):
            sparse_adam_rows_kernel(*t, sid, g, 10, SP_LR)

    def plain(*steps):
        for t, (sid, g) in zip(tabs, steps):
            sparse_adam_rows_plain(*t, sid, g, 10, SP_LR)

    params = [torch.nn.Parameter(t[0].clone()) for t in tabs]
    yard = torch.optim.SparseAdam(params, lr=SP_LR)
    coo = []
    for steps in inputs:
        grads = []
        for prm, (sid, g) in zip(params, steps):
            head = torch.ones_like(sid, dtype=torch.bool)
            head[1:] = sid[1:] != sid[:-1]
            grads.append(torch.sparse_coo_tensor(sid[head].long()[None], g[head], prm.shape,
                                                 check_invariants=True))
        coo.append(tuple(grads))

    def library(*grads):  # yardstick only; the port never calls it
        for prm, gr in zip(params, grads):
            prm.grad = gr
        yard.step()

    ms = time_ms(kernel, inputs, 50)
    plain_ms = time_ms(plain, inputs, 20)
    library_ms = time_ms(library, coo, 20)
    distinct = [int(torch.unique(sid).numel()) for sid, _ in inputs[0]]
    nbytes = sum(r * (3 * 2 * D * 4 + D * 4 + 8) for r in distinct)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 16 * sum(distinct) * D / PEAK_F32_FLOPS * 1e3
    log(f"kernel 6 timing, one step (2 launches: user {SP_B} ids into {SP_USERS}x{D}, item "
        f"{2 * SP_B} ids into {SP_ITEMS}x{D}; distinct rows {distinct}): kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (torch.optim.SparseAdam.step, "
        f"another eps placement) bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes > t_ops else 'operations'}; {nbytes / 1e6:.1f} MB, "
        f"ops {t_ops:.5f}, bytes {t_bytes:.4f})")
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }


# ------------------------------------- the gathers' backward (embed_grad)

# (name, n, table rows, D, ids from [0, high), "perm" (a permutation) or
# "pads" (the kept rows from [1, table rows), the others at the pad row
# 0), share of rows kept): the device epoch's bucket gathers (every IV row
# at bucket 0, discarded or kept; the OOV rows' spread buckets), its row
# overrides (positions, each once), xDeepFM's packed token table (8,192
# rows x 7 fields, a small-vocabulary field's few rows), DCNv2's (D 16,
# ids over the whole table), the first-order twin at D 1, E3's token_seq
# field (8,192 rows x 16 positions, 47 % of them live, into 1,000 rows at
# D 10 and its twin at D 1), a width past one warp, RippleNet's relation
# lookup (2,048 users x 8 memories into 42 rows of D x D: eight slices of
# the row) and a ragged width past two slices, a ragged short input and
# none
EMBED_GRAD_CASES = [
    ("bucket-0-discarded", SP_B, SP_BUCKETS, D, 1, 0.0),
    ("bucket-0-kept", SP_B, SP_BUCKETS, D, 1, 1.0),
    ("oov-spread", SP_B, SP_BUCKETS, D, SP_BUCKETS, 0.3),
    ("row-overrides", 2 * SP_B, 2 * SP_B, D, "perm", 1.0),
    ("ctr-tokens", 7 * CTR_B, 330_000, CTR_D, 3, 0.9),
    ("dcnv2-tokens", 7 * CTR_B, 330_000, 16, 330_000, 0.9),
    ("first-order-D1", 7 * CTR_B, 330_000, 1, 40, 1.0),
    ("tags-seq", 16 * CTR_B, 1000, CTR_D, "pads", 0.47),
    ("tags-seq-D1", 16 * CTR_B, 1000, 1, "pads", 0.47),
    ("D100", 3000, 500, 100, 50, 0.8),
    ("ripplenet-relations", 16_384, 42, D * D, "skew", 1.0),
    ("D1030", 3000, 60, 1030, 60, 0.8),
    ("ragged31", 31, 8, 2, 8, 1.0),
    ("empty", 0, 16, 4, 1, 1.0),
]
EMBED_GRAD_TOL = 1e-5
# the plan route (ops/embed_grad.py:build_plan, the sort of fixed ids done
# once) at L2's edges (1,611,078 ids into 9,748 rows: both directions of a
# MovieLens-1M-shaped split, ids drawn with a degree skew whose heaviest
# row takes about 3,500), N1's (2,611,078 into 66,041), KGIN's relation
# lookup (500,000 into 40), KGAT's denominators at D 1, a run of one id
# 1,611,078 long, edges that leave every other row empty, and few edges
# into many rows (a small graph's nodes; KGAT's rel * N + src rows), whose
# plans the one-block sort builds with more rows than its shared memory
# holds offsets for; random cotangents are held against the plain version
# in float64 (a run of 1.6 M float32 terms rounds by more than
# EMBED_GRAD_TOL in either order)
EMBED_GRAD_PLAN_CASES = [
    ("L2-edges", 1_611_078, 9_748, D, "skew"),
    ("N1-edges", 2_611_078, 66_041, D, "skew"),
    ("kgin-rel", 500_000, 40, D, "skew"),
    ("L2-edges-D1", 1_611_078, 9_748, 1, "skew"),
    ("one-id-run", 1_611_078, 9_748, D, "one"),
    ("empty-rows", 1_611_078, 9_748, D, "holes"),
    ("few-edges", 2_000, 100_000, D, 100_000),
    ("few-edges-kgat-rows", 10_000, 2_600_000, D, 2_600_000),
]
# BPR's item table on the host path (2,048 ids a batch into 1 M rows)
BPR_ITEM_ROWS = N_OLD_ITEMS + N_NEW_ITEMS


def embed_grad_inputs(n, n_rows, d, high, p_live, seed, integer, ids_dtype=torch.int64):
    gen = torch_generator(seed, DEVICE)
    if high == "perm":
        ids = torch.randperm(n, generator=gen, device=DEVICE)
    elif high == "skew":
        ids = (torch.rand(n, generator=gen, device=DEVICE) ** 1.5 * n_rows).long()
    elif high == "one":
        ids = torch.full((n,), 5, device=DEVICE)
    elif high == "holes":
        ids = 2 * torch.randint(0, n_rows // 2, (n,), generator=gen, device=DEVICE)
    else:
        ids = torch.randint(1 if high == "pads" else 0, n_rows if high == "pads" else high,
                            (n,), generator=gen, device=DEVICE)
    live = torch.rand(n, generator=gen, device=DEVICE) < p_live
    if high == "pads":
        ids = torch.where(live, ids, 0)
    if integer:
        g = torch.randint(-8, 9, (n, d), generator=gen, device=DEVICE).float()
    else:
        g = torch.randn((n, d), generator=gen, device=DEVICE)
    return g, ids.to(ids_dtype), live, n_rows


def embed_grad_compare(got, again, want, name, integer, scale_of=None):
    """`got` (a kernel call) against `want` (the plain version) and
    `again` (a repeat): bit for bit on integer-valued cotangents, else to
    EMBED_GRAD_TOL relative to max(1, the largest magnitude). → the
    relative error (0 on integers)."""
    require(got.shape == want.shape, f"embed_grad {name}: shape {tuple(got.shape)}")
    require(torch.equal(got, again), f"embed_grad {name}: a repeat gave other bits")
    if integer:
        require(torch.equal(got, want), f"embed_grad {name}: differs from the plain version")
        return 0.0
    if not want.numel():
        return 0.0
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) / scale
    require(err <= EMBED_GRAD_TOL, f"embed_grad {name}: relative error {err}")
    return err


def embed_grad_cases():
    """The gathers' backward kernel (`csrc/embed_grad.cu`) against its plain
    version on the card: bit for bit on integer-valued cotangents (int64
    and int32 ids), to EMBED_GRAD_TOL relative to max(1, the plain
    result's largest magnitude) on random ones, and against a repeat run
    bit for bit; at n <= SMALL_MAX also the one-block sort's arrays
    against PyTorch's stable sort (`plan_packed_plain`), and every case
    again on the plan route (its ids' plan, the discarded rows' cotangents
    zeroed). Then EMBED_GRAD_PLAN_CASES: the plan built on the card ==
    `plan_packed_plain`, its zeroed counters after the calls, and the
    calls held as above (random ones against the plain version in
    float64). → the largest relative error."""
    worst = 0.0
    for i, (name, n, n_rows, d, high, p_live) in enumerate(EMBED_GRAD_CASES):
        for integer in (True, False):
            for ids_dtype in ((torch.int64, torch.int32) if integer else (torch.int64,)):
                what = f"{name} ({ids_dtype}, {'integer' if integer else 'random'})"
                g, ids, live, rows = embed_grad_inputs(n, n_rows, d, high, p_live,
                                                       SEED + 1300 + i, integer, ids_dtype)
                got = embed_grad.scatter_rows_kernel(g, ids, rows, live)
                again = embed_grad.scatter_rows_kernel(g, ids, rows, live)
                sync()
                want = embed_grad.scatter_rows_plain(g, ids, rows, live)
                worst = max(worst, embed_grad_compare(got, again, want, what, integer))
                if 0 < n <= embed_grad.SMALL_MAX:
                    arrays = embed_grad.sort_arrays(ids, rows, live)
                    keys = torch.where(live, ids.long(), rows)
                    perm = torch.argsort(keys, stable=True)
                    sk = keys[perm]
                    plain = {"perm": perm, "keys": sk,
                             "spans": embed_grad.chunk_spans(sk, embed_grad.SMALL_CHUNK, rows),
                             "offsets": torch.searchsorted(sk, torch.arange(rows + 1,
                                                                            device=DEVICE))}
                    require(all(torch.equal(arrays[k].long(), plain[k].long()) for k in plain),
                            f"embed_grad {what}: the one-block sort differs from a stable sort")
                plan = embed_grad.build_plan(ids, rows)
                masked = torch.where(live[:, None], g, 0.0)
                got = embed_grad.scatter_rows_kernel(masked, ids, rows, plan=plan)
                again = embed_grad.scatter_rows_kernel(masked, ids, rows, plan=plan)
                sync()
                require(not plan.counters.any(), f"embed_grad {what}: counters left set")
                worst = max(worst, embed_grad_compare(got, again, want, f"{what} plan", integer))
        log(f"embed_grad check {name}: n={n} rows={n_rows} D={d} ids<{high} kept {p_live}: "
            "exact on integers (int64 and int32 ids) on both routes, a repeat the same bits, "
            "the one-block sort == a stable sort")
    for i, (name, n, n_rows, d, high) in enumerate(EMBED_GRAD_PLAN_CASES):
        for integer in (True, False):
            for ids_dtype in ((torch.int64, torch.int32) if integer else (torch.int64,)):
                what = f"plan {name} ({ids_dtype}, {'integer' if integer else 'random'})"
                g, ids, _, rows = embed_grad_inputs(n, n_rows, d, high, 1.0, SEED + 1500 + i,
                                                    integer, ids_dtype)
                plan = embed_grad.build_plan(ids, rows)
                require(torch.equal(plan.packed, embed_grad.plan_packed_plain(ids, rows)),
                        f"embed_grad {what}: the plan differs from a stable sort's")
                got = embed_grad.scatter_rows_kernel(g, ids, rows, plan=plan)
                again = embed_grad.scatter_rows_kernel(g, ids, rows, plan=plan)
                sync()
                require(not plan.counters.any(), f"embed_grad {what}: counters left set")
                want = embed_grad.scatter_rows_plain(g if integer else g.double(), ids, rows)
                worst = max(worst, embed_grad_compare(got, again, want.float(), what, integer))
                del g, got, again, want, plan
        log(f"embed_grad plan check {name}: {n} ids into {n_rows} rows, D={d}, {high}: the "
            "plan == a stable sort's, exact on integers (int64 and int32 ids), random to "
            f"{EMBED_GRAD_TOL} of the float64 plain version, a repeat the same bits")
    return worst


def per_call(fn, calls, what):
    """The profile of `calls` calls of `fn`: (device ms a call, device
    activities a call (kernels and memsets), each activity's name → its
    count and device ms a call)."""
    _, busy = profiled(lambda: [fn() for _ in range(calls)], what, quiet=True, gathers=False)
    names = {name: [n / calls, us / 1e3 / calls] for us, name, n in profiled.rows}
    return busy / calls, sum(n for n, _ in names.values()), names


def embed_grad_bound(n, d, id_bytes, written_rows):
    """(ms, "bytes" or "operations"): the cotangents and ids read once,
    `written_rows` rows of D f32 written once, against n x D adds."""
    t_bytes = (n * d * 4 + n * id_bytes + written_rows * d * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = n * d / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def embed_grad_timing(err):
    """The kernel at the device epoch's bucket gathers (8,192 rows into
    1,024 x 64: ids spread over the buckets and kept, as in the OOV
    sub-epoch; the pass owns the table), at BPR's item gathers (2,048 ids
    into its 1 M-row table: a memset, the sort, the pass) and with a plan
    at L2-shaped edges (1,611,078 into 9,748 x 64, skewed) beside the same
    call without one: each beside its bound (the cotangents and ids read
    once, the table written once: every row, as the plain version and the
    library call write it), its plain version and the library call
    (`embedding_dense_backward`, torch.nn.functional.embedding's backward;
    `index_add_` for the edges). A call's ms (CUDA events, host included),
    its device ms and device activities from a profile. → the numbers."""
    out = {}
    cases = (("batch", SP_B, SP_BUCKETS, SP_BUCKETS, SEED + 1400),
             ("bpr-items", BPR_TRAIN_B, BPR_ITEM_ROWS, BPR_ITEM_ROWS, SEED + 1401),
             ("plan-L2-edges", 1_611_078, 9_748, "skew", SEED + 1402))
    for case, n, rows, high, seed in cases:
        g, ids, live, rows = embed_grad_inputs(n, rows, D, high, 1.0, seed, False)
        plan = embed_grad.build_plan(ids, rows) if case.startswith("plan") else None
        live = None if plan is not None else live
        kernel = lambda: embed_grad.scatter_rows_kernel(g, ids, rows, live, plan)  # noqa: E731
        plain = lambda: embed_grad.scatter_rows_plain(g, ids, rows, live)  # noqa: E731
        if plan is None:
            library = lambda: torch.ops.aten.embedding_dense_backward(  # noqa: E731
                g, ids, rows, -1, False)
        else:
            library = lambda: torch.zeros((rows, D), device=DEVICE).index_add_(  # noqa: E731
                0, ids, g)
        reps = 50 if n < 100_000 else 20
        ms, plain_ms, library_ms = (time_ms(f, [()], reps) for f in (kernel, plain, library))
        device_ms, per, names = per_call(kernel, 20, f"profile 20 calls of the gathers' "
                                         f"backward kernel, {case}")
        bound, by = embed_grad_bound(n, D, 8, rows)
        row = {"ms": ms, "device_ms": device_ms, "launches_a_call": per, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound, "bound_by": by, "n": n,
               "rows": rows, "kernels": names}
        if plan is not None:  # the same call without the plan: the device-wide sort
            nop = lambda: embed_grad.scatter_rows_kernel(g, ids, rows)  # noqa: E731
            row["no_plan_ms"] = time_ms(nop, [()], reps)
            row["no_plan_device_ms"], row["no_plan_launches_a_call"], _ = per_call(
                nop, 20, f"profile 20 calls without the plan, {case}")
        out[case] = row
        log(f"embed_grad timing {case}: {n} rows into {rows}x{D}: kernel_ms={ms:.4f} "
            f"(device {device_ms:.4f} ms, {per:.2f} device activities a call: {names}) "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound:.5f} ({by})"
            + (f"; without the plan {row['no_plan_ms']:.4f} ms (device "
               f"{row['no_plan_device_ms']:.4f}, {row['no_plan_launches_a_call']:.2f} a call)"
               if plan is not None else ""))
        del g, ids, live, plan
    batch = out["batch"]
    require(batch["launches_a_call"] <= 3 and out["bpr-items"]["launches_a_call"] <= 3
            and out["plan-L2-edges"]["launches_a_call"] == 1,
            "embed_grad: device activities a call "
            f"{[(k, v['launches_a_call']) for k, v in out.items()]}")
    out["routes"] = embed_grad_routes()
    EMBED_GRAD_TIMES.update(out)
    return {
        "max_abs_err": err,
        "ms": batch["ms"],
        "plain_ms": batch["plain_ms"],
        "bound_ms": batch["bound_ms"],
        "bound_by": batch["bound_by"],
        "library_ms": batch["library_ms"],
        "device_ms": batch["device_ms"],
    }


EMBED_GRAD_TIMES = {}  # embed_grad_timing's numbers by case, for the last lines

# (name, n, table rows, D, ids from [0, high) or "skew"): batch ids around
# the one-block sort's limit (SMALL_MAX) into the device epoch's 1,024 x
# 64 buckets, and RippleNet's lookups of a step (N1: 2,048 users x 8
# memories; the relation table's 42 rows of D x D, the entity table's
# 59,645 rows)
EMBED_GRAD_ROUTE_CASES = [
    ("8192", SP_B, SP_BUCKETS, D, SP_BUCKETS),
    ("12288", 12_288, SP_BUCKETS, D, SP_BUCKETS),
    ("16384", 16_384, SP_BUCKETS, D, SP_BUCKETS),
    ("ripplenet-relations", 16_384, 42, D * D, "skew"),
    ("ripplenet-entities", 16_384, 59_645, D, 59_645),
]


def embed_grad_routes():
    """A batch call without a plan on both routes at the same inputs: the
    one-block sort (`block`) and the device-wide one (`device`), device
    ms and device activities a call from a profile of 20 calls, at
    EMBED_GRAD_ROUTE_CASES: where SMALL_MAX should lie. → the numbers."""
    out = {}
    for i, (case, n, rows, d, high) in enumerate(EMBED_GRAD_ROUTE_CASES):
        g, ids, live, rows = embed_grad_inputs(n, rows, d, high, 1.0, SEED + 1410 + i, False)
        row = {"n": n, "rows": rows, "d": d, "chosen": "block" if n <= embed_grad.SMALL_MAX
               else "device"}
        for route, small in (("block", True), ("device", False)):
            call = lambda: embed_grad._sorted_call(g, ids, rows, None, small)  # noqa: E731
            row[f"{route}_device_ms"], row[f"{route}_launches_a_call"], names = per_call(
                call, 20, f"profile 20 calls of the gathers' backward, {case}, {route} route")
            row[f"{route}_kernels"] = names
        out[case] = row
        log(f"embed_grad route {case}: {n} ids into {rows}x{d}: one-block sort "
            f"{row['block_device_ms']:.4f} device ms ({row['block_launches_a_call']:.0f} a "
            f"call), device-wide {row['device_device_ms']:.4f} "
            f"({row['device_launches_a_call']:.0f}); taken: {row['chosen']}")
        del g, ids, live
    return out


# ------------------------------------- retrieval training, device epoch


def structured_pairs(rng, n_rows):
    """(users, items): users uniform, each in group user % SP_GROUPS, and
    SP_IN_GROUP of the rows take an item from the group's slice of the
    item ids, the rest any item."""
    users = rng.integers(1, SP_USERS, n_rows)
    width = (SP_ITEMS - 1) // SP_GROUPS
    in_group = rng.random(n_rows) < SP_IN_GROUP
    items = np.where(in_group, 1 + (users % SP_GROUPS) * width + rng.integers(0, width, n_rows),
                     rng.integers(1, SP_ITEMS, n_rows))
    return users, items


def sparse_cfg(impl, **over):
    d = {"seed": SEED, "train_batch_size": SP_B, "learner": "sparse_adam",
         "learning_rate": SP_LR, "epochs": 1, "train_oov": True, "oov_only_epoch": True,
         "oov_train_ratio": 0.2, "oov_feature_mask_rate": 0.2, "device_epoch": True,
         "sparse_update_impl": impl, "host_scan_steps": 1}
    d.update(over)
    return Config(d)


def sparse_model():
    """BPR at D = 64 with SP_BUCKETS random-mapper buckets a side, from one
    seed."""
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS, hash_function="3round")
    return BPR(SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
               generator=torch_generator(SEED + 40, DEVICE))


def sparse_fit(loader, impl, **over):
    """A fresh BPR from one seed through `Trainer.fit` on the device epoch.
    → (trainer, per sub-epoch records: losses, steps run, wall, examples/s;
    and the normal epoch's set-up seconds, built before `fit`)."""
    trainer = Trainer(sparse_cfg(impl, **over), sparse_model())
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        sync()
        t0 = time.perf_counter()
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        sync()
        de = trainer._device_epochs.get((id(ldr), keep_ratio is not None, frozen))
        seen["oov" if keep_ratio is not None else "normal"] = {
            "losses": trainer.last_losses, "steps": de.steps_run if de else None,
            "wall": time.perf_counter() - t0, "eps": trainer.last_examples_per_sec,
            "sparse": de is not None and de.sparse_impl}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer._maybe_device_epoch(loader)  # set-up: columns and bitmap to the card
    sync()
    seen["setup"] = time.perf_counter() - t0
    trainer.fit(loader, None, saved=False)
    trainer._train_epoch = inner
    return trainer, seen


def state_of(trainer):
    """Parameters and the optimizer state's tensors (Adam's moments,
    adagrad's sums, per-leaf counts), cloned."""
    out = {n: p.detach().clone() for n, p in trainer.params.items()}
    for part, tree in trainer.opt_state.items():
        if isinstance(tree, dict):
            out.update({f"{part}:{n}": t.clone() for n, t in tree.items()})
    return out


def eager_steps(trainer):
    """`trainer` with its dense steps run eagerly, uncaptured: for the
    phases that count a kernel's launches a step, swap a kernel's route
    between steps of one trainer, or time the eager step against the
    numbers recorded for it (a replayed graph runs no wrapper and keeps
    the route it was captured with). → trainer."""
    trainer.step_graphs.step = lambda batch, trainable=None: trainer._apply_step(
        batch, trainable)
    return trainer


def recorded_run(trainer, loader):
    """One epoch of `trainer` over `loader` (no OOV sub-epoch) with every
    step's gradients kept: the tables' (ids, row gradients) on the sparse
    path, the dense gradients otherwise. → (losses, parameters, gradient of
    element (name, flat index) at each step). A dense device-epoch step
    runs eagerly here: a replayed CUDA graph runs no Python, so it could
    not hand each step's gradients over."""
    from oovrec_tpu_torch.train import trainer as trainer_mod

    tables_seen, rest_seen = {}, []
    update = trainer_mod.sparse_adam_update_table

    def recording_update(table, state, ids, grows, *a, **k):
        name = next(n for n, p in trainer.params.items() if p is table)
        tables_seen.setdefault(name, []).append((ids.clone(), grows.clone()))
        return update(table, state, ids, grows, *a, **k)

    trainer_mod.sparse_adam_update_table = recording_update
    try:
        step = trainer.optimizer.step

        def recording_step(params, g, state, trainable=None, **kw):
            rest_seen.append({n: t.detach().clone() for n, t in g.items()})
            return step(params, g, state, trainable, **kw)

        trainer.optimizer.step = recording_step
        eager_steps(trainer)._train_epoch(loader, 0)
    finally:
        trainer_mod.sparse_adam_update_table = update

    def grad(n, i):
        if n in tables_seen:
            r, c = divmod(i, trainer.params[n].shape[1])
            return torch.stack([g[ids == r, c].sum() for ids, g in tables_seen[n]])
        return torch.stack([g[n].flatten()[i] for g in rest_seen])

    return trainer.last_losses, {n: p.detach() for n, p in trainer.params.items()}, grad


def _skip_backward(g, ids, n_rows, live=None, plan=None):
    """The kernel's plain version on the card: `embedding_dense_backward`
    with the discarded rows sent to a padding row that it skips."""
    return embed_grad.scatter_rows_plain(g, ids, n_rows, live)


def _embedding_backward(g, ids, n_rows, live=None, plan=None):
    """`torch.nn.functional.embedding`'s backward over every row."""
    return torch.ops.aten.embedding_dense_backward(g, ids.long(), n_rows, -1, False)


def _index_backward(g, ids, n_rows, live=None, plan=None):
    """torch's indexing backward over every row (`index_put_` with
    accumulate), the port's gathers' backward before `csrc/embed_grad.cu`."""
    return g.new_zeros((n_rows, g.shape[-1])).index_put_((ids.long(),), g, accumulate=True)


# D4's backward routes of the row gathers: the port's (the kernel) and the
# three it was measured against, each patched in for `embed_grad.scatter_rows`
BACKWARD_ROUTES = {"kernel": embed_grad.scatter_rows, "skip": _skip_backward,
                   "embedding": _embedding_backward, "index": _index_backward}


@contextlib.contextmanager
def backward_route(route):
    """Run the block with `ops/embed_grad.py`'s backward replaced by the
    route `route` of BACKWARD_ROUTES."""
    old, old_name = embed_grad.scatter_rows, backward_route.name
    embed_grad.scatter_rows, backward_route.name = BACKWARD_ROUTES[route], route
    try:
        yield
    finally:
        embed_grad.scatter_rows, backward_route.name = old, old_name


backward_route.name = "kernel"


def gather_backward_ms():
    """D4: the row gathers' backward (`ops/embed_grad.py`) at the device
    epoch's shape: SP_B rows of the (SP_BUCKETS, D) bucket table under each
    of its routes, with ids all 0 and every row thrown away (an IV row's
    placeholder bucket, as branchless routing makes it) and with ids spread
    and every row kept; each twice on the same random cotangents: the same
    bits. The bound: the cotangent and ids read once, the touched rows
    written once. → {route: {case: {call_ms, device_ms}}} and the bound of
    each case in ms."""
    table = torch.zeros((SP_BUCKETS, D), device=DEVICE, requires_grad=True)
    gen = torch_generator(SEED, DEVICE)
    grad = torch.randn((SP_B, D), device=DEVICE, generator=gen)
    spread = torch.randint(0, SP_BUCKETS, (SP_B,), device=DEVICE, generator=gen)
    cases = {
        "all 0, discarded": (torch.zeros_like(spread),
                             torch.zeros(SP_B, dtype=torch.bool, device=DEVICE)),
        "spread, kept": (spread, torch.ones(SP_B, dtype=torch.bool, device=DEVICE)),
    }

    def bwd(ids, live):
        return torch.autograd.grad(embed_grad.gather_rows(table, ids, live), table, grad)[0]

    bound = {}
    for case, (ids, live) in cases.items():
        touched = int(torch.unique(ids[live]).numel())
        bound[case] = (SP_B * D * 4 + SP_B * 8 + touched * D * 4) / PEAK_BYTES_PER_S * 1e3
    out = {}
    for route in BACKWARD_ROUTES:
        out[route] = {}
        with backward_route(route):
            for case, (ids, live) in cases.items():
                first, again = bwd(ids, live), bwd(ids, live)
                require(torch.equal(first, again), f"{route} backward, ids {case}: a repeat "
                        "gave other bits")
                call_ms = time_ms(bwd, [(ids, live)], 20)
                profiled(lambda: [bwd(ids, live) for _ in range(20)],
                         f"profile 20 backward calls, {route} route, ids {case}", quiet=True)
                out[route][case] = {"call_ms": call_ms, "device_ms": profiled.gathers_ms / 20}
        log(f"gathers' backward, {route} route, {SP_B} rows into a ({SP_BUCKETS}, {D}) table: "
            + ", ".join(f"ids {c} {v['call_ms']:.4f} ms a call, {v['device_ms']:.4f} ms of "
                        "device time" for c, v in out[route].items())
            + " (a repeat: the same bits)")
    log("gathers' backward bound: " + ", ".join(f"ids {c} {v:.5f} ms" for c, v in bound.items()))
    return out, bound


def retrieval_sparse_training():
    """BPR at bench.py's sparse-adam shape on the device-resident epoch with
    `learner: sparse_adam`: one epoch plus the unfrozen OOV sub-epoch under
    `sparse_update_impl` auto (kernel 6), xla (plain) and dense, a second
    auto run, 16 steps auto vs dense, the frozen OOV device sub-epoch, then
    where a step's time goes. → kernel 6's launches in the auto run."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    users, items = structured_pairs(rng, SP_B * SP_STEPS)
    train = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [train], seed=SEED)
    cfg = sparse_cfg("auto")
    loader = TrainBatcher(train, sampler, cfg, InputType.PAIRWISE)
    require(loader.mode == "pairwise" and len(loader) == SP_STEPS, "sparse BPR loader")
    log(f"sparse retrieval training data: {len(train)} rows, {SP_USERS} users, {SP_ITEMS} "
        f"items, {SP_GROUPS} groups ({SP_IN_GROUP:.0%} in group), {time.perf_counter() - t0:.1f} s")

    sparse_adam_rows_kernel.launches = 0
    embed_grad.scatter_rows_kernel.launches = 0
    sync()
    trainer, seen = sparse_fit(loader, "auto")
    launches = sparse_adam_rows_kernel.launches
    gather_launches = embed_grad.scatter_rows_kernel.launches
    normal, oov = seen["normal"], seen["oov"]
    ran = normal["steps"] + oov["steps"]
    de = trainer._device_epochs[(id(loader), False, False)]
    log(f"sparse retrieval training (auto): {normal['steps']} steps + {oov['steps']} kept OOV "
        f"steps of {len(oov['losses'])} ({normal['sparse']}, {oov['sparse']}); set-up "
        f"{seen['setup']:.2f} s; epoch {normal['wall'] * 1e3 / normal['steps']:.2f} ms per step "
        f"(wall, host included), {normal['eps']:.0f} examples/s; OOV sub-epoch "
        f"{oov['wall'] * 1e3 / max(1, oov['steps']):.2f} ms per kept step (its set-up "
        f"included); kernel 6 launches "
        f"{launches}; used-pair bitmap {de.bitmap.numel() * 4 / 1e9:.3f} GB")
    require(normal["steps"] == SP_STEPS and oov["steps"] > 0, "sparse training steps")
    require(normal["sparse"] == oov["sparse"] == "pallas", "the sparse path with kernel 6")
    require(launches == 2 * ran, f"kernel 6 launches {launches} for {ran} steps")
    # the gathers' backward: the 3 bucket gathers (the IV row overrides are
    # read as slices of the gathered rows, without a gather)
    require(gather_launches == 3 * ran,
            f"gathers' backward kernel launches {gather_launches} for {ran} steps")
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(oov["losses"]).all(), "loss not finite")
    log(f"sparse retrieval training: loss first tenth {first:.6f}, last tenth {last:.6f}")
    require(last < first, f"loss did not fall: first tenth {first}, last tenth {last}")

    # negatives on a sample of steps: never PAD, never a used pair (with
    # ~4 used items a user of 99,999 a give-up after 64 rounds has
    # probability ~1e-270)
    n_neg = used = pad = 0
    bitmap, W = de.bitmap.view(-1), de.bitmap.shape[1]
    for i, (step, batch) in enumerate(de.batches(7)):
        u, neg = batch["user_id"], batch["neg_item_id"]
        bits = (bitmap[u * W + (neg >> 5)] >> (neg & 31)) & 1
        used += int(bits.sum())
        pad += int((neg == 0).sum())
        n_neg += neg.numel()
        if i == 3:
            break
    log(f"negatives on 4 sampled steps: {n_neg} drawn, {pad} PAD, {used} used pairs")
    require(pad == 0 and used == 0, "a negative was PAD or a used pair")
    auto1 = state_of(trainer)

    # the frozen OOV device sub-epoch: the sparse path is off, as in JAX
    iv = [n for n in trainer.params if n not in trainer.oov_params]
    before = state_of(trainer)
    k0 = sparse_adam_rows_kernel.launches
    trainer._train_epoch(loader, 1, oov_transform=trainer.oov_simulator,
                         keep_ratio=trainer.oov_train_ratio, frozen=True)
    fde = trainer._device_epochs[(id(loader), True, True)]
    moved = {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])}
    log(f"frozen OOV device sub-epoch: {fde.steps_run} kept steps, sparse path "
        f"{fde.sparse_tables}, moved {sorted(moved)}")
    require(fde.sparse_tables is None and sparse_adam_rows_kernel.launches == k0,
            "the frozen sub-epoch took the sparse path")
    require(fde.steps_run > 0 and not moved & set(iv) and moved == trainer.oov_params,
            f"the frozen sub-epoch moved {sorted(moved)}")
    del trainer, de, fde, before

    # xla (the plain write-back) and a second auto run: the same bits
    for impl in ("xla", "auto"):
        other, oseen = sparse_fit(loader, impl)
        got = state_of(other)
        same = [n for n in auto1 if torch.equal(auto1[n], got[n])]
        log(f"sparse retrieval training ({impl}): {oseen['normal']['steps']} + "
            f"{oseen['oov']['steps']} steps, {oseen['normal']['wall'] * 1e3 / SP_STEPS:.2f} ms "
            f"per step; {len(same)} of {len(auto1)} parameters and moments equal the first "
            f"auto run bit for bit")
        require(len(same) == len(auto1), f"{impl} run differs from the auto run")
        del other, got

    # auto vs the dense lazy sweep over the first COMPARE_STEPS steps
    part = DatasetSplit({"user_id": users[: COMPARE_STEPS * SP_B],
                         "item_id": items[: COMPARE_STEPS * SP_B]}, SP_USERS, SP_ITEMS)
    part_loader = TrainBatcher(part, sampler, cfg, InputType.PAIRWISE)
    la, pa, ga = recorded_run(Trainer(sparse_cfg("auto", train_oov=False), sparse_model()),
                              part_loader)
    lb, pb, gb = recorded_run(Trainer(sparse_cfg("dense", train_oov=False), sparse_model()),
                              part_loader)
    compare_trajectories("sparse (kernel 6) vs dense lazy-Adam training", ("sparse", "dense"),
                         la, lb, pa, pb, ga, gb)
    del pa, pb, ga, gb

    # where a step's time goes: 8 steps on the device epoch under the
    # profiler and under the sync check, then the host per-batch path
    short = DatasetSplit({"user_id": users[: 8 * SP_B], "item_id": items[: 8 * SP_B]},
                         SP_USERS, SP_ITEMS)
    short_loader = TrainBatcher(short, sampler, cfg, InputType.PAIRWISE)
    trainer, _ = sparse_fit(short_loader, "auto", train_oov=False)
    de = trainer._device_epochs[(id(short_loader), False, False)]
    de.run(1)
    sync()
    wall_ms, busy_ms = profiled(
        lambda: de.run(2), f"profile {de.n_steps} device-epoch steps (sparse_adam, kernel 6)",
        shares=(("kernel 6", ("sparse_adam_rows_kernel",)),))
    log(f"device-epoch profile: {wall_ms / de.n_steps:.2f} ms per step under the profiler, "
        f"{busy_ms / de.n_steps:.3f} ms of device time a step")
    # D4: the same steps under each backward route of the gathers
    routes = {}
    for route in BACKWARD_ROUTES:
        with backward_route(route):
            de.run(4)
            sync()
            t0 = time.perf_counter()
            de.run(5)
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3 / de.n_steps
            _, busy = profiled(lambda: de.run(6), f"profile {de.n_steps} device-epoch steps, "
                               f"gathers' backward route {route}")
            routes[route] = {"step_ms": step_ms, "device_ms": busy / de.n_steps,
                             "gathers_ms": profiled.gathers_ms / de.n_steps}
        log(f"device-epoch step, {route} route: {step_ms:.3f} ms a step (wall), "
            f"{routes[route]['device_ms']:.3f} ms of device time, the gathers' backward "
            f"{routes[route]['gathers_ms']:.3f} ms "
            f"({100 * routes[route]['gathers_ms'] / routes[route]['device_ms']:.1f} %)")
    GATHER_RESULTS["device_epoch"] = routes
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        de.run(3)
    torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    log(f"host syncs in a {de.n_steps}-step device epoch: {len(syncs)} {sorted(set(syncs))[:4]}")
    del trainer, de
    # the host per-batch path at the same shape: the row-sparse step
    # (`Trainer._sparse_step`, kernel 6) and the dense lazy-Adam sweep, each
    # warmed by an epoch, then timed an epoch at a time in the order
    # sparse, dense, dense, sparse
    hosts = {impl: eager_steps(Trainer(sparse_cfg(impl, device_epoch=False, train_oov=False),
                                       sparse_model())) for impl in ("auto", "dense")}
    host_ms = {impl: [] for impl in hosts}
    for impl, host in hosts.items():
        require(bool(host.sparse_tables) == (impl == "auto"), f"host path {impl}: sparse tables")
        host._train_epoch(short_loader, 0)
    for epoch, impl in enumerate(("auto", "dense", "dense", "auto"), 1):
        sync()
        t0 = time.perf_counter()
        hosts[impl]._train_epoch(short_loader, epoch)
        sync()
        host_ms[impl].append((time.perf_counter() - t0) * 1e3 / len(short_loader))
    require(not any(h._device_epochs for h in hosts.values()),
            "the host path took the device epoch")
    del hosts
    log("host per-batch path, same shape, ms per step (wall, host included): "
        f"{', '.join(f'{t:.2f}' for t in host_ms['auto'])} with the row-sparse step (kernel 6), "
        f"{', '.join(f'{t:.2f}' for t in host_ms['dense'])} with the dense lazy-Adam sweep "
        "(run in the order sparse, dense, dense, sparse)")
    return launches, gather_launches


# -------------------------------------------------------------- CLI phases

# the `python -m oovrec_tpu_torch.cli.run` entry on the tracked corpus
# dataset/synth-ind (EXPERIMENTS.md:40-45 with the random mapper in place of
# the lsh embedder), its float_seq `*_vector` columns left out
CLI_DIR = os.path.join("build", "cli")
SYNTH_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                  "'user': ['user_id','age','group'], 'item': ['item_id','price','category']}")
CLI_OOV = ["--inductive_mapper=random", "--add_oov_buckets=True", "--n_user_oov_buckets=200",
           "--n_item_oov_buckets=200", "--train_oov=True", "--oov_train_ratio=0.3",
           "--inductive_eval=True"]
CLI_EPOCHS_A, CLI_EPOCHS_B = 1, 1  # A and D1, B and D2: 5 epochs until phase J, 3 until K,
                                  # 2 until L
SLICE_NAMES = ("overall", "old_users", "new_users", "old_old", "old_new", "new_old", "new_new")
# phase C: an atomic-file family the card notices (tools/make_synth_dataset.py's
# generator at 50,000 users x 100,000 items x 1,000,000 rows, 10 % new), BPR
# at D = 64 with 1,024 buckets a side, full-sort eval, sparse adam on the
# device epoch at the sparse phase's lr 1e-2; 256 users a full-sort batch
C_USERS, C_ITEMS, C_INTERS, C_NEW_RATIO, C_SEED = 50_000, 100_000, 1_000_000, 0.1, 7
C_BUCKETS, C_EVAL_USERS = 1024, 256
# C: the two `--eval_only` runs share the training corpus through the
# `save_dataset` pickle (each rebuilt it until phase N): a depth cut for the
# 750 s budget; the inductive corpus is rebuilt by each
C_EVAL_CACHE = True


# every `python -m oovrec_tpu_torch.cli.<module>` of the script (A, D1, E1,
# G3, H2-K2, L3 with M3 and N2, P1) runs in one child started at the
# first: it reads one JSON [module, argv] a line, runs the module as
# `__main__` (as `-m` does) with the launch counts from 0, and prints the
# run's wall, launches and exit code; after each call of
# `quick_start.objective_function` (a search's trial) it prints the call's
# launches and the card's allocated bytes ("CLI trial"). One process start
# instead of ten: a depth cut for the 750 s budget (phase N), which drops no
# check.
CLI_SERVER = ("import gc, json, runpy, sys, time, traceback\n"
              "import torch\n"
              "from oovrec_tpu_torch.cli import quick_start\n"
              "from oovrec_tpu_torch.ops import launches\n"
              "objective = quick_start.objective_function\n"
              "def counted_objective(*args, **kwargs):\n"
              "    before = launches.launch_counts()\n"
              "    res = objective(*args, **kwargs)\n"
              "    after = launches.launch_counts()\n"
              "    print('CLI trial ' + json.dumps({\n"
              "        'launches': {k: after[k] - before[k] for k in after},\n"
              "        'allocated': torch.cuda.is_available() and torch.cuda.memory_allocated()}),\n"
              "        flush=True)\n"
              "    return res\n"
              "quick_start.objective_function = counted_objective\n"
              "for request in sys.stdin:\n"
              "    module, sys.argv[1:] = json.loads(request)\n"
              "    launches.reset_launch_counts()\n"
              "    t0, rc = time.perf_counter(), 0\n"
              "    try:\n"
              "        runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
              "    except SystemExit as exit_:\n"
              "        code = exit_.code\n"
              "        rc = code if isinstance(code, int) else int(code is not None)\n"
              "    except Exception:\n"
              "        traceback.print_exc(file=sys.stdout)\n"
              "        rc = 1\n"
              "    gc.collect()\n"
              "    if torch.cuda.is_available():\n"
              "        torch.cuda.empty_cache()\n"
              "    print('CLI wall ' + json.dumps(time.perf_counter() - t0))\n"
              "    print('CLI launches ' + json.dumps(launches.launch_counts()))\n"
              "    print('CLI rc ' + json.dumps(rc), flush=True)\n")
CLI_TIMEOUT = 600      # s a run of the shared child may take
CLI_PROCESS = {}       # the shared child and the queue of its output lines


def cli_server():
    """The shared child (`CLI_SERVER`), started on first use; stopped by
    `stop_cli_server` (at the script's end and at exit)."""
    if "proc" not in CLI_PROCESS:
        import atexit
        import queue
        import threading

        proc = subprocess.Popen([sys.executable, "-u", "-c", CLI_SERVER], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                bufsize=1)
        lines = queue.Queue()

        def pump():
            for line in proc.stdout:
                lines.put(line.rstrip("\n"))
            lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        CLI_PROCESS.update(proc=proc, lines=lines, started=time.perf_counter())
        atexit.register(stop_cli_server)
    return CLI_PROCESS["proc"], CLI_PROCESS["lines"]


def stop_cli_server():
    proc = CLI_PROCESS.pop("proc", None)
    CLI_PROCESS.clear()
    if proc is None:
        return
    with contextlib.suppress(OSError):
        proc.stdin.close()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def cli_process(argv, module="oovrec_tpu_torch.cli.run"):
    """`python -m <module> *argv` in the shared child. → (exit code, its
    output lines, its launches, wall s: the process start too for the
    first run)."""
    import queue

    fresh = "proc" not in CLI_PROCESS
    proc, lines = cli_server()
    t0 = CLI_PROCESS["started"] if fresh else time.perf_counter()
    proc.stdin.write(json.dumps([module, list(argv)]) + "\n")
    proc.stdin.flush()
    out, said = [], {}
    while "CLI rc " not in said:
        try:
            line = lines.get(timeout=max(1.0, t0 + CLI_TIMEOUT - time.perf_counter()))
        except queue.Empty:
            stop_cli_server()
            raise AssertionError(f"the CLI child took more than {CLI_TIMEOUT} s: "
                                 + "\n".join(out[-30:]))
        require(line is not None, "the CLI child ended: " + "\n".join(out[-30:]))
        for key in ("CLI wall ", "CLI launches ", "CLI rc "):
            if line.startswith(key):
                said[key] = json.loads(line[len(key):])
                break
        else:
            out.append(line)
    return said["CLI rc "], out, said["CLI launches "], time.perf_counter() - t0


def cli_out(name):
    out = os.path.join(CLI_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    return out


def cli_flags(out):
    return [f"--checkpoint_dir={out}", f"--nfs_backup_path={os.path.join(out, 'backup')}",
            f"--results_json={os.path.join(out, 'results.json')}", "--metric_decimal_place=12"]


def agree_slices(a, b, what, tol):
    """`agree` over the 7 slices, where a metric a slice cannot define
    (AUC of a slice whose rows carry one label) must be NaN in both."""
    require(list(a) == list(b), f"{what}: slices differ")
    for s in a:
        require(list(a[s]) == list(b[s]), f"{what}[{s}]: keys differ")
        for k, x in a[s].items():
            y = b[s][k]
            if math.isnan(x) or math.isnan(y):
                require(math.isnan(x) and math.isnan(y), f"{what}[{s}][{k}]: {x} vs {y}")
            else:
                require(abs(x - y) < tol, f"{what}[{s}][{k}]: {x} vs {y}")


def finite_metrics(result, what):
    require(result and all(math.isfinite(float(v)) for v in result.values()),
            f"{what}: metrics not finite: {result}")


def cli_retrieval():
    """Phase A: the real entry in the shared CLI child, BPR on synth-ind with the
    OOV regime, uni250 valid/test and the 7-slice inductive eval; then
    `--eval_only` on its checkpoint in this process reproduces its test
    metrics and slices to 1e-9. → the subprocess wall seconds."""
    out = cli_out("a")
    argv = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
            *CLI_OOV, f"--epochs={CLI_EPOCHS_A}", *cli_flags(out)]
    rc, lines, _, wall = cli_process(argv)
    for line in lines:
        if "training [" in line or "test result" in line or "] {" in line:
            log(f"  [A] {line.split(' INFO ')[-1][:160]}")
    require(rc == 0, f"phase A: rc {rc}: " + "\n".join(lines[-30:]))
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "phase A test")
    require(tuple(res["inductive"]) == SLICE_NAMES, f"phase A slices {list(res['inductive'])}")
    finite_metrics(res["inductive"]["overall"], "phase A overall slice")
    log(f"phase A: python -m oovrec_tpu_torch.cli.run (BPR, synth-ind, {CLI_EPOCHS_A} epochs, "
        f"uni250) rc 0 in {wall:.1f} s (wall, the corpus and, where this run started it, the "
        f"shared CLI child's start included)")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'BPR-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "phase A eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "phase A eval_only slices",
                 tol=1e-9)
    log("phase A: --eval_only == the run on test metrics and the 7 slices (1e-9)")
    return wall


CIN_WRAPPERS = ("cin_layer_pooled", "cin_layer", "cin_layer_pooled_bwd", "cin_layer_bwd")


def cin_counts():
    return {k: launches.WRAPPERS[k].launches for k in CIN_WRAPPERS}


def reset_cin_counts():
    for k in CIN_WRAPPERS:
        launches.WRAPPERS[k].launches = 0


def hold_cin_at(model, db, seed):
    """The CIN forward and backward kernels against their plain versions
    (f32) at the layer shapes `model` gives one batch `db`; random
    gradients, masked near the ReLU. → the largest error, each relative to
    max(1, the plain output's largest magnitude)."""
    err = 0.0
    with torch.no_grad():
        b0 = model.concat_embed_input_fields(db).float().contiguous()
        hidden = b0
        for i, (conv, (nh, pool_all)) in enumerate(zip(model.conv1d_list, model._layer_modes())):
            inputs = (hidden, b0, conv.kernel.detach(), conv.bias.detach())
            err = max(err, cin_bwd_err(*cin_pair(inputs, nh, pool_all, "float32")))
            grads = cin_grads(inputs, nh, 0 if pool_all else nh, seed + i, False, "float32")
            err = max(err, cin_bwd_err(*cin_bwd_pair(inputs, grads, nh, pool_all, "float32")))
            hidden, _ = cin_layer_pooled(*inputs, n_hidden=nh, pool_all=pool_all)
    return err


def cli_ranking():
    """Phase B: `cli.run.main` in this process, xDeepFM at its published
    widths on synth-ind under the ranking protocol (uni250 rows, AUC and
    RMSE), with the CIN kernels counted around the run; then `--eval_only`
    with the CIN on the kernels and on the slab path agree to 1e-6. → the
    run's CIN launch counts and wall seconds."""
    out = cli_out("b")
    argv = ["--model=xDeepFM", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV,
            "--numerical_features=['age','price']", f"--epochs={CLI_EPOCHS_B}", *cli_flags(out)]
    reset_cin_counts()
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(argv)
    sync()
    wall = time.perf_counter() - t0
    counts = cin_counts()
    log(f"phase B: cli.run.main (xDeepFM, synth-ind, {CLI_EPOCHS_B} epochs, uni250) "
        f"{wall:.1f} s (wall), CIN launches {counts}")
    require(counts["cin_layer_pooled"] > 0 and counts["cin_layer_pooled_bwd"] > 0,
            f"phase B: the CIN kernels were not launched: {counts}")
    finite_metrics(res["test_result"], "phase B test")
    require(tuple(res["inductive_results"]) == SLICE_NAMES, "phase B slices")
    log(f"[B test] {dict(res['test_result'])}")
    for s, r in res["inductive_results"].items():
        log(f"[B {s}] {dict(r)}")
    model = res["trainer"].model
    model.eval()
    train_loader, _, test_loader = data_preparation(res["config"], res["dataset"])
    for what, loader_, seed in (("a training batch", train_loader, SEED + 1200),
                                ("a uni250 test batch", test_loader, SEED + 1210)):
        batch = next(iter(loader_))
        err = hold_cin_at(model, to_device_batch(batch, DEVICE), seed)
        log(f"phase B CIN kernels vs plain at {what}, layers (B, H, F, D, L) "
            f"{model.cin_layer_shapes(len(batch['weight']))}: relative error {err:.3e}")
        require(err <= CIN_TOL, f"phase B CIN at {what}: relative error {err}")
    ckpt = res["trainer"].saved_model_file
    runs = {}
    for fused in (True, False):
        reset_cin_counts()
        runs[fused] = cli_run.main([f"--eval_only={ckpt}", "--inductive_eval=True",
                                    f"--fused_cin={fused}"])
        n = cin_layer_pooled.launches
        require((n > 0) == fused, f"phase B eval_only fused_cin={fused}: {n} CIN launches")
    agree(runs[True]["test_result"], runs[False]["test_result"], "phase B kernel vs slab test",
          tol=1e-6)
    agree_slices(runs[True]["inductive_results"], runs[False]["inductive_results"],
                 "phase B kernel vs slab slices", tol=1e-6)
    log("phase B: --eval_only on the CIN kernels == on the slab path: AUC, RMSE and the "
        "7 value slices (1e-6)")
    return counts, wall


def generate(out: str, name: str, n_users: int, n_items: int, n_inters: int,
             new_ratio: float = 0.1, dim: int = 8, seed: int = 7,
             feat_dims: int = 4, feat_noise: float = 0.3):
    """A copy of `tools/make_synth_dataset.py:generate` (the tool imports
    the JAX package's config, which the card's machine cannot import):
    `<name>/` (the training corpus with is_new rows and feature files) and
    `<name>_ind/` (benchmark train/empty/test_filt and the full feature
    files) in the atomic-file format, with latent-factor structure. The
    items are drawn from the same softmax as the tool's, its sums and
    searches on the card (the tool's numpy loop took 70-85 s on the
    host of an H100 machine, the card 8 s), so the rows differ from the
    tool's where a draw lands within rounding of a boundary."""
    rng = np.random.default_rng(seed)
    n_new_u = int(n_users * new_ratio)
    n_new_i = int(n_items * new_ratio)
    n_old_u, n_old_i = n_users - n_new_u, n_items - n_new_i

    U = rng.standard_normal((n_users, dim)) * 0.7
    I = rng.standard_normal((n_items, dim)) * 0.7
    u_age = (U[:, 0] * 10 + 35 + rng.standard_normal(n_users)).round(1)
    u_group = (U[:, 1] > 0).astype(int)
    i_price = (I[:, 0] * 20 + 50 + rng.standard_normal(n_items)).round(2)
    i_cat = np.argmax(I[:, 1:4], axis=1)

    def sample_inters(users, items_pool, n, t0):
        """n rows: a user drawn uniformly, its item from the softmax of
        its latent scores over the pool, one uniform a row (the user's
        draws in the order of the sorted rows, as one `rng.random` a user
        takes them); the softmax's cumulative sums and their searches on
        the card, a block of users at a time."""
        uu = rng.integers(0, len(users), n)
        order = np.argsort(uu, kind="stable")
        uniq, starts, counts = np.unique(uu[order], return_index=True, return_counts=True)
        r = torch.from_numpy(rng.random(n).astype(np.float32)).to(DEVICE)
        Ip = torch.from_numpy(I[items_pool].astype(np.float32).T.copy()).to(DEVICE)
        Uu = torch.from_numpy(U[users[uniq]].astype(np.float32)).to(DEVICE)
        ii = torch.empty(n, dtype=torch.int64, device=DEVICE)
        block = max(1, (1 << 28) // max(1, len(items_pool)))
        width = int(counts.max())
        for bs in range(0, len(uniq), block):
            cnt = torch.from_numpy(counts[bs:bs + block]).to(DEVICE)
            logits = Uu[bs:bs + block] @ Ip
            logits -= logits.max(dim=1, keepdim=True).values
            cdf = torch.cumsum(torch.exp_(logits), dim=1)
            lo = int(starts[bs])
            hi = lo + int(counts[bs:bs + block].sum())
            row = torch.repeat_interleave(torch.arange(len(cnt), device=DEVICE), cnt)
            col = torch.arange(hi - lo, device=DEVICE) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt)
            vals = torch.zeros((len(cnt), width), device=DEVICE)
            vals[row, col] = r[lo:hi] * cdf[row, -1]
            ii[lo:hi] = torch.searchsorted(cdf, vals, right=True)[row, col]
            del logits, cdf
        picked = np.empty(n, np.int64)
        picked[order] = ii.clamp_(0, len(items_pool) - 1).cpu().numpy()
        return users[uu], items_pool[picked], t0 + np.arange(n)

    old_users = np.arange(n_old_u)
    old_items = np.arange(n_old_i)
    all_users = np.arange(n_users)
    all_items = np.arange(n_items)

    n_old_inters = int(n_inters * (1 - new_ratio))
    tu, ti, tt = sample_inters(old_users, old_items, n_old_inters, 0)
    missing_u = np.setdiff1d(old_users, np.unique(tu))
    missing_i = np.setdiff1d(old_items, np.unique(ti))
    n_fix = max(len(missing_u), len(missing_i))
    if n_fix:
        fu = np.concatenate([missing_u, rng.choice(old_users, n_fix - len(missing_u))])
        fi = np.concatenate([missing_i, rng.choice(old_items, n_fix - len(missing_i))])
        ft = ((tt[-1] + 1) if len(tt) else 0) + np.arange(n_fix)
        tu, ti, tt = (np.concatenate([tu, fu]), np.concatenate([ti, fi]),
                      np.concatenate([tt, ft]))
    n_new_rows = n_inters - n_old_inters
    nu, ni, nt = sample_inters(all_users, all_items, n_new_rows, n_old_inters)
    touch_new = (nu >= n_old_u) | (ni >= n_old_i)
    nu, ni, nt = nu[touch_new], ni[touch_new], nt[touch_new]
    seen_u = np.zeros(n_users, bool)
    seen_u[np.unique(tu)] = True
    seen_i = np.zeros(n_items, bool)
    seen_i[np.unique(ti)] = True
    ok = ((nu >= n_old_u) | seen_u[nu]) & ((ni >= n_old_i) | seen_i[ni])
    nu, ni, nt = nu[ok], ni[ok], nt[ok]

    def w(path, lines):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    u_vec = (U[:, :feat_dims] + feat_noise * rng.standard_normal((n_users, feat_dims))).round(4)
    i_vec = (I[:, :feat_dims] + feat_noise * rng.standard_normal((n_items, feat_dims))).round(4)

    def user_rows(ids):
        return [f"u{u}\t{u_age[u]}\tg{u_group[u]}\t" + " ".join(map(str, u_vec[u])) for u in ids]

    def item_rows(ids):
        return [f"i{i}\t{i_price[i]}\tc{i_cat[i]}\t" + " ".join(map(str, i_vec[i])) for i in ids]

    uh = "user_id:token\tage:float\tgroup:token\tuser_vector:float_seq"
    ih = "item_id:token\tprice:float\tcategory:token\titem_vector:float_seq"
    d = os.path.join(out, name)
    inter = ["user_id:token\titem_id:token\ttimestamp:float\tis_new:token"]
    inter += [f"u{u}\ti{i}\t{t}\t-1" for u, i, t in zip(tu, ti, tt)]
    inter += [f"u{u}\ti{i}\t{t}\t1" for u, i, t in zip(nu, ni, nt)]
    w(f"{d}/{name}.inter", inter)
    w(f"{d}/{name}.user", [uh] + user_rows(old_users))
    w(f"{d}/{name}.item", [ih] + item_rows(old_items))
    d2 = os.path.join(out, f"{name}_ind")
    w(f"{d2}/{name}_ind.train.inter", ["user_id:token\titem_id:token\ttimestamp:float"]
      + [f"u{u}\ti{i}\t{t}" for u, i, t in zip(tu, ti, tt)])
    w(f"{d2}/{name}_ind.empty.inter", ["user_id:token\titem_id:token\ttimestamp:float"])
    w(f"{d2}/{name}_ind.test_filt.inter", ["user_id:token\titem_id:token\ttimestamp:float"]
      + [f"u{u}\ti{i}\t{t}" for u, i, t in zip(nu, ni, nt)])
    w(f"{d2}/{name}_ind.user", [uh] + user_rows(all_users))
    w(f"{d2}/{name}_ind.item", [ih] + item_rows(all_items))
    return len(tu), len(nu)


class timed:
    """Wall seconds of every call of `owner.name` while in the block (the
    card synchronised after each), on `calls`."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        inner = self.inner = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            sync()
            self.calls.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)


def c_config(data_path, out):
    return {
        "model": "BPR", "dataset": "synth-c", "data_path": data_path, "load_col": {
            "inter": ["user_id", "item_id", "timestamp", "is_new"],
            "user": ["user_id", "age", "group"], "item": ["item_id", "price", "category"]},
        "epochs": 1, "learner": "sparse_adam", "learning_rate": SP_LR, "device_epoch": True,
        "inductive_mapper": "random", "add_oov_buckets": True,
        "n_user_oov_buckets": C_BUCKETS, "n_item_oov_buckets": C_BUCKETS,
        "train_oov": True, "oov_train_ratio": 0.3, "eval_args": {"mode": "full"},
        "eval_batch_size": C_EVAL_USERS * (C_ITEMS + 1), "checkpoint_dir": out,
        "metric_decimal_place": 12, "seed": SEED,
    }


C_CORPUS = {}  # phase C's files: their directory, rows and the write's seconds


def c_corpus():
    """Phase C's atomic-file family, written once a process (`main` writes
    it while the kernels build). → its directory."""
    if "data" not in C_CORPUS:
        data = os.path.join(CLI_DIR, "c-data")
        shutil.rmtree(data, ignore_errors=True)
        t0 = time.perf_counter()
        rows = generate(data, "synth-c", C_USERS, C_ITEMS, C_INTERS, C_NEW_RATIO, seed=C_SEED)
        C_CORPUS.update(data=data, rows=rows, wrote=time.perf_counter() - t0)
    return C_CORPUS["data"]


def cli_corpus():
    """Phase C: a written atomic-file family at 50,000 users x 100,000
    items x 1,000,000 rows through `quick_start.run` (BPR, D 64, sparse adam
    on the device epoch, the OOV sub-epoch, full-sort eval) and
    `perform_inductive_eval`, with kernels 6 and 1 counted around them and
    the wall time of each stage; then `--eval_only` with `use_fused_topk`
    True and False (perturbed hits off) agree to 1e-9. → (kernel 6 launches, kernel 1
    launches, stage seconds)."""
    out = cli_out("c")
    data = c_corpus()
    n_rows, n_new = C_CORPUS["rows"]
    log(f"phase C corpus: {n_rows} transductive + {n_new} inductive rows written in "
        f"{C_CORPUS['wrote']:.1f} s")
    stages = {}
    sparse_adam_rows_kernel.launches = 0
    topk_score.fused_topk_scores.launches = 0
    sync()
    with timed(dataset_module, "load_atomic_file") as t_load, \
            timed(quick_start, "create_dataset") as t_ds, \
            timed(quick_start, "data_preparation") as t_prep, \
            timed(Trainer, "_train_epoch") as t_epoch, \
            timed(Trainer, "evaluate") as t_test, \
            timed(EvalRunner, "evaluate") as t_eval:
        t0 = time.perf_counter()
        res = quick_start.run(config_dict=c_config(data, out))
        stages["run"] = time.perf_counter() - t0
    k6 = sparse_adam_rows_kernel.launches
    t0 = time.perf_counter()
    ind = perform_inductive_eval(res["dataset"], res["trainer"].saved_model_file,
                                 config=res["config"])
    sync()
    stages["inductive eval"] = time.perf_counter() - t0
    k1 = topk_score.fused_topk_scores.launches
    stages["atomic-file load (3 files)"] = sum(t_load.calls[:3])
    stages["Dataset build (load included)"] = t_ds.calls[0]
    stages["data_preparation"] = t_prep.calls[0]
    stages["epoch (device epoch)"] = t_epoch.calls[0]
    stages["OOV sub-epoch"] = t_epoch.calls[1]
    stages["valid eval"] = t_eval.calls[0]
    stages["test eval"] = t_test.calls[0]
    for k, v in stages.items():
        log(f"phase C wall: {k}: {v:.2f} s")
    trainer = res["trainer"]
    de = trainer._device_epochs
    require(any(d.sparse_impl == "pallas" for d in de.values()),
            "phase C: the device epoch did not take kernel 6")
    require(k6 > 0 and k1 > 0, f"phase C: kernel 6 launches {k6}, kernel 1 launches {k1}")
    finite_metrics(res["test_result"], "phase C test")
    require(tuple(ind) == SLICE_NAMES, "phase C slices")
    log(f"phase C: kernel 6 launches {k6} (training), kernel 1 launches {k1} (inductive eval)")
    log(f"[C test] {dict(res['test_result'])}")
    for s, r in ind.items():
        log(f"[C {s}] {dict(r)}")
    runs = {}
    for fused in (True, False):
        topk_score.fused_topk_scores.launches = 0
        t0 = time.perf_counter()
        # unperturbed ties (bucket-sharing new items score alike): both
        # paths then break them to the lowest index, while perturbed hits
        # draw one permutation a batch on the fused path and three on the
        # dense one. The first run writes the `save_dataset` pickle of the
        # training corpus and the second reads it (C_EVAL_CACHE)
        runs[fused] = cli_run.main([f"--eval_only={trainer.saved_model_file}",
                                    "--inductive_eval=True", f"--use_fused_topk={fused}",
                                    "--use_perturbed_hits=False",
                                    f"--save_dataset={C_EVAL_CACHE}"])
        n = topk_score.fused_topk_scores.launches
        log(f"phase C eval_only use_fused_topk={fused}: {time.perf_counter() - t0:.1f} s "
            f"(wall, corpus {'rebuilt' if fused or not C_EVAL_CACHE else 'from the pickle'}), "
            f"kernel 1 launches {n}")
        require((n > 0) == fused, f"phase C eval_only fused={fused}: {n} kernel 1 launches")
    agree(runs[True]["test_result"], runs[False]["test_result"], "phase C fused vs dense test")
    agree_slices(runs[True]["inductive_results"], runs[False]["inductive_results"],
                 "phase C fused vs dense slices", tol=1e-9)
    agree(res["test_result"], runs[False]["test_result"], "phase C eval_only vs the run")
    log("phase C: --eval_only fused == dense on test metrics and the 7 slices (1e-9)")
    return k6, k1, stages



# ------------------------------------------------- phase D, the embedders

# the embedders at the models' published widths: BPR at embedding_size 64
# (BPR.yaml), DHE at dhe_num_hashes 128 and dhe_layer_size 512
# (config/defaults.yaml:115-116), xDeepFM at xDeepFM.yaml. D1 is the
# paper's reproduce command (EXPERIMENTS.md:40-45: lsh, the *_vector
# columns, 200 buckets a side, OOV ratio 0.3, the inductive eval), cut to
# CLI_EPOCHS_A epochs as phase A is. Key files come from the seed, under
# build/ (without a file DHEHasher would draw random keys)
SYNTH_VEC_LOAD_COL = ("--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
                      "'user': ['user_id','age','group','user_vector'], "
                      "'item': ['item_id','price','category','item_vector']}")
EXPERIMENTS_FLAGS = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset",
                     SYNTH_VEC_LOAD_COL, "--inductive_embedder=lsh", "--add_oov_buckets=True",
                     "--n_user_oov_buckets=200", "--n_item_oov_buckets=200", "--train_oov=True",
                     "--oov_train_ratio=0.3", "--inductive_eval=True"]
D_EMBEDDERS = (("slsh", []), ("dnn", []), ("knn", []), ("dhe", []),
               ("fdhe", ["--dhe_num_hashes=32"]))  # EXPERIMENTS.md:20
D_KEYS = os.path.join("build", "hash_keys")
D_HASHES, D_LAYER, D_FEATS = 128, 512, 6
D_HASH_CHUNK, D_HASH_THREADS = 1024, 8
D_HASH_EVERY = 4       # D3: the numpy hasher checks every 4th chunk of ids, over the whole
                       # range (every chunk until phase N): a depth cut for the 750 s budget
D_LSH_STEPS = 8


def kernel_counts():
    """Every kernel wrapper's launch count (`ops/launches.py`)."""
    return launches.launch_counts()


def reset_kernel_counts():
    launches.reset_launch_counts()


def write_hash_keys(counts):
    """`<D_KEYS>/<n>.hashes` for each n: n SipHash keys drawn from the seed,
    hex-encoded, the reference's format."""
    os.makedirs(D_KEYS, exist_ok=True)
    for n in counts:
        rng = np.random.default_rng(SEED + n)
        with open(os.path.join(D_KEYS, f"{n}.hashes"), "w") as f:
            json.dump([rng.bytes(16).hex() for _ in range(n)], f)


def slices_finite(slices, what):
    """All 7 slices, each with finite metrics where it has rows (synth-ind's
    inductive test rows all touch a new user or item, so old_old has none);
    one line of them."""
    require(tuple(slices) == SLICE_NAMES, f"{what}: slices {list(slices)}")
    require(all(slices[name] for name in ("overall", "old_users", "new_users")),
            f"{what}: an empty user slice")
    for name, r in slices.items():
        if r:
            finite_metrics(r, f"{what} [{name}]")
    log(f"[{what}] recall@20 / ndcg@20 by slice: " + ", ".join(
        f"{name} {r['recall@20']:.4f} / {r['ndcg@20']:.4f}" if r else f"{name} (no rows)"
        for name, r in slices.items()))


def d1_embedders():
    """D1: the paper's reproduce command (lsh) through `python -m
    oovrec_tpu_torch.cli.run` in the shared CLI child on dataset/synth-ind, its
    `--eval_only` equal to the run to 1e-9 (the planes come back from the
    checkpoint); then the same command in this process through
    `cli.run.main` with slsh, dnn, knn, dhe and fdhe (32 hashes). Each run's
    test metrics and 7 slices finite, its wall logged. → {} (no count
    reset)."""
    write_hash_keys((32, D_HASHES))
    common = [f"--epochs={CLI_EPOCHS_A}", f"--hash_key_dir={D_KEYS}"]
    out = cli_out("d1-lsh")
    rc, lines, _, lsh_wall = cli_process([*EXPERIMENTS_FLAGS, *common, *cli_flags(out)])
    walls = {"lsh": lsh_wall}
    for line in lines:
        if "training [" in line or "test result" in line:
            log(f"  [D1 lsh] {line.split(' INFO ')[-1][:160]}")
    require(rc == 0, f"D1 lsh: rc {rc}: " + "\n".join(lines[-30:]))
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "D1 lsh test")
    slices_finite(res["inductive"], "D1 lsh")
    log(f"D1: python -m oovrec_tpu_torch.cli.run, EXPERIMENTS.md:40-45 (lsh, {CLI_EPOCHS_A} "
        f"epochs) rc 0 in {walls['lsh']:.1f} s (wall, in the shared CLI child, the corpus "
        f"included)")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'BPR-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "D1 lsh eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "D1 lsh eval_only slices",
                 tol=1e-9)
    log("D1: lsh --eval_only == the run on test metrics and the 7 slices (1e-9)")
    for emb, extra in D_EMBEDDERS:
        out = cli_out(f"d1-{emb}")
        argv = [a.replace("=lsh", f"={emb}") for a in EXPERIMENTS_FLAGS]
        sync()
        t0 = time.perf_counter()
        res = cli_run.main([*argv, *common, *cli_flags(out), *extra])
        sync()
        walls[emb] = time.perf_counter() - t0
        require(res["trainer"].model.spec.embedder == emb, f"D1 {emb}: the embedder")
        finite_metrics(res["test_result"], f"D1 {emb} test")
        slices_finite(res["inductive_results"], f"D1 {emb}")
        log(f"D1: cli.run.main with {emb} {' '.join(extra)}: {walls[emb]:.1f} s (wall)")
    return {}


def d2_ranking_lsh():
    """D2: the ranking track with lsh (the SKILL.md ranking command on
    xDeepFM, WideDeep not being ported) through `cli.run.main` on synth-ind,
    CLI_EPOCHS_B epochs, the CIN kernels counted. → {} (no count reset)."""
    out = cli_out("d2")
    argv = ["--model=xDeepFM", "--model_eval_type=ranking", *EXPERIMENTS_FLAGS[1:],
            "--numerical_features=['age','price']", f"--epochs={CLI_EPOCHS_B}", *cli_flags(out)]
    reset_cin_counts()
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(argv)
    sync()
    wall = time.perf_counter() - t0
    counts = cin_counts()
    require(res["trainer"].model.spec.embedder == "lsh", "D2: the embedder")
    require(counts["cin_layer_pooled"] > 0 and counts["cin_layer_pooled_bwd"] > 0,
            f"D2: the CIN kernels were not launched: {counts}")
    finite_metrics(res["test_result"], "D2 test")
    require(tuple(res["inductive_results"]) == SLICE_NAMES, "D2 slices")
    finite_metrics(res["inductive_results"]["overall"], "D2 overall slice")
    log(f"D2: cli.run.main (xDeepFM, lsh, synth-ind, {CLI_EPOCHS_B} epochs, uni250) {wall:.1f} s "
        f"(wall), CIN launches {counts}")
    log(f"[D2 test] {dict(res['test_result'])}")
    for name, r in res["inductive_results"].items():
        log(f"[D2 {name}] {dict(r)}")
    return {}


def hashes_match_host(codes, keys):
    """The card's DHE codes of ids 0..n-1 against the numpy hasher
    (`ops/siphash.py`), every D_HASH_EVERY-th chunk on D_HASH_THREADS
    threads. → (the number of chunks that differ, of those checked)."""
    from concurrent.futures import ThreadPoolExecutor

    got = codes.cpu().numpy()
    n = got.shape[0]

    def differs(a):
        ids = np.arange(a, min(a + D_HASH_CHUNK, n), dtype=np.uint64)
        want = (siphash24_batch(ids, keys) % np.uint64(MAX_HASH)).astype(np.float32)
        return not np.array_equal(got[a:a + len(ids)], want)

    starts = range(0, n, D_HASH_CHUNK * D_HASH_EVERY)
    with ThreadPoolExecutor(D_HASH_THREADS) as pool:
        return sum(pool.map(differs, starts)), len(starts)


def dhe_cfg(fused, n_items):
    c = serving_cfg(fused, n_items)
    c["dhe_on_device"] = True
    c["hash_key_dir"] = D_KEYS
    return c


def d3_fdhe_serving():
    """D3: fdhe serving at the serving phase's scale (1,000,000 items, D 64,
    128 hashes, towers of 512): synthetic unit features from the seed, the
    1M item ids hashed on the card (`dhe_codes_device`) equal to the numpy
    hasher bit for bit, the tower pass over all items, then the 7-slice eval
    fused vs dense to 1e-9. → kernel 1's launches on the fused run."""
    write_hash_keys((D_HASHES,))
    keys = DHEHasher(D_HASHES, D_KEYS).keys
    rng = np.random.default_rng(SEED + 90)
    n_users, n_items = N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS

    def unit_rows(n):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    state = {"user_feat_mat": unit_rows(n_users), "item_feat_mat": unit_rows(n_items),
             "dhe_keys": keys}
    spec = InductiveSpec(embedder="fdhe", dhe_num_hashes=D_HASHES, dhe_layer_size=D_LAYER,
                         embedding_size=D)
    model = BPR(N_OLD_USERS, N_OLD_ITEMS, D, spec, device=DEVICE,
                generator=torch_generator(SEED + 91, DEVICE), embedder_state=state)
    model.eval()
    ids = torch.arange(n_items, device=DEVICE)
    key_t = model.embedder_state["dhe_keys"]
    hash_ms = time_ms(lambda: dhe_codes_device(ids, key_t), [()], 5)
    t0 = time.perf_counter()
    bad, checked = hashes_match_host(dhe_codes_device(ids, key_t), keys)
    log(f"D3: {n_items} item ids x {D_HASHES} keys hashed on the card in {hash_ms:.3f} ms; "
        f"the numpy hasher's check took {time.perf_counter() - t0:.1f} s")
    require(bad == 0, f"D3: {bad} chunks of card hashes differ from the numpy hasher")
    with torch.no_grad():
        tower_ms = time_ms(lambda: model.all_item_embeddings(ids, item_dhe_ids=ids), [()], 3)
        item_e = model.all_item_embeddings(ids, item_dhe_ids=ids)
    require(item_e.shape == (n_items, D) and bool(torch.isfinite(item_e).all()),
            "D3: tower pass output")
    log(f"D3: card hashes == numpy hasher on {checked} chunks of {D_HASH_CHUNK} ids spread over "
        f"all {n_items} (bit for bit); the fdhe item "
        f"pass over {n_items} items (hashes, features, towers {D_HASHES}+{D_FEATS} -> {D_LAYER} "
        f"x3 -> {D}): {tower_ms:.3f} ms")
    del item_e
    t0 = time.perf_counter()
    ind_splits, _ = synth_interactions(model, None)
    log(f"D3 data: {len(ind_splits[1])} test positives, {time.perf_counter() - t0:.1f} s")
    launches = seven_slices_fused_vs_dense(model, None, ind_splits, dhe_cfg,
                                           what="D3 fdhe 7-slice eval")
    return {"fused_topk_scores": launches}


def lsh_device_epoch():
    """D4: BPR with lsh (SP_BUCKETS hash bits a side over synthetic unit
    features) on the device epoch with `learner: sparse_adam`: D_LSH_STEPS
    steps of SP_B rows plus the OOV sub-epoch under `sparse_update_impl`
    auto (kernel 6) and xla, the same bits. → the auto run's kernel 6
    launches."""
    rng = np.random.default_rng(SEED + 95)
    users, items = structured_pairs(rng, D_LSH_STEPS * SP_B)
    split = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [split], seed=SEED)
    loader = TrainBatcher(split, sampler, sparse_cfg("auto"), InputType.PAIRWISE)
    state = {}
    for side, n in (("user", SP_USERS), ("item", SP_ITEMS)):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        state[f"{side}_feat_mat"] = m / np.linalg.norm(m, axis=1, keepdims=True)
        state[f"{side}_planes"] = rng.standard_normal((SP_BUCKETS, D_FEATS)).astype(np.float32)
    spec = InductiveSpec(embedder="lsh", add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS)
    runs, launches, gathers = {}, {}, {}
    for impl in ("auto", "xla"):
        # every OOV step kept, so the sub-epoch surely runs lsh's flagged rows
        trainer = Trainer(sparse_cfg(impl, oov_train_ratio=1.0), BPR(
            SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
            generator=torch_generator(SEED + 40, DEVICE), embedder_state=state))
        sparse_adam_rows_kernel.launches = 0
        embed_grad.scatter_rows_kernel.launches = 0
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        launches[impl] = sparse_adam_rows_kernel.launches
        gathers[impl] = embed_grad.scatter_rows_kernel.launches
        des = list(trainer._device_epochs.values())
        require(len(des) == 2 and all(d.sparse_impl == ("xla" if impl == "xla" else "pallas")
                                      for d in des), f"D4 lsh {impl}: the sparse device epoch")
        require(trainer.oov_loss_dict and math.isfinite(trainer.oov_loss_dict[0]),
                f"D4 lsh {impl}: the OOV sub-epoch")
        runs[impl] = state_of(trainer)
        log(f"D4 lsh on the device epoch ({impl}): {D_LSH_STEPS} + {des[1].steps_run} OOV "
            f"steps in {wall:.2f} s (wall, set-up included), kernel 6 launches {launches[impl]}")
        del trainer, des
    same = [n for n in runs["auto"] if torch.equal(runs["auto"][n], runs["xla"][n])]
    require(len(same) == len(runs["auto"]), "D4 lsh: auto and xla differ")
    require(launches["auto"] > 0 and launches["xla"] == 0, f"D4 lsh: kernel 6 {launches}")
    # lsh reads its bucket table through a product and the IV rows as
    # slices of the gathered rows: no row gather has a backward here
    require(gathers["auto"] == 0, f"D4 lsh: gathers' backward launches {gathers}")
    log(f"D4 lsh: auto == xla bit for bit ({len(same)} parameters and moments)")
    return {"sparse_adam_rows_kernel": launches["auto"]}


# ---------------------------------------------------------------- phase E
#
# The paper's other three models at their published widths (the port's
# copies of oovrec_tpu/config/model/{WideDeep,DCNV2,DirectAU}.yaml):
# WideDeep (embedding 10, MLP 32/16/8, dropout 0.1), DCNv2 (embedding 16, 3
# cross layers, MLP 768/768 with BatchNorm, dropout 0.2, reg_weight 2; mixed:
# 4 experts of rank 128) and DirectAU (embedding 64, gamma 1).

E_EPOCHS_RANK = 2  # EXPERIMENTS.md:79 runs 8 epochs; cut as phase B is (3 until phase I)
E_EPOCHS_CLI = 1  # E2, E4 (2 until phase J)
E_BN_ROWS = 64
E_TAGS_VOCAB, E_TAGS_LEN, E_TAGS_STEPS = 1000, 16, 16
E_DAU_STEPS, E_DAU_B = 64, 2048
E_PREFETCH_STEPS = 32  # E3: steps an epoch of the prefetch timing (the whole training
                       # split's 96 until phase N): a depth cut for the 750 s budget
E_DCNV2 = (("stacked", []), ("parallel", ["--structure=parallel"]), ("mixed", ["--mixed=True"]),
           ("stacked-worker2", ["--worker=2"]))
E3_MODELS = (("WideDeep", "WideDeep", {}), ("DCNV2", "DCNV2", {}),
             ("DCNV2-mixed", "DCNV2", {"mixed": True}))


def published(model):
    """(the constructor's hyper-parameters from the model file, its
    embedding_size), as `cli/quick_start.py:build_model_and_state` takes
    them."""
    cfg = Config({"model": model})
    return quick_start.model_kwargs(cfg, get_model_class(model)), int(cfg["embedding_size"])


def bn_stats(model):
    """The BatchNorm running statistics of `model`, by state_dict name
    (every `BatchNorm` module's, whatever its name: MLPLayers'
    `BatchNorm_<j>`, NFM's `bn` and `mlp_bn_<i>`)."""
    return {f"{name}.{b}": getattr(m, b) for name, m in model.named_modules()
            if isinstance(m, BatchNorm) for b in ("mean", "var")}


def require_trained_stats(model, what):
    """DCNv2's running statistics moved off their initial values (mean 0,
    var 1) in every BatchNorm."""
    stats = bn_stats(model)
    require(len(stats) == 4, f"{what}: BatchNorm statistics {sorted(stats)}")
    for k, v in stats.items():
        start = 0.0 if k.endswith(".mean") else 1.0
        require(bool(torch.isfinite(v).all()) and float((v - start).abs().max()) > 1e-3,
                f"{what}: {k} did not move from {start}")


def value_slices_finite(slices, what):
    """The 7 value slices: RMSE finite in every slice with rows, AUC in
    the overall slice (a one-label slice's AUC is NaN); one line of them."""
    require(tuple(slices) == SLICE_NAMES, f"{what}: slices {list(slices)}")
    require(slices["overall"] and math.isfinite(slices["overall"]["auc"]),
            f"{what}: overall slice {slices['overall']}")
    for name, r in slices.items():
        if r:
            require(math.isfinite(r["rmse"]), f"{what} [{name}]: {r}")
    log(f"[{what}] auc / rmse by slice: " + ", ".join(
        f"{name} {r['auc']:.4f} / {r['rmse']:.4f}" if r else f"{name} (no rows)"
        for name, r in slices.items()))


def e1_ranking_track():
    """E1: EXPERIMENTS.md:79, the paper's ranking track (the lsh command of
    D1 with --model=WideDeep --model_eval_type=ranking), through `python -m
    oovrec_tpu_torch.cli.run` in the shared CLI child on dataset/synth-ind: the
    training loss falls, the 7 slices are finite, `--eval_only` reproduces
    them to 1e-9; then the same command through `cli.run.main` in this
    process, where the gathers' backward is counted. → {} (no reset)."""
    argv = ["--model=WideDeep", "--model_eval_type=ranking", *EXPERIMENTS_FLAGS[1:],
            f"--epochs={E_EPOCHS_RANK}"]
    out = cli_out("e1")
    rc, lines, _, wall = cli_process([*argv, *cli_flags(out)])
    losses = []
    for line in lines:
        if "training [" in line or "test result" in line:
            log(f"  [E1] {line.split(' INFO ')[-1][:160]}")
        if "train loss: " in line:
            losses.append(float(line.split("train loss: ")[1].split(",")[0].rstrip("]")))
    require(rc == 0, f"E1: rc {rc}: " + "\n".join(lines[-30:]))
    require(len(losses) == E_EPOCHS_RANK and all(map(math.isfinite, losses))
            and losses[-1] < losses[0], f"E1: epoch losses {losses}")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], "E1 test")
    value_slices_finite(res["inductive"], "E1 WideDeep lsh")
    log(f"E1: python -m oovrec_tpu_torch.cli.run, EXPERIMENTS.md:79 (WideDeep, lsh, "
        f"{E_EPOCHS_RANK} epochs) rc 0 in {wall:.1f} s (wall, in the shared CLI child, the "
        f"corpus included), epoch losses {[round(x, 4) for x in losses]}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'WideDeep-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "E1 eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "E1 eval_only slices", tol=1e-9)
    log("E1: --eval_only == the run on AUC, RMSE and the 7 slices (1e-9)")
    sync()
    t0 = time.perf_counter()
    res = cli_run.main([*argv, *cli_flags(cli_out("e1-in-process"))])
    sync()
    require(type(res["trainer"].model).__name__ == "WideDeep", "E1: the model")
    value_slices_finite(res["inductive_results"], "E1 in-process")
    log(f"E1: the same command through cli.run.main: {time.perf_counter() - t0:.1f} s (wall)")
    return {}


def e2_dcnv2():
    """E2: DCNv2 through `cli.run.main` on synth-ind, the random mapper and
    the OOV regime, E_EPOCHS_CLI epochs each: stacked, parallel and with
    mixed experts, each `--eval_only` equal to its run to 1e-9 (the running
    statistics come back from the checkpoint) and its statistics moved;
    stacked again at `--worker=2` equal to `worker: 0` to 1e-9. → {}."""
    base = ["--model=DCNV2", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV, f"--epochs={E_EPOCHS_CLI}"]
    runs = {}
    for tag, extra in E_DCNV2:
        out = cli_out(f"e2-{tag}")
        sync()
        t0 = time.perf_counter()
        res = runs[tag] = cli_run.main([*base, *extra, *cli_flags(out)])
        sync()
        wall = time.perf_counter() - t0
        model = res["trainer"].model
        require((model.structure, model.mixed) == ("parallel" if tag == "parallel" else "stacked",
                                                   tag == "mixed"), f"E2 {tag}: the model")
        require(res["config"]["worker"] == (2 if "worker" in tag else 0), f"E2 {tag}: worker")
        finite_metrics(res["test_result"], f"E2 {tag} test")
        value_slices_finite(res["inductive_results"], f"E2 DCNv2 {tag}")
        require_trained_stats(model, f"E2 {tag}")
        log(f"E2: cli.run.main (DCNv2 {tag}, {E_EPOCHS_CLI} epochs) {wall:.1f} s (wall), "
            f"test {dict(res['test_result'])}")
        if "worker" in tag:
            continue
        again = cli_run.main([f"--eval_only={res['trainer'].saved_model_file}",
                              "--inductive_eval=True"])
        agree(res["test_result"], again["test_result"], f"E2 {tag} eval_only test", tol=1e-9)
        agree_slices(res["inductive_results"], again["inductive_results"],
                     f"E2 {tag} eval_only slices", tol=1e-9)
    agree(runs["stacked"]["test_result"], runs["stacked-worker2"]["test_result"],
          "E2 worker 2 vs 0 test", tol=1e-9)
    agree_slices(runs["stacked"]["inductive_results"], runs["stacked-worker2"]["inductive_results"],
                 "E2 worker 2 vs 0 slices", tol=1e-9)
    log("E2: each --eval_only == its run (1e-9); the running statistics moved; stacked at "
        "--worker=2 == --worker=0 on the test metrics and the 7 slices (1e-9)")
    return {}


def e_ranking_model(name, seed, fields=None, **over):
    """A ranking model at its published widths over the CTR fields, with
    phase 4's random-mapper buckets."""
    kw, emb = published(name)
    kw.update(over)
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=100,
                         n_item_buckets=100, hash_function="3round")
    return get_model_class(name)(fields or ctr_fields(), embedding_size=emb, spec=spec,
                                 device=DEVICE, generator=torch_generator(seed, DEVICE), **kw)


def e3_train(tag, model, mapper, train, held, held_iv):
    """One model through `Trainer.fit` at the ranking cell's shape: one
    epoch + the frozen OOV sub-epoch, the loss falling, held-out AUC up, IV
    tables unchanged by the frozen sub-epoch, the 7 value slices; then the
    eval-mode BatchNorm check: E_BN_ROWS rows scored alone equal to the
    same rows inside a batch of CTR_B (1e-6)."""
    cfg = ctr_train_cfg()
    auc0 = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]
    trainer = eager_steps(Trainer(cfg, model))
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    iv_names = [n for n in trainer.params if n not in trainer.oov_params]
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        stats = {k: v.clone() for k, v in bn_stats(model).items()}
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["frozen" if frozen else "normal"] = {
            "losses": trainer.last_losses,
            "moved": {n for n in trainer.params if not torch.equal(before[n], trainer.params[n])},
            "stats_moved": all(not torch.equal(v, bn_stats(model)[k]) for k, v in stats.items())}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    steps = trainer._global_step
    normal, frozen = seen["normal"], seen["frozen"]
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(frozen["losses"]).all(),
            f"E3 {tag}: loss not finite")
    require(last < first, f"E3 {tag}: loss did not fall: {first} -> {last}")
    require(frozen["moved"] and not frozen["moved"] & set(iv_names),
            f"E3 {tag}: the frozen sub-epoch moved {sorted(frozen['moved'])}")
    if bn_stats(model):
        require(frozen["stats_moved"], f"E3 {tag}: the frozen sub-epoch left the statistics")
        require_trained_stats(model, f"E3 {tag}")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"E3 {tag}: {len(loader)} + {steps - len(loader)} frozen OOV steps of {CTR_B} rows, "
        f"{wall / steps * 1e3:.2f} ms per step (wall, host included); loss first tenth "
        f"{first:.5f} last tenth {last:.5f}; held-out IV AUC {auc0:.5f} -> {auc1:.5f}")
    require(auc1 > auc0, f"E3 {tag}: held-out AUC {auc0} -> {auc1}")
    ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
    sync()
    t0 = time.perf_counter()
    slices = ev.evaluate_model(PlainEvalBatcher(held, cfg))
    sync()
    log(f"E3 {tag}: 7-slice value eval over {len(held)} rows in {time.perf_counter() - t0:.2f} s")
    for name, r in slices.items():
        require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                f"E3 {tag} slice {name}: {dict(r)}")
    log(f"[E3 {tag}] " + ", ".join(f"{n} {r['auc']:.4f}" for n, r in slices.items()))
    # eval mode normalises with the running statistics: E_BN_ROWS rows
    # score the same alone (a batch of their own, tiled to the batch's
    # CTR_B rows, so that every product runs the same kernels and only
    # the statistics could tell the two apart) and inside a batch of CTR_B
    model.eval()
    db = to_device_batch(next(iter(PlainEvalBatcher(held_iv, cfg))), DEVICE)
    reps = len(db["weight"]) // E_BN_ROWS
    alone_b = {k: v[:E_BN_ROWS].repeat((reps,) + (1,) * (v.dim() - 1)) for k, v in db.items()}
    few = {k: v[:E_BN_ROWS] for k, v in db.items()}
    with torch.no_grad():
        whole = model.predict(db)[:E_BN_ROWS]
        err = float((model.predict(alone_b)[:E_BN_ROWS] - whole).abs().max())
        small = float((model.predict(few) - whole).abs().max())
        # in train mode (on a copy, without dropout) the batch's own
        # statistics decide
        gen, model.mlp_layers.generator = model.mlp_layers.generator, None
        trained = copy.deepcopy(model)
        model.mlp_layers.generator = gen
        trained.mlp_layers.dropout = 0.0
        gap = float((trained(alone_b, train=True) - trained(db, train=True))[:E_BN_ROWS]
                    .abs().max())
    del trained
    log(f"E3 {tag}: {E_BN_ROWS} rows alone (tiled to {len(db['weight'])}) vs inside a batch of "
        f"{len(db['weight'])}: eval mode max |diff| {err:.3e} (a batch of {E_BN_ROWS}, whose "
        f"products take other kernels: {small:.3e}); train mode (batch statistics) {gap:.3e}")
    require(err <= 1e-6, f"E3 {tag}: eval-mode scores depend on the batch: {err}")
    require(small <= 1e-5, f"E3 {tag}: eval-mode scores of a {E_BN_ROWS}-row batch: {small}")
    if bn_stats(model):
        require(gap > 1e-4, f"E3 {tag}: train-mode scores do not depend on the batch: {gap}")
    return normal


def e3_prefetch(train, models=("WideDeep", "DCNV2")):
    """The batch prefetch (`data/prefetch.py`, `worker` > 0) against the
    loop without it at the ranking cell's shape: one epoch of each model on
    the host path without the OOV regime, run with `worker` 0, 2, 2, 0 on
    one trainer after a warm-up epoch, and the loader's batches assembled
    alone, without training; each epoch over the first E_PREFETCH_STEPS
    batches of the training rows. → {model: {worker: [ms per step]},
    "alone": ms per batch}."""
    out = {}
    cfg = ctr_train_cfg(train_oov=False)
    train = rows_of(train, np.arange(len(train)) < E_PREFETCH_STEPS * CTR_B, N_CTR_OLD_USERS,
                    N_CTR_OLD_ITEMS)
    for i, name in enumerate(models):
        trainer = eager_steps(Trainer(cfg, e_ranking_model(name, SEED + 330 + i)))
        loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
        trainer._train_epoch(loader, 0)
        out[name] = {0: [], 2: []}
        for epoch, worker in enumerate((0, 2, 2, 0), 1):
            cfg["worker"] = worker
            sync()
            t0 = time.perf_counter()
            trainer._train_epoch(loader, epoch)
            sync()
            out[name][worker].append((time.perf_counter() - t0) * 1e3 / len(loader))
        cfg["worker"] = 0
        log(f"E3 prefetch, {name}: {len(loader)} steps of {CTR_B} rows, ms per step (wall, host "
            f"included) at worker 0: {', '.join(f'{t:.3f}' for t in out[name][0])}; at worker "
            f"2: {', '.join(f'{t:.3f}' for t in out[name][2])} (run in the order 0, 2, 2, 0)")
        del trainer
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    out["alone"] = (time.perf_counter() - t0) * 1e3 / n
    log(f"E3 prefetch: the loader alone assembles a batch of {CTR_B} rows in "
        f"{out['alone']:.3f} ms (host)")
    return out


def e3_tags_step_launches(fields, item_feat, train, seed):
    """WideDeep over `fields`, E_TAGS_STEPS steps of CTR_B rows without the
    OOV regime. → (losses, the gathers' backward launches)."""
    rows = rows_of(train, np.arange(len(train)) < E_TAGS_STEPS * CTR_B,
                   N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    rows = DatasetSplit(rows.inter, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS,
                        user_feat=rows.user_feat, item_feat=item_feat)
    cfg = ctr_train_cfg(train_oov=False)
    trainer = eager_steps(Trainer(cfg, e_ranking_model("WideDeep", seed, fields)))
    loader = TrainBatcher(rows, None, cfg, InputType.POINTWISE)
    require(len(loader) == E_TAGS_STEPS, f"E3 tags: {len(loader)} steps")
    embed_grad.scatter_rows_kernel.launches = 0
    trainer.fit(loader, None, saved=False)
    return trainer.last_losses, embed_grad.scatter_rows_kernel.launches


def e3_ranking(ind, mapper):
    """E3: WideDeep, DCNv2 stacked and DCNv2 mixed at the ranking cell's
    shape (phase 4's rows and fields), each through `e3_train`; the batch
    prefetch timed against the loop without it (`e3_prefetch`); then
    WideDeep with a token_seq item field `tags` (vocabulary E_TAGS_VOCAB,
    lengths 1..E_TAGS_LEN from the seed, mean pooling): its E_TAGS_STEPS
    steps lower the loss and launch the gathers' backward twice more a step
    (the field's table and its first-order twin) than without the field.
    → the gathers' backward launches (the tags runs reset the count: the
    launches of the fits before them are added)."""
    train, held, held_iv = ctr_splits(ind)
    embed_grad.scatter_rows_kernel.launches = 0
    for i, (tag, name, over) in enumerate(E3_MODELS):
        e3_train(tag, e_ranking_model(name, SEED + 300 + i, **over), mapper, train, held, held_iv)
    e3_prefetch(train)
    gathers = embed_grad.scatter_rows_kernel.launches
    rng = np.random.default_rng(SEED + 310)
    n_i = N_CTR_OLD_ITEMS + N_CTR_NEW_ITEMS
    lengths = rng.integers(1, E_TAGS_LEN + 1, n_i)
    tags = rng.integers(1, E_TAGS_VOCAB, (n_i, E_TAGS_LEN))
    tags[np.arange(E_TAGS_LEN)[None, :] >= lengths[:, None]] = 0
    tagged = dataclasses.replace(ctr_fields(), token_seq_names=("tags",),
                                 token_seq_dims=(E_TAGS_VOCAB,))
    sync()
    t0 = time.perf_counter()
    losses, with_tags = e3_tags_step_launches(tagged, dict(train.item_feat, tags=tags), train,
                                              SEED + 320)
    _, without = e3_tags_step_launches(ctr_fields(), train.item_feat, train, SEED + 320)
    sync()
    q = E_TAGS_STEPS // 4
    first, last = float(losses[:q].mean()), float(losses[-q:].mean())
    log(f"E3 tags: WideDeep with a token_seq field (vocabulary {E_TAGS_VOCAB}, mean length "
        f"{lengths.mean():.2f}), {E_TAGS_STEPS} steps: loss first quarter {first:.5f} last "
        f"{last:.5f}; gathers' backward launches {with_tags} with the field, {without} without "
        f"({time.perf_counter() - t0:.1f} s for both)")
    require(np.isfinite(losses).all() and last < first, f"E3 tags: losses {losses}")
    require(with_tags - without == 2 * E_TAGS_STEPS,
            f"E3 tags: gathers' backward launches {with_tags} with the field, {without} without")
    return {"scatter_rows_kernel": gathers + with_tags}


def e4_cfg(learner, **over):
    d = {"seed": SEED, "topk": TOPK, "train_batch_size": E_DAU_B, "learner": learner,
         "learning_rate": 1e-3, "epochs": 1, "train_oov": True, "oov_only_epoch": True,
         "oov_train_ratio": 0.2, "oov_feature_mask_rate": 0.2, "oov_freeze_embedding": True,
         "host_scan_steps": 1}
    d.update(over)
    return Config(d)


def e4_trainer(cfg, rows, steps=None):
    """A fresh DirectAU at its published widths (D 64, the serving scale's
    tables, random-mapper buckets) from one seed, its trainer under `cfg`,
    and a loader of `steps` pointwise steps over the first rows of `rows`
    with a sampler of its own (every run draws the same negatives). →
    (trainer, loader)."""
    steps = steps or E_DAU_STEPS
    kw, emb = published("DirectAU")
    spec = InductiveSpec(mapper="random", add_oov_buckets=True, n_user_buckets=100,
                         n_item_buckets=100, hash_function="3round")
    model = get_model_class("DirectAU")(N_OLD_USERS, N_OLD_ITEMS, emb, spec, device=DEVICE,
                                        generator=torch_generator(SEED + 401, DEVICE), **kw)
    n = steps * E_DAU_B // 2  # a pointwise batch: positives, then one negative each
    train = DatasetSplit({k: v[:n] for k, v in rows.items()}, N_OLD_USERS, N_OLD_ITEMS)
    loader = TrainBatcher(train, Sampler(["train"], [train], seed=SEED), cfg,
                          InputType.POINTWISE)
    trainer = eager_steps(Trainer(cfg, model))
    require(loader.mode == "pointwise" and len(loader) == steps
            and trainer._maybe_device_epoch(loader) is None,
            f"E4: the host path's {len(loader)} pointwise steps are not driven")
    return trainer, loader


def e4_directau():
    """E4: DirectAU at D 64 (DirectAU.yaml) over the serving scale, E_DAU_STEPS
    pointwise steps of E_DAU_B rows plus the frozen OOV sub-epoch through
    `Trainer.fit`, with adam and with `learner: sparse_adam` (the ID tables
    through kernel 6 in `Trainer._sparse_step`, two launches a normal step);
    the sparse run again with `sparse_update_impl: xla` (the plain
    write-back: the same bits), and COMPARE_STEPS steps of the row-sparse
    step against the dense lazy-Adam sweep (`sparse_update_impl: dense`)
    from the same weights; then the sparse-adam model served over the
    serving cell's corpus (1M items, B 256, 4 user batches): the 7 slices
    and the IV full sort fused == dense (1e-9); then DirectAU on synth-ind
    through `cli.run.main`, `--eval_only` to 1e-9. → the fused runs' top-k
    launches and the sparse run's kernel-6 launches."""
    rng = np.random.default_rng(SEED + 400)
    n_rows = E_DAU_STEPS * E_DAU_B // 2
    rows = {"user_id": rng.integers(1, N_OLD_USERS, n_rows),
            "item_id": rng.integers(1, N_OLD_ITEMS, n_rows)}
    k6 = 0
    for learner in ("adam", "sparse_adam"):
        trainer, loader = e4_trainer(e4_cfg(learner), rows)
        require(bool(trainer.sparse_tables) == (learner == "sparse_adam"),
                f"E4 {learner}: sparse tables {trainer.sparse_tables}")
        sparse_adam_rows_kernel.launches = 0
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        steps, k6 = trainer._global_step, sparse_adam_rows_kernel.launches
        moved = {n for n in before if not torch.equal(before[n], trainer.params[n])}
        loss, oov_loss = trainer.train_loss_dict[0], trainer.oov_loss_dict.get(0)
        log(f"E4 DirectAU {learner}: {len(loader)} + {steps - len(loader)} OOV steps of "
            f"{E_DAU_B} rows, {wall / steps * 1e3:.2f} ms per step (wall, host included), mean "
            f"loss {loss / len(loader):.5f}, kernel 6 launches {k6}")
        require(math.isfinite(loss) and oov_loss is not None and math.isfinite(oov_loss)
                and {"user_embedding.weight", "item_embedding.weight"} <= moved,
                f"E4 {learner}: training, moved {sorted(moved)}")
        require(k6 == (2 * len(loader) if learner == "sparse_adam" else 0),
                f"E4 {learner}: kernel 6 launches {k6} over {len(loader)} steps")
    model, sparse = trainer.model, state_of(trainer)
    del trainer, before
    # the plain write-back (xla) from the same seed: the same bits; the
    # comparison runs' gathers are not counted
    gathers = embed_grad.scatter_rows_kernel.launches
    other, loader = e4_trainer(e4_cfg("sparse_adam", sparse_update_impl="xla"), rows)
    other.fit(loader, None, saved=False)
    got = state_of(other)
    same = [n for n in sparse if torch.equal(sparse[n], got[n])]
    log(f"E4 DirectAU sparse_adam (xla): {len(same)} of {len(sparse)} parameters and moments "
        "equal the kernel-6 run bit for bit")
    require(len(same) == len(sparse), "E4: the xla run differs from the kernel-6 run")
    del other, got, sparse
    # the row-sparse step vs the dense lazy sweep over COMPARE_STEPS steps
    runs = [recorded_run(*e4_trainer(e4_cfg("sparse_adam", sparse_update_impl=impl,
                                            train_oov=False), rows, COMPARE_STEPS))
            for impl in ("auto", "dense")]
    compare_trajectories("E4 DirectAU row-sparse step (kernel 6) vs dense lazy-Adam sweep",
                         ("sparse", "dense"), runs[0][0], runs[1][0], runs[0][1], runs[1][1],
                         runs[0][2], runs[1][2])
    del runs
    embed_grad.scatter_rows_kernel.launches = gathers
    spec = model.spec
    mapper = RandomOOVMapper(spec, N_OLD_USERS, N_OLD_ITEMS, N_OLD_USERS + N_NEW_USERS,
                             N_OLD_ITEMS + N_NEW_ITEMS)
    mapper.set_eval()
    model.eval()
    t0 = time.perf_counter()
    ind_splits, iv_splits = synth_interactions(model, mapper)
    log(f"E4 serving data: {len(ind_splits[1])} test positives, "
        f"{time.perf_counter() - t0:.1f} s")
    k1 = seven_slices_fused_vs_dense(model, mapper, ind_splits, serving_cfg,
                                     what="E4 DirectAU 7-slice eval")
    k1 += full_sort_fused_vs_dense(model, iv_splits, what="E4 DirectAU full-sort eval")
    out = cli_out("e4")
    sync()
    t0 = time.perf_counter()
    res = cli_run.main(["--model=DirectAU", "--dataset=synth-ind", "--data_path=dataset",
                        SYNTH_LOAD_COL, *CLI_OOV, f"--epochs={E_EPOCHS_CLI}", *cli_flags(out)])
    sync()
    wall = time.perf_counter() - t0
    finite_metrics(res["test_result"], "E4 DirectAU test")
    slices_finite(res["inductive_results"], "E4 DirectAU synth-ind")
    again = cli_run.main([f"--eval_only={res['trainer'].saved_model_file}",
                          "--inductive_eval=True"])
    agree(res["test_result"], again["test_result"], "E4 eval_only test", tol=1e-9)
    agree_slices(res["inductive_results"], again["inductive_results"], "E4 eval_only slices",
                 tol=1e-9)
    log(f"E4: cli.run.main (DirectAU, synth-ind, {E_EPOCHS_CLI} epochs) {wall:.1f} s (wall); "
        "--eval_only == the run (1e-9)")
    return {"fused_topk_scores": k1, "sparse_adam_rows_kernel": k6}


# -------------------------------------------------------------------- main


# ---------------------------------------------------------------- phase F
#
# The device-resident and scanned paths: the plain and pointwise
# device epochs of the ranking models, DHE ids on the device epoch,
# `host_scan_steps`, the scanned eval, and the dense step replayed as a
# captured CUDA graph (train/cuda_graph.py) on each of them.

F_COMPARE_STEPS = 8    # graphed against eager steps, bit for bit (16 until phase K)
F_TIME_STEPS = 8       # steps a timed pass, eager and graphed in turns (16 until K)
F_BPR_STEPS = 16       # F3: steps of SP_B rows
F_SCAN_K = 64          # F4: host_scan_steps
F_SCAN_GROUPS = 2      # F4: groups an epoch in the grouping's timing (3 until phase J)
F_TRACE_STEPS = 16     # steps of a traced pass whose kernels are counted
F_UNI_N, F_UNI_ROWS = 100, 100_000  # F5: uni-N negatives, rows a batch
F_POINTWISE = {"distribution": "uniform", "sample_num": 1}


def f_batches(de, n):
    """The first n batches of `de`'s epoch 0, cloned."""
    out = []
    for _, batch in de.batches(0):
        out.append({k: v.clone() for k, v in batch.items()})
        if len(out) == n:
            break
    return out


def f_state(trainer):
    """Parameters, Adam moments, BatchNorm statistics and the count."""
    return {**state_of(trainer), **{f"bn:{k}": v.clone() for k, v in bn_stats(trainer.model).items()}}


def graph_vs_eager(make, what, steps=F_COMPARE_STEPS):
    """Two trainers from one seed (`make()` → (trainer, loader)): the same
    `steps` device-epoch batches through the captured graph (the first
    step is the warm-up, eager on a side stream; the others replays) and
    through the eager `_apply_step`. Losses, parameters, moments and
    BatchNorm statistics bit for bit; the kernel wrappers of the graphed
    run launched at the warm-up and the capture only, the eager run's at
    every step. → (graphed trainer, its device epoch, eager trainer, the
    batches)."""
    (a, loader), (b, _) = make(), make()
    de = a._maybe_device_epoch(loader)
    require(de is not None and not de.sparse_tables, f"{what}: the dense device epoch")
    batches = f_batches(de, steps)
    a.model.train()
    b.model.train()
    reset_kernel_counts()
    sync()
    la = torch.stack([de.train_step(x) for x in batches])
    sync()
    ca = kernel_counts()
    reset_kernel_counts()
    lb = torch.stack([b._apply_step(x) for x in batches])
    sync()
    cb = kernel_counts()
    g = a.step_graphs
    require(g.captures == 1 and g.replays == steps - 1, f"{what}: {g.captures} captures, "
            f"{g.replays} replays")
    require(a.opt_state.get("count") == b.opt_state.get("count"), f"{what}: Adam counts")
    sa, sb = f_state(a), f_state(b)
    differ = {n: float((sa[n] - sb[n]).abs().max()) for n in sa if not torch.equal(sa[n], sb[n])}
    log(f"{what}: {steps} steps graphed ({g.replays} replays) vs eager: losses "
        f"{'equal' if torch.equal(la, lb) else 'DIFFER'} ({float(la[0]):.6f} -> "
        f"{float(la[-1]):.6f}), {len(sa) - len(differ)} of {len(sa)} tensors equal bit for bit; "
        f"launches graphed {ca}, eager {cb}")
    require(torch.equal(la, lb) and not differ, f"{what}: graph vs eager differ {differ}")
    require(all(ca[k] * steps == 2 * cb[k] for k in cb),
            f"{what}: wrapper launches graphed {ca} (a warm-up and a capture) vs eager {cb} "
            f"({steps} steps)")
    return a, de, b, batches


def graph_trace_check(eager_counts, eager_trace, graph_counts, graph_trace, what):
    """The kernels a graphed pass ran, as its profiler trace shows them,
    against an eager pass over the same batches: the eager trace (where it
    was taken) has each kernel as often as its wrappers counted launches,
    the graphed trace has them as often as the eager wrappers, and the
    graphed pass called no wrapper (its steps were replays). → each
    wrapper's kernel launches in the graphed trace (the eager pass says
    which wrapper of a shared kernel ran)."""
    by_kernel = {k: 0 for k in graph_trace}
    users = {k: [] for k in graph_trace}
    for name, fn in launches.WRAPPERS.items():
        by_kernel[fn.kernel] += eager_counts[name]
        if eager_counts[name]:
            users[fn.kernel].append(name)
    log(f"{what}: kernels in the traces, eager {eager_trace}, graph {graph_trace}; wrapper "
        f"launches eager {eager_counts}, graph {graph_counts}")
    require(eager_trace in (None, by_kernel), f"{what}: eager trace {eager_trace} vs its "
            f"wrappers' launches {by_kernel}")
    require(graph_trace == by_kernel, f"{what}: graphed trace {graph_trace} vs the eager "
            f"wrappers' launches {by_kernel}")
    require(not any(graph_counts.values()), f"{what}: a replayed pass called wrappers "
            f"{graph_counts}")
    require(all(len(u) <= 1 for u in users.values()), f"{what}: wrappers sharing a kernel "
            f"both ran {users}")
    return {name: graph_trace[fn.kernel] if eager_counts[name] else 0
            for name, fn in launches.WRAPPERS.items()}


TRACE_TAKES = 3  # takes of a counted trace whose records were lost


def counted_trace(run, what):
    """`profiled(run, what)` with the counts of the wrappers `run` called;
    a trace that lost kernel records (`lost_records`) counts nothing and
    is taken again, `run` with it, up to TRACE_TAKES times. → wall ms,
    device busy ms, (the wrappers' launches, the trace's kernels)."""
    for take in range(1, TRACE_TAKES + 1):
        reset_kernel_counts()
        wall, busy = profiled(run, what, quiet=True, gathers=False)
        if not profiled.lost:
            return wall, busy, (kernel_counts(), profiled.kernels)
        log(f"{what}: take {take} of the trace lost the kernel records of {profiled.lost} "
            "launch calls")
    raise AssertionError(f"{what}: {TRACE_TAKES} takes of the trace lost kernel records")


F_TRACE = {}  # phase F part → each wrapper's kernel launches in its graphed traces


def add_trace(part, seen):
    F_TRACE[part] = {k: F_TRACE.get(part, {}).get(k, 0) + n for k, n in seen.items()}


def dead_capture_check(make, batch, what):
    """A trainer's captures, dropped in a reference cycle (the trainer and
    its `StepGraphs` hold each other), do not break a later trainer's
    capture. The collector is off until the second capture begins and then
    runs at every allocation, so the dropped graphs are freed before the
    capture (`StepGraphs` collects first) or inside it, which the capture
    refuses."""
    import gc

    a, _ = make()
    a.step_graphs.step(batch)
    require(a.step_graphs.captures == 1, f"{what}: no capture")
    threshold = gc.get_threshold()
    begin, end = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end

    def collecting_begin(self, *args, **kw):
        begin(self, *args, **kw)
        gc.set_threshold(1, 1, 1)
        gc.enable()

    def collecting_end(self, *args, **kw):
        gc.disable()
        gc.set_threshold(*threshold)
        end(self, *args, **kw)

    gc.disable()
    del a
    b, _ = make()
    torch.cuda.CUDAGraph.capture_begin = collecting_begin
    torch.cuda.CUDAGraph.capture_end = collecting_end
    b.step_graphs.step(batch)
    torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end = begin, end
    gc.enable()
    sync()
    require(b.step_graphs.captures == 1, f"{what}: no second capture")
    log(f"{what}: a dropped trainer's captures are collected before the next capture")


def graph_vs_eager_times(de, eager, batches, what, part):
    """Wall ms a step (host clock around a synchronised pass) of the
    graphed and the eager step on the same batches, in the order eager,
    graph, graph, eager; then one pass of each under the profiler: device
    ms a step, the device's busy share, and the kernels each trace shows
    (`graph_trace_check`, added to `part`'s in F_TRACE). → the numbers,
    also logged."""
    runs = {"eager": lambda: [eager._apply_step(x) for x in batches],
            "graph": lambda: [de.train_step(x) for x in batches]}
    n = len(batches)
    wall = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        sync()
        t0 = time.perf_counter()
        runs[name]()
        sync()
        wall[name].append((time.perf_counter() - t0) * 1e3 / n)
    out, seen = {}, {}
    for name in ("eager", "graph"):
        w, busy, seen[name] = counted_trace(runs[name], f"profile {n} {what} steps, {name}")
        out[name] = {"wall_ms": wall[name], "device_ms": busy / n,
                     "busy_pct": 100 * busy / max(w, 1e-9),
                     "sorts": sum(c for _, key, c in profiled.rows
                                  if any(k in key for k in SORT_KERNELS)),
                     "plan_builds": seen[name][0]["build_plan"]}
    add_trace(part, graph_trace_check(*seen["eager"], *seen["graph"], what))
    log(f"{what}, ms a step of {batches[0]['weight'].numel()} rows (wall, host included; "
        f"order eager, graph, graph, eager): eager "
        f"{', '.join(f'{t:.3f}' for t in wall['eager'])}, graph "
        f"{', '.join(f'{t:.3f}' for t in wall['graph'])}; device ms a step eager "
        f"{out['eager']['device_ms']:.3f} (busy {out['eager']['busy_pct']:.1f} %), graph "
        f"{out['graph']['device_ms']:.3f} (busy {out['graph']['busy_pct']:.1f} %)")
    F_TIMES[what] = out
    return out


F_TIMES = {}
# the kernels of a device-wide sort (`csrc/embed_grad.cu`: key making, cub's
# radix sort) and of a plan's build, counted in a step's trace
# (`graph_vs_eager_times`): a step that sorts fixed edges shows them
SORT_KERNELS = ("make_keys", "DeviceRadixSort", "plan_tables")


def f_epoch_times(de, what):
    """A whole device epoch after the fit, its batches assembled on the
    card and its dense steps replayed: wall ms a step (host clock around a
    synchronised epoch; no profiler: a whole epoch's events take it tens of
    seconds to sum on a slow host)."""
    sync()
    t0 = time.perf_counter()
    de.run(1)
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / de.n_steps
    F_TIMES[f"{what} epoch"] = {"wall_ms": wall}
    log(f"{what}: a device epoch of {de.n_steps} steps, {wall:.3f} ms a step (wall)")


def f_fit(trainer, loader, what, falls=True):
    """`Trainer.fit` for one epoch + the OOV sub-epoch where the config
    trains one (on the device epoch or the host path), each sub-epoch's
    losses and steps kept, both finite; the loss must fall where `falls`.
    → (normal, oov records, wall s)."""
    inner, seen = trainer._train_epoch, {}

    def watched(ldr, epoch_idx, oov_transform=None, keep_ratio=None, frozen=False):
        steps = trainer._global_step
        total = inner(ldr, epoch_idx, oov_transform, keep_ratio, frozen)
        seen["oov" if keep_ratio is not None else "normal"] = {
            "losses": trainer.last_losses, "steps": trainer._global_step - steps}
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    trainer._train_epoch = inner
    normal = seen["normal"]
    oov = seen.get("oov", {"losses": np.zeros(0), "steps": 0})
    losses = normal["losses"]
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    require(np.isfinite(losses).all() and np.isfinite(oov["losses"]).all(),
            f"{what}: loss not finite")
    log(f"{what}: {normal['steps']} steps + {oov['steps']} OOV steps in "
        f"{wall:.2f} s ({wall * 1e3 / trainer._global_step:.2f} ms a step, wall, host and set-up "
        f"included); loss first tenth {first:.5f} last tenth {last:.5f}")
    require(last < first or not falls, f"{what}: the loss did not fall ({first} -> {last})")
    return normal, oov, wall


def f1_xdeepfm_plain(ind):
    """F1: xDeepFM at the ranking cell's shape on the plain device epoch
    through `Trainer.fit` (`device_epoch: true`; the frozen OOV sub-epoch
    on the host path, as in JAX): the loss falls, held-out AUC rises, the
    CIN kernels 4 and 5 launched by their wrappers (3 + 3 a step) at the
    warm-ups and captures of the epoch's step and the OOV step, and the
    gathers' backward; then F_COMPARE_STEPS graphed steps against as many
    eager ones, bit for bit, and their times, the replayed kernels counted
    in the trace. → the fit's kernel launches."""
    train, _, held_iv = ctr_splits(ind)
    cfg = ctr_train_cfg(device_epoch=True)
    trainer = Trainer(cfg, build_ranking_model(SEED + 501))
    auc0 = EvalRunner(trainer.model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))["auc"]
    loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
    reset_kernel_counts()
    normal, oov, _ = f_fit(trainer, loader, "F1 xDeepFM, plain device epoch")
    counts = kernel_counts()
    de = trainer._device_epochs[(id(loader), False, False)]
    steps = trainer._global_step
    g = trainer.step_graphs
    require(de.mode == "plain" and normal["steps"] == de.n_steps == len(loader)
            and (id(loader), True, True) not in trainer._device_epochs,
            "F1: the plain device epoch, the OOV sub-epoch on the host path")
    # one capture for the epoch's step; the frozen OOV steps one for each
    # signature the simulator gives (user ids OOV, item ids, or both)
    require(2 <= g.captures <= 4 and g.replays == steps - g.captures,
            f"F1: {g.captures} captures, {g.replays} replays for {steps} steps")
    eager = 2 * g.captures  # each capture's warm-up step and the capture
    require(counts["cin_layer_pooled"] == 3 * eager and counts["cin_layer_pooled_bwd"] == 3 * eager
            and counts["scatter_rows_kernel"] > 0,
            f"F1: wrapper launches {counts} over {steps} steps, {eager} of them not replays")
    auc1 = trainer.evaluate(PlainEvalBatcher(held_iv, cfg), load_best_model=False)["auc"]
    log(f"F1: held-out IV AUC {auc0:.5f} before, {auc1:.5f} after; launches {counts}")
    require(auc1 > auc0, f"F1: held-out AUC {auc0} -> {auc1}")
    f_epoch_times(de, "F1 xDeepFM plain")
    del trainer, de

    def make():
        c = ctr_train_cfg(device_epoch=True, train_oov=False)
        return Trainer(c, build_ranking_model(SEED + 502)), TrainBatcher(
            train, None, c, InputType.POINTWISE)

    a, gde, b, batches = graph_vs_eager(make, "F1 xDeepFM")
    graph_vs_eager_times(gde, b, batches[:F_TIME_STEPS], "F1 xDeepFM plain", "F1")
    return counts


def f2_pointwise(ind):
    """F2: WideDeep and DCNv2 on the pointwise device epoch (uniform, one
    negative a row, 4,096 positives + 4,096 negatives a step) at the
    ranking cell's shape through `Trainer.fit`: the loss falls, DCNv2's
    BatchNorm statistics move; then graphed against eager steps, bit for
    bit, and their times. → the fits' kernel launches."""
    train, _, _ = ctr_splits(ind)
    sampler = Sampler(["train"], [train], seed=SEED)
    counts = {}
    for i, name in enumerate(("WideDeep", "DCNV2")):
        cfg = ctr_train_cfg(device_epoch=True, train_neg_sample_args=F_POINTWISE)
        model = e_ranking_model(name, SEED + 510 + i)
        trainer = Trainer(cfg, model)
        loader = TrainBatcher(train, sampler, cfg, InputType.POINTWISE)
        stats = {k: v.clone() for k, v in bn_stats(model).items()}
        reset_kernel_counts()
        f_fit(trainer, loader, f"F2 {name}, pointwise device epoch")
        counts = {k: counts.get(k, 0) + n for k, n in kernel_counts().items()}
        de = trainer._device_epochs[(id(loader), False, False)]
        require(de.mode == "pointwise" and de.times == 2 and de.B * 2 == CTR_B,
                f"F2 {name}: the pointwise device epoch")
        moved = [k for k, v in bn_stats(model).items() if not torch.equal(v, stats[k])]
        require(len(moved) == len(stats), f"F2 {name}: statistics moved {moved} of {list(stats)}")
        log(f"F2 {name}: {len(moved)} BatchNorm statistics moved")
        f_epoch_times(de, f"F2 {name} pointwise")
        del trainer, de

        def make(name=name, i=i):
            c = ctr_train_cfg(device_epoch=True, train_oov=False,
                              train_neg_sample_args=F_POINTWISE)
            return Trainer(c, e_ranking_model(name, SEED + 520 + i)), TrainBatcher(
                train, sampler, c, InputType.POINTWISE)

        a, gde, b, batches = graph_vs_eager(make, f"F2 {name}", steps=8)
        graph_vs_eager_times(gde, b, batches, f"F2 {name} pointwise", "F2")
        del a, gde, b, batches
    return counts


def f3_bpr_fdhe():
    """F3: BPR with fdhe (128 hashes, towers of 512, D 64) hashed on the
    card (`dhe_on_device`) on the pairwise device epoch with `learner:
    sparse_adam` (kernel 6, eager by rule) at the sparse phase's shape,
    the OOV sub-epoch included; one OOV batch's ids hashed on the card equal
    the host hasher's codes. Then BPR's dense step (`sparse_update_impl:
    dense`) graphed against eager at the same shape, and its times. → the
    fit's kernel launches."""
    write_hash_keys((D_HASHES,))
    keys = DHEHasher(D_HASHES, D_KEYS).keys
    rng = np.random.default_rng(SEED + 600)
    users, items = structured_pairs(rng, F_BPR_STEPS * SP_B)
    split = DatasetSplit({"user_id": users, "item_id": items}, SP_USERS, SP_ITEMS)
    sampler = Sampler(["train"], [split], seed=SEED)
    state = {"dhe_keys": keys}
    for side, n in (("user", SP_USERS), ("item", SP_ITEMS)):
        m = rng.standard_normal((n, D_FEATS)).astype(np.float32)
        state[f"{side}_feat_mat"] = m / np.linalg.norm(m, axis=1, keepdims=True)
    spec = InductiveSpec(embedder="fdhe", dhe_num_hashes=D_HASHES, dhe_layer_size=D_LAYER,
                         embedding_size=D, add_oov_buckets=True, n_user_buckets=SP_BUCKETS,
                         n_item_buckets=SP_BUCKETS)
    cfg = sparse_cfg("auto", dhe_on_device=True, hash_key_dir=D_KEYS, oov_train_ratio=1.0)
    trainer = Trainer(cfg, BPR(SP_USERS, SP_ITEMS, D, spec, device=DEVICE,
                               generator=torch_generator(SEED + 601, DEVICE),
                               embedder_state=state))
    require(trainer.dhe_hasher is not None and trainer.dhe_hasher.on_device, "F3: hasher")
    loader = TrainBatcher(split, sampler, cfg, InputType.PAIRWISE)
    reset_kernel_counts()
    normal, oov, _ = f_fit(trainer, loader, "F3 BPR fdhe, pairwise device epoch, sparse adam",
                           falls=False)
    counts = kernel_counts()
    des = trainer._device_epochs
    de, ode = des[(id(loader), False, False)], des[(id(loader), True, False)]
    ran = de.steps_run + ode.steps_run
    require(de.sparse_impl == ode.sparse_impl == "pallas" and de.dhe_pad == spec.prime_pad,
            "F3: the sparse device epochs with DHE ids")
    require(counts["sparse_adam_rows_kernel"] == 2 * ran,
            f"F3: kernel 6 launches {counts} for {ran} steps")
    _, batch = next(ode.batches(1))
    host = {k: v.cpu().numpy() for k, v in batch.items() if not k.endswith("_dhe_id")}
    hasher = DHEHasher(D_HASHES, D_KEYS, keys_u64=keys)
    key_t = trainer.model.embedder_state["dhe_keys"]
    flagged = 0
    for f in ("user_id", "item_id", "neg_item_id"):
        hasher.annotate_batch(host, f, spec.prime_pad, padded_when_flagged=True)
        got = dhe_codes_device(batch[f + "_dhe_id"], key_t).cpu().numpy()
        require(np.array_equal(got, host[f + "_dhe"]), f"F3: {f} codes differ from the host's")
        flagged += int((host.get(f + "_oov", np.zeros(1)) > 0).sum())
    require(flagged > 0, "F3: no flagged id in the OOV batch")
    log(f"F3: one OOV batch's user, item and negative ids hashed on the card == the host "
        f"hasher ({flagged} flagged ids padded by prime_pad); launches {counts}")
    del trainer, des, de, ode

    def make():
        c = sparse_cfg("dense", train_oov=False)
        return Trainer(c, sparse_model()), TrainBatcher(split, sampler, c, InputType.PAIRWISE)

    a, gde, b, batches = graph_vs_eager(make, "F3 BPR dense step", steps=8)
    graph_vs_eager_times(gde, b, batches, "F3 BPR dense lazy-Adam step", "F3")
    del a, gde, b
    dead_capture_check(make, batches[0], "F3 BPR dense step")
    return counts


def f4_host_scan(ind):
    """F4: xDeepFM on the host path, one epoch at `host_scan_steps`
    F_SCAN_K (one group stacked and copied at once; the remainder per step)
    against 1, every step but the first replayed from the captured graph:
    the same losses and weights bit for bit. Then what the grouping adds
    beyond the graph (`f4_grouping`). → the K run's kernel launches."""
    train, _, _ = ctr_splits(ind)
    runs = {}
    for k in (F_SCAN_K, 1):
        reset_kernel_counts()
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 530))
        loader = TrainBatcher(train, None, cfg, InputType.POINTWISE)
        require(trainer._host_scan_k(loader) == k, f"F4: K {trainer._host_scan_k(loader)}")
        sync()
        t0 = time.perf_counter()
        trainer.fit(loader, None, saved=False)
        sync()
        wall = time.perf_counter() - t0
        g = trainer.step_graphs
        runs[k] = (trainer.last_losses, f_state(trainer), wall, g.replays, kernel_counts())
        log(f"F4: host_scan_steps {k}: {len(loader)} steps in {wall:.2f} s "
            f"({wall * 1e3 / len(loader):.2f} ms a step, wall, the capture included), "
            f"{g.captures} capture, {g.replays} replays")
        require(g.captures == 1 and g.replays == len(loader) - 1,
                f"F4 K {k}: {g.captures} captures, {g.replays} replays")
        del trainer
    (lk, sk, _, _, counts), (l1, s1, _, _, _) = runs[F_SCAN_K], runs[1]
    same = [n for n in s1 if torch.equal(sk[n], s1[n])]
    log(f"F4: K {F_SCAN_K} vs 1: losses {'equal' if np.array_equal(lk, l1) else 'DIFFER'}, "
        f"{len(same)} of {len(s1)} tensors equal bit for bit")
    require(np.array_equal(lk, l1) and len(same) == len(s1), "F4: the trajectories differ")
    f4_grouping(train)
    return counts


def f4_grouping(train):
    """What `host_scan_steps` adds beyond the graph, on an epoch of
    F_SCAN_GROUPS groups of F_SCAN_K batches (the rows of `train` repeated):
    wall ms a step at K = F_SCAN_K (a group stacked, one copy, replays), at
    K = 1 (a copy a batch, replays) and at K = 1 with the steps eager
    (`eager_steps`, the uncaptured step), the graphed trainers after
    an untimed epoch that captures, in the order K, 1 graphed, 1 eager, 1
    eager, 1 graphed, K. Then the replayed kernels: an epoch of
    F_TRACE_STEPS batches at K = F_TRACE_STEPS (one group) and at K = 1
    under the profiler (a trace of 64 steps or more has lost kernel
    records), counted in the trace against an eager epoch's wrappers over
    the same batches, with the device's busy share."""
    n_rows = len(train.inter[train.uid_field])
    pick = np.arange(F_SCAN_GROUPS * F_SCAN_K * CTR_B) % n_rows
    rows = DatasetSplit({k: v[pick] for k, v in train.inter.items()}, N_CTR_OLD_USERS,
                        N_CTR_OLD_ITEMS, user_feat=train.user_feat, item_feat=train.item_feat)
    steps = F_SCAN_GROUPS * F_SCAN_K
    order = (f"K {F_SCAN_K}", "1 graphed", "1 eager")
    out = {}
    for name, k in zip(order, (F_SCAN_K, 1, 1)):
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 531))
        loader = TrainBatcher(rows, None, cfg, InputType.POINTWISE)
        require(len(loader) == steps, f"F4: {len(loader)} batches")
        if name == "1 eager":
            eager_steps(trainer)
        else:
            trainer._train_epoch(loader, 0)
        out[name] = {"trainer": trainer, "loader": loader, "wall_ms": []}
    for i, name in enumerate(order + order[::-1]):
        sync()
        t0 = time.perf_counter()
        out[name]["trainer"]._train_epoch(out[name]["loader"], 1 + i)
        sync()
        out[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3 / steps)
    for rec in out.values():
        del rec["trainer"], rec["loader"]
    short = rows_of(rows, np.arange(len(pick)) < F_TRACE_STEPS * CTR_B, N_CTR_OLD_USERS,
                    N_CTR_OLD_ITEMS)
    seen = {}
    for name, k in (("1 eager", 1), (f"K {F_SCAN_K}", F_TRACE_STEPS), ("1 graphed", 1)):
        cfg = ctr_train_cfg(train_oov=False, host_scan_steps=k)
        trainer = Trainer(cfg, build_ranking_model(SEED + 532))
        loader = TrainBatcher(short, None, cfg, InputType.POINTWISE)
        require(len(loader) == F_TRACE_STEPS, f"F4: {len(loader)} batches")
        if name == "1 eager":
            eager_steps(trainer)
            reset_kernel_counts()
            trainer._train_epoch(loader, 0)
            seen[name] = (kernel_counts(), None)
            continue
        trainer._train_epoch(loader, 0)  # the capture
        w, busy, seen[name] = counted_trace(
            lambda: trainer._train_epoch(loader, 1),
            f"profile F4 {name}: an epoch of {F_TRACE_STEPS} steps (K {k})")
        out[name].update(device_ms=busy / F_TRACE_STEPS, busy_pct=100 * busy / max(w, 1e-9))
    replayed = {name: graph_trace_check(*seen["1 eager"], *seen[name], f"F4 {name}")
                for name in order[:2]}
    add_trace("F4", replayed[order[0]])
    log(f"F4 host path, ms a step of {CTR_B} rows over {steps} steps (wall, host included; "
        f"order {', '.join(order + order[::-1])}): " + "; ".join(
            f"{name} {', '.join(f'{t:.3f}' for t in out[name]['wall_ms'])}" + (
                f" (device {out[name]['device_ms']:.3f}, busy {out[name]['busy_pct']:.1f} % "
                f"over {F_TRACE_STEPS} steps)" if "busy_pct" in out[name] else "")
            for name in order))
    F_TIMES["F4 host path"] = out


def f5_scanned_eval():
    """F5: phase 3's BPR over its 900,000 IV items: the scanned full sort
    (kernel 1, by the per-batch rule) against the per-batch one, and the
    scanned uni-N eval against the per-batch one, the same metrics; each
    pass run in the order scanned, per batch, per batch, scanned after an
    untimed warm-up pass, with its wall and host syncs. → kernel 1's
    launches in the scanned full sort."""
    import warnings

    model, iv_splits = SERVING["model"], SERVING["iv_splits"]
    out = {}

    def run(what, make_loader, scanned):
        cfg = serving_cfg(True, N_OLD_ITEMS, device_eval=scanned)
        ldr = make_loader(cfg)
        runner = EvalRunner(model, cfg)
        topk_score.fused_topk_scores.launches = 0
        sync()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            result = runner.evaluate(ldr)
            sync()
            wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        n = topk_score.fused_topk_scores.launches
        log(f"F5 {what} {'scanned' if scanned else 'per batch'}: {len(ldr)} batches in "
            f"{wall * 1e3:.1f} ms, {syncs} host syncs, kernel 1 launches {n}")
        rec = out.setdefault((what, scanned), {"ms": [], "syncs": syncs, "launches": n})
        rec["ms"].append(wall * 1e3)
        return result, n

    def neg_loader(cfg):
        train, test = iv_splits
        sampler = Sampler(["train", "test"], [train, test], seed=SEED)
        return NegSampleEvalBatcher(test, sampler, cfg, "test", {"sample_num": F_UNI_N},
                                    batch_size=F_UNI_ROWS)

    results = {}
    for what, make_loader in (("full sort", lambda c: loader(iv_splits, c)),
                              (f"uni{F_UNI_N}", neg_loader)):
        run(what, make_loader, True)  # warm-up: the allocator, the libraries
        out.clear()
        for scanned in (True, False, False, True):
            result = run(what, make_loader, scanned)
            first = results.setdefault((what, scanned), result)
            agree(result[0], first[0], f"F5 {what} repeat", tol=1e-12)
        agree(results[(what, True)][0], results[(what, False)][0], f"F5 {what} scanned vs per "
              "batch", tol=1e-12)
        log(f"F5 {what}: scanned == per batch {dict(results[(what, True)][0])}")
        F_TIMES[f"F5 {what}"] = {("scanned" if s else "per batch"): v
                                 for (w, s), v in out.items() if w == what}
    k1 = results[("full sort", True)][1]
    require(k1 > 0 and k1 == results[("full sort", False)][1], f"F5: kernel 1 launches {k1}")
    return {"fused_topk_scores": k1}


# ---------------------------------------------------------------- phase G

G_STEPS = 8            # G1: graphed against eager steps; kernel against plain
                       # (16 until phase K)
# G1: the learners at the ranking cell's shape. rmsprop from its zero
# state, with no bias correction, first moves each element by about
# lr / sqrt(0.1), 3.16 times Adam's lr, and its sign-like steps carry
# rounding-level gradient differences between the kernel and slab paths
# into the weights: at 1e-3 its 16-step comparison differed by 2.4e-5 in
# loss (PERF.md, phase G). At 3e-4 its steps are Adam's at 1e-3, the size the
# comparison's bounds were set at
G_RULES = (
    ("adagrad", {"learner": "adagrad", "learning_rate": 1e-2}),
    ("rmsprop", {"learner": "rmsprop", "learning_rate": 3e-4}),
    ("adam-bf16", {"optimizer_mu_dtype": "bfloat16"}),
    ("adam-f32", {}),
)
G_BPR_STEPS, G_CANDIDATES = 32, (4, 16)  # G2: host steps of BPR_TRAIN_B rows
G_ZOO = ("LR", "FM", "DeepFM", "FFM")   # G4, at their YAML widths
G_ZOO_STEPS = 4       # G4: graphed against eager steps (8 until phase I)
G_FIXTURE = os.path.join("tests", "assets", "jax_checkpoints", "BPR-synth-ind.ckpt")
G_TIMES = {}


def g_times(what):
    """Phase G's entry of F_TIMES (`graph_vs_eager_times` writes there)."""
    G_TIMES[what] = F_TIMES.pop(what)
    return G_TIMES[what]


def g1_learners(ind):
    """G1: xDeepFM at `xDeepFM.yaml` widths, 8,192 rows a step, under
    adagrad, rmsprop and adam with bf16 first moments (and f32, to compare
    on this card): G_STEPS graphed steps == G_STEPS eager ones bit for bit
    (moments and sums included) on the plain device epoch, then eager vs
    graphed wall and device ms a step; the CIN kernels against the slab
    path over G_STEPS steps under the same rule (losses 1e-5, parameters
    1e-4), the loss falling. → the kernel runs' launches."""
    train, _, _ = ctr_splits(ind)
    counts = {}
    for i, (rule, over) in enumerate(G_RULES):
        def make(over=over, i=i):
            c = ctr_train_cfg(device_epoch=True, train_oov=False, **over)
            return Trainer(c, build_ranking_model(SEED + 610 + i)), TrainBatcher(
                train, None, c, InputType.POINTWISE)

        a, gde, b, batches = graph_vs_eager(make, f"G1 xDeepFM {rule}", steps=G_STEPS)
        if "optimizer_mu_dtype" in over:
            require(all(t.dtype == torch.bfloat16 for t in a.opt_state["mu"].values()),
                    "G1: bf16 first moments")
        graph_vs_eager_times(gde, b, batches, f"G1 xDeepFM {rule}", "G1")
        g_times(f"G1 xDeepFM {rule}")
        del a, gde, b, batches
        if rule == "adam-f32":
            continue  # phase 5 holds adam's kernel path
        reset_kernel_counts()
        # phase 5's model and rows, where the comparison's bounds were set:
        # how many elements cross them depends on the initial weights, with
        # f32 moments as with bf16 ones (PERF.md, phase G)
        model, run, wall, wall_plain, _, _, losses = kernel_vs_plain_training(
            train, G_STEPS, **over)
        # the CIN counts are the kernel run's (the slab run resets them)
        counts = {k: counts.get(k, 0) + n for k, n in {**kernel_counts(), **run}.items()}
        del model
        g_losses(losses, f"G1 {rule} on the kernels", falls=True)
        log(f"G1 {rule}: {G_STEPS} eager steps kernel {wall * 1e3 / G_STEPS:.2f} ms a step, "
            f"slab {wall_plain * 1e3 / G_STEPS:.2f} (wall)")
    bf16, f32 = G_TIMES["G1 xDeepFM adam-bf16"], G_TIMES["G1 xDeepFM adam-f32"]
    log(f"G1 adam bf16 vs f32 first moments, graphed: device ms a step "
        f"{bf16['graph']['device_ms']:.3f} vs {f32['graph']['device_ms']:.3f}, wall "
        f"{np.mean(bf16['graph']['wall_ms']):.3f} vs {np.mean(f32['graph']['wall_ms']):.3f}")
    return counts


def g_losses(losses, what, falls=False):
    """Finite losses, falling from the first 4 steps to the last 4 where
    `falls`; logged."""
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    log(f"{what}: loss first 4 steps {first:.5f}, last 4 {last:.5f}")
    require(np.isfinite(losses).all(), f"{what}: loss not finite")
    require(last < first or not falls, f"{what}: the loss did not fall")


def g2_dynamic():
    """G2: BPR at D 64 over the serving corpus (900,000 IV items) on the
    host path, steps of 2,048 rows, one negative a row: without dynamic
    negatives and with 4 and 16 candidates a slot, each through
    `Trainer.fit` (its first step captures the graph), then one more epoch
    timed: ms a step and the scorer's share of it; the picks == the argmax
    of a plain f64 scorer over the same candidates (near-ties excepted and
    counted); then the 7-slice eval (kernel 1) on the trained weights,
    fused == dense. → the part's launches of kernel 1."""
    rng = np.random.default_rng(SEED + 700)
    n_rows = G_BPR_STEPS * BPR_TRAIN_B
    train = DatasetSplit({"user_id": rng.integers(1, N_OLD_USERS, n_rows),
                          "item_id": rng.integers(1, N_OLD_ITEMS, n_rows)},
                         N_OLD_USERS, N_OLD_ITEMS)
    walls, model, trainer, loader = {}, None, None, None
    for cand in (None,) + G_CANDIDATES:
        nsa = {"distribution": "uniform", "sample_num": 1}
        if cand:
            nsa.update(dynamic=True, candidate_num=cand)
        cfg = Config({"seed": SEED, "topk": TOPK, "train_batch_size": BPR_TRAIN_B,
                      "learner": "adam", "learning_rate": 1e-3, "epochs": 1,
                      "train_oov": False, "device_epoch": False, "host_scan_steps": 1,
                      "train_neg_sample_args": nsa})
        del model, trainer, loader
        model = build_model()
        trainer = Trainer(cfg, model)
        loader = TrainBatcher(train, Sampler(["train"], [train], seed=SEED), cfg,
                              InputType.PAIRWISE)
        require(loader.dynamic == bool(cand) and trainer._maybe_device_epoch(loader) is None
                and trainer._host_scan_k(loader) == 1, "G2: the dynamic host path")
        score, spent = trainer._score_candidates, []

        def timed(users, items, score=score, spent=spent):
            sync()
            t0 = time.perf_counter()
            out = score(users, items)
            spent.append(time.perf_counter() - t0)
            return out

        trainer._score_candidates = timed
        trainer.fit(loader, None, saved=False)
        del spent[:]
        sync()
        t0 = time.perf_counter()
        trainer._train_epoch(loader, 1)
        sync()
        wall = time.perf_counter() - t0
        steps = len(trainer.last_losses)
        require(steps == G_BPR_STEPS and len(spent) == (steps if cand else 0)
                and trainer.step_graphs.captures == (1 if DEVICE == "cuda" else 0),
                f"G2: {steps} steps, {len(spent)} scorer calls")
        g_losses(trainer.last_losses, f"G2 BPR candidates {cand}")
        walls[cand] = {"ms_a_step": wall * 1e3 / steps,
                       "scorer_ms_a_step": sum(spent) * 1e3 / steps,
                       "scorer_share_pct": 100 * sum(spent) / wall}
        log(f"G2 BPR, {BPR_TRAIN_B} rows a step, candidates {cand}: "
            f"{walls[cand]['ms_a_step']:.2f} ms a step (wall, an epoch after the fit), scorer "
            f"{walls[cand]['scorer_ms_a_step']:.2f} ms ({walls[cand]['scorer_share_pct']:.1f} %)")
    G_TIMES["G2 BPR dynamic"] = walls
    # the picks of the last loader (16 candidates) against a plain scorer
    drawn, draw = [], loader.sampler.sample_negatives

    def keep(*args):
        out = draw(*args)
        drawn.append(out)
        return out

    loader.sampler.sample_negatives = keep
    users = train.inter["user_id"][:BPR_TRAIN_B]
    picks = loader._sample_negs(users)[:, 0]
    loader.sampler.sample_negatives = draw
    cand = torch.from_numpy(drawn[0]).to(DEVICE)
    with torch.no_grad():
        u = model.user_embedding.weight.double()[torch.from_numpy(users).to(DEVICE)]
        s = (u[:, None, :] * model.item_embedding.weight.double()[cand]).sum(-1)
    top2 = s.topk(2, dim=1).values
    plain = cand.gather(1, s.argmax(1, keepdim=True))[:, 0].cpu().numpy()
    near = ((top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs()).cpu().numpy()
    same_item = (cand == torch.from_numpy(picks).to(DEVICE)[:, None]).sum(1).cpu().numpy() > 1
    differ = picks != plain
    log(f"G2 picks of {len(users)} slots of {G_CANDIDATES[-1]} candidates: "
        f"{int(differ.sum())} differ from the plain f64 argmax, {int(near.sum())} near-ties")
    require(not (differ & ~near & ~same_item).any(), "G2: picks differ from the plain argmax")
    mapper = RandomOOVMapper(model.spec, N_OLD_USERS, N_OLD_ITEMS,
                             N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS)
    mapper.set_eval()
    ind_splits, _ = synth_interactions(model, mapper)
    k1 = seven_slices_fused_vs_dense(model, mapper, ind_splits, serving_cfg,
                                     what="G2 BPR (16 candidates) inductive eval")
    return {"fused_topk_scores": k1}


def reference_layout(model):
    """The port model's weights under the reference's (RecBole's) state_dict
    names, as `utils/torch_import.py` maps them back (BPR, xDeepFM)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if ".embedder_state." not in k and not k.startswith("embedder_state.")}
    if isinstance(model, BPR):
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith("field_embedding."):
            k = k[len("field_embedding."):]
        elif k.startswith("first_order_linear.fo."):
            k = "first_order_linear." + k[len("first_order_linear.fo."):]
        m = re.match(r"conv1d_(\d+)\.(kernel|bias)$", k)
        if m:
            i, leaf = m.groups()
            out[f"conv1d_list.{i}.weight" if leaf == "kernel" else k.replace(
                f"conv1d_{i}", f"conv1d_list.{i}")] = v.T[:, :, None] if leaf == "kernel" else v
            continue
        m = re.match(r"mlp_layers\.Dense_(\d+)\.(weight|bias)$", k)
        if m:
            out[f"mlp_layers.mlp_layers.{3 * int(m.group(1)) + 1}.{m.group(2)}"] = v
            continue
        if k.endswith("embedding_table.weight"):
            k = k[:-len("weight")] + "embedding.weight"
        out[k] = v
    return out


def cli_model(argv, seed):
    """The model `cli.run` builds for `argv`, its weights from `seed`."""
    args = cli_run.merge_dataset_config(cli_run.apply_paper_protocol(
        cli_run.parse_cli_args(argv)))
    args["seed"], args["device"] = seed, DEVICE
    config = Config(args, model=args["model"], dataset=args["dataset"])
    return quick_start.build_model_and_state(config, create_dataset(config))


def g3_import(name, argv, subprocess_run):
    """A reference `.pth` of `name` in RecBole's key names (this model's
    weights from another seed) seeds `cli.run` (`import_torch_checkpoint`):
    the import gives the model the file's weights bit for bit; a 1-epoch
    run from it (the `-m` entry in the shared CLI child, or `cli.run.main`), then
    `--eval_only` on its checkpoint reproduces its test metrics and 7
    slices to 1e-9. → the run's wall seconds."""
    out = cli_out(f"g3-{name.lower()}")
    ref = os.path.join(out, "reference.pth")
    torch.save({"state_dict": reference_layout(cli_model(argv, SEED + 800))}, ref)
    seeded = cli_model(argv, SEED)
    quick_start.import_torch_checkpoint(seeded, name, ref)
    want = torch.load(ref, weights_only=True)["state_dict"]
    got = reference_layout(seeded)
    require(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
            f"G3 {name}: imported weights differ from the .pth")
    argv = argv + [f"--import_torch_checkpoint={ref}", "--epochs=1", *cli_flags(out)]
    t0 = time.perf_counter()
    if subprocess_run:
        rc, lines, _, _ = cli_process(argv)
        require(rc == 0, f"G3 {name}: rc {rc}: " + "\n".join(lines[-30:]))
        require(any("imported reference checkpoint" in x for x in lines),
                f"G3 {name}: no import logged")
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)
        test, slices = res["test_result"], res["inductive"]
    else:
        res = cli_run.main(argv)
        test, slices = res["test_result"], res["inductive_results"]
    wall = time.perf_counter() - t0
    finite_metrics(test, f"G3 {name} test")
    again = cli_run.main([f"--eval_only={os.path.join(out, f'{name}-synth-ind.pth')}",
                          "--inductive_eval=True"])
    agree(dict(test), dict(again["test_result"]), f"G3 {name} eval_only test", tol=1e-9)
    agree_slices(slices, again["inductive_results"], f"G3 {name} eval_only slices", tol=1e-9)
    log(f"G3 {name}: seeded from a reference .pth, 1 epoch in {wall:.1f} s (wall); "
        f"--eval_only == the run (1e-9); test {dict(test)}")
    return wall


def g3_resume():
    """The committed JAX checkpoint (BPR on synth-ind, sparse_adam, one
    epoch), read with no flax: `load_data_and_model` restores it (params
    == the file's bit for bit, the lazy-Adam moments and count), and one
    more epoch trains on the host path, kernel 6 on the resumed moments."""
    from oovrec_tpu_torch.utils.jax_checkpoint import read_jax_checkpoint
    from oovrec_tpu_torch.utils.jax_params import state_dict_from_flax

    out = cli_out("g3-resume")
    run = quick_start.load_data_and_model(G_FIXTURE, {"device": DEVICE, "checkpoint_dir": out})
    trainer, model = run.trainer, run.model
    state = read_jax_checkpoint(G_FIXTURE)
    want = state_dict_from_flax(state["params"], model)
    require(all(torch.equal(model.state_dict()[k].cpu(), v) for k, v in want.items()),
            "G3 resume: params differ from the JAX checkpoint")
    count = trainer.opt_state["count"]
    require(trainer.optimizer.rule == "lazy_adam" and trainer.start_epoch == 1
            and count == int(state["opt_state"]["0"]["count"]) and trainer.sparse_tables,
            "G3 resume: the lazy-Adam state and the row-sparse host path")
    trainer.epochs = 2
    sparse_adam_rows_kernel.launches = 0
    sync()
    t0 = time.perf_counter()
    trainer.fit(run.train_loader, run.valid_loader, saved=False)
    sync()
    wall = time.perf_counter() - t0
    k6 = sparse_adam_rows_kernel.launches
    loss = trainer.train_loss_dict.get(1)
    require(list(trainer.train_loss_dict) == [1] and loss is not None and math.isfinite(loss)
            and trainer.opt_state["count"] > count and k6 > 0,
            f"G3 resume: epoch 1 loss {loss}, count {trainer.opt_state['count']}, k6 {k6}")
    finite_metrics(trainer.best_valid_result, "G3 resume valid")
    log(f"G3 resume of {G_FIXTURE}: epoch 1 in {wall:.2f} s, loss {loss:.4f}, "
        f"count {count} -> {trainer.opt_state['count']}, kernel 6 launches {k6}")
    return {"sparse_adam_rows_kernel": k6}


def g3_cli():
    """G3: the CLI seeded from reference `.pth` files (BPR by the `-m`
    entry, xDeepFM by `cli.run.main`), and a JAX checkpoint resumed. →
    the part's kernel 6 launches."""
    bpr = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
           *CLI_OOV]
    xdfm = ["--model=xDeepFM", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV,
            "--numerical_features=['age','price']"]
    g3_import("BPR", bpr, subprocess_run=True)
    counts = kernel_counts()
    g3_import("xDeepFM", xdfm, subprocess_run=False)
    counts = {k: counts[k] + n for k, n in kernel_counts().items()}
    # the CLI's paper protocol evaluates uni250, which takes no top-k kernel
    require(counts["cin_layer_pooled"] > 0 and counts["cin_layer_pooled_bwd"] > 0
            and counts["scatter_rows_kernel"] > 0, f"G3 launches {counts}")
    reset_kernel_counts()
    return {**counts, **g3_resume()}


def host_graph_vs_eager(make, what, steps, part="G4", times=G_TIMES, time_steps=None):
    """`graph_vs_eager` on the host path: `steps` host batches through the
    trainer's captured step and through the eager `_apply_step`, bit for
    bit; then their times over the first `time_steps` of them (all where
    None; the traces' kernels added to `part`'s). → the times, kept in
    `times`."""
    (a, loader), (b, _) = make(), make()
    require(a._maybe_device_epoch(loader) is None, f"{what}: the host path")
    batches = []
    for hb in loader:
        batches.append(to_device_batch(hb, DEVICE))
        if len(batches) == steps:
            break
    a.model.train()
    b.model.train()
    la = torch.stack([a.step_graphs.step(x) for x in batches])
    lb = torch.stack([b._apply_step(x) for x in batches])
    sync()
    g = a.step_graphs
    sa, sb = f_state(a), f_state(b)
    differ = [n for n in sa if not torch.equal(sa[n], sb[n])]
    log(f"{what}: {steps} host steps graphed ({g.replays} replays) vs eager: losses "
        f"{'equal' if torch.equal(la, lb) else 'DIFFER'}, {len(sa) - len(differ)} of "
        f"{len(sa)} tensors equal bit for bit")
    require(g.captures == 1 and g.replays == steps - 1 and torch.equal(la, lb) and not differ,
            f"{what}: graph vs eager differ {differ[:5]}")
    graph_vs_eager_times(SimpleNamespace(train_step=a.step_graphs.step), b,
                         batches[:time_steps], what, part)
    times[what] = F_TIMES.pop(what)
    return times[what]


def g4_zoo(ind):
    """G4: LR, FM, DeepFM and FFM at their YAML widths at the ranking
    cell's shape: LR, FM and DeepFM on the pointwise device epoch (4
    graphed steps == 4 eager ones) and each on the host path (graphed ==
    eager), ms a step of each; a short fit on the device epoch (LR, FM,
    DeepFM) or the host path (FFM), then the value eval on the held-out
    IV rows. → the part's launches."""
    train, _, held_iv = ctr_splits(ind)
    sampler = Sampler(["train"], [train], seed=SEED)
    counts = {}
    for i, name in enumerate(G_ZOO):
        device = name != "FFM"
        cfg = ctr_train_cfg(device_epoch=device, train_oov=False,
                            train_neg_sample_args=F_POINTWISE)
        trainer = Trainer(cfg, e_ranking_model(name, SEED + 900 + i))
        loader = TrainBatcher(rows_of(train, np.arange(len(train)) < 16 * CTR_B // 2,
                                      N_CTR_OLD_USERS, N_CTR_OLD_ITEMS),
                              sampler, cfg, InputType.POINTWISE)
        reset_kernel_counts()
        trainer.fit(loader, None, saved=False)
        counts = {k: counts.get(k, 0) + n for k, n in kernel_counts().items()}
        des = list(trainer._device_epochs.values())
        require(bool(des) == device and all(d.mode == "pointwise" for d in des),
                f"G4 {name}: the device epoch {[d.mode for d in des]}")
        g_losses(trainer.last_losses, f"G4 {name} ({'device epoch' if device else 'host'})")
        res = EvalRunner(trainer.model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))
        finite_metrics(res, f"G4 {name} value eval")
        log(f"G4 {name}: value eval on {len(held_iv)} held-out IV rows {dict(res)}")
        del trainer, loader

        def make(name=name, i=i, dev=False):
            c = ctr_train_cfg(device_epoch=dev, train_oov=False, train_neg_sample_args=F_POINTWISE)
            return Trainer(c, e_ranking_model(name, SEED + 910 + i)), TrainBatcher(
                train, sampler, c, InputType.POINTWISE)

        if device:
            a, gde, b, batches = graph_vs_eager(lambda: make(dev=True), f"G4 {name}",
                                                steps=G_ZOO_STEPS)
            graph_vs_eager_times(gde, b, batches, f"G4 {name} pointwise", "G4")
            g_times(f"G4 {name} pointwise")
            del a, gde, b, batches
        host_graph_vs_eager(make, f"G4 {name} host", G_ZOO_STEPS, time_steps=I_TIME_STEPS)
    return counts


H_ZOO = (("DCN", {}), ("AutoInt", {}), ("FNN", {}), ("PNN", {}), ("AFM", {}), ("FwFM", {}),
         ("DSSM", {}), ("FiGNN", {}), ("EulerNet", {}), ("NFM", {}),
         ("KD_DAGFM", {"phase": "distillation"}))  # H1, at their YAML widths
# H1: the non-OOV parameters a model's forward never reads (DSSM's towers
# read only the token fields); KD_DAGFM's teacher is held unchanged apart
H_UNREAD = {"DSSM": ("field_embedding.float_embedding_table.weight",)}
H_FIT_STEPS = 8       # H1: pointwise host steps of CTR_B rows before the OOV sub-epoch
                      # (16 until phase J)
H_COMPARE_STEPS = 4   # H1: graphed against eager host steps (8 until phase I)
H_EPOCHS_CLI = 1      # H2
H_TIMES = {}
H_GATHERS = {}        # H1: the gathers' backward launches of each model's fit


def h_model(name, seed, **over):
    """`e_ranking_model` for H1; DCN's N(0, 1) cross weights scaled by 1/10
    (as the trainer tests scale them), else its sigmoid saturates and most
    rows take no gradient."""
    model = e_ranking_model(name, seed, **over)
    if name == "DCN":
        with torch.no_grad():
            model.cross_w.mul_(0.1)
    return model


def h1_zoo(ind, mapper):
    """H1: the rest of the context zoo at its YAML widths at the ranking
    cell's shape (phase 4's fields and rows, random-mapper buckets, the
    pointwise traffic of G4): each model fits H_FIT_STEPS host steps (the
    graphed dense step) + the frozen OOV sub-epoch, the losses finite;
    every non-OOV parameter the model reads moved; KD_DAGFM in
    `distillation`, its teacher unchanged bit for bit; the value eval on the held-out IV rows and the 7 value slices (as E3 runs
    them) finite; then H_COMPARE_STEPS graphed host steps == eager ones bit
    for bit (BatchNorm statistics included), and the ms a step of each.
    → the part's launches (the fits')."""
    train, held, held_iv = ctr_splits(ind)
    sampler = Sampler(["train"], [train], seed=SEED)
    few = rows_of(train, np.arange(len(train)) < H_FIT_STEPS * CTR_B // 2,
                  N_CTR_OLD_USERS, N_CTR_OLD_ITEMS)
    counts = {}
    for i, (name, over) in enumerate(H_ZOO):
        what = f"H1 {name}"
        cfg = ctr_train_cfg(train_neg_sample_args=F_POINTWISE)
        model = h_model(name, SEED + 1000 + i, **over)
        trainer = Trainer(cfg, model)
        loader = TrainBatcher(few, sampler, cfg, InputType.POINTWISE)
        require(trainer._maybe_device_epoch(loader) is None, f"{what}: the host path")
        teacher = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("teacher.")}
        read = [n for n in trainer.params if n not in trainer.oov_params
                and n not in H_UNREAD.get(name, ()) and not n.startswith("teacher.")]
        before = {n: trainer.params[n].detach().clone() for n in read}
        stats = {k: v.clone() for k, v in bn_stats(model).items()}
        reset_kernel_counts()
        normal, oov, _ = f_fit(trainer, loader, what, falls=False)
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        H_GATHERS[name] = seen["scatter_rows_kernel"]
        require(normal["steps"] == H_FIT_STEPS and oov["steps"] > 0,
                f"{what}: {normal['steps']} + {oov['steps']} steps")
        require(seen["scatter_rows_kernel"] > 0, f"{what}: the gathers' backward {seen}")
        still = [n for n in read if torch.equal(before[n], trainer.params[n])]
        require(not still, f"{what}: parameters did not move over the fit: {still}")
        del before
        if name == "KD_DAGFM":
            require(len(teacher) == 6 and all(torch.equal(v, model.state_dict()[k])
                                              for k, v in teacher.items()),
                    f"{what}: distillation moved the teacher")
        require(all(not torch.equal(v, bn_stats(model)[k]) for k, v in stats.items()),
                f"{what}: BatchNorm statistics did not move")
        res = EvalRunner(model, cfg).evaluate(PlainEvalBatcher(held_iv, cfg))
        finite_metrics(res, f"{what} value eval")
        ev = InductiveEvaluator(model, cfg, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, mapper=mapper)
        slices = ev.evaluate_model(PlainEvalBatcher(held, cfg))
        require(tuple(slices) == SLICE_NAMES, f"{what}: slices {list(slices)}")
        for sname, r in slices.items():
            require(list(r) == ["auc", "logloss"] and all(math.isfinite(v) for v in r.values()),
                    f"{what} slice {sname}: {dict(r)}")
        log(f"{what}: {len(read)} parameters moved; gathers' backward launches "
            f"{seen['scatter_rows_kernel']}; held-out IV "
            f"{dict(res)}; 7 slices AUC " + ", ".join(f"{n} {r['auc']:.4f}"
                                                    for n, r in slices.items()))
        del trainer, loader, model

        def make(name=name, i=i, over=over):
            c = ctr_train_cfg(train_oov=False, train_neg_sample_args=F_POINTWISE)
            return Trainer(c, h_model(name, SEED + 1100 + i, **over)), TrainBatcher(
                train, sampler, c, InputType.POINTWISE)

        host_graph_vs_eager(make, what, H_COMPARE_STEPS, part="H1", times=H_TIMES,
                            time_steps=I_TIME_STEPS)
    log("H1 gathers' backward launches by model: " + json.dumps(H_GATHERS))
    return counts


# H2's and I2's child: `python -m oovrec_tpu_torch.cli.run` (runpy runs the
# module as `__main__` with the same argv), then the child's kernel launch
# counts
def cli_child(part, argv, out):
    """`python -m oovrec_tpu_torch.cli.run` with `argv` in the shared
    child (`cli_process`) writing to `out`: rc 0, its training and test
    lines logged, the gathers' backward launched there (the child prints
    its wrappers' counts after each run), finite test metrics. → (its
    launches, its results.json, wall s)."""
    rc, lines, child, wall = cli_process([*argv, *cli_flags(out)])
    for line in lines:
        if "training [" in line or "test result" in line:
            log(f"  [{part}] {line.split(' INFO ')[-1][:160]}")
    require(rc == 0, f"{part}: rc {rc}: " + "\n".join(lines[-30:]))
    counts = {k: child.get(k, 0) for k in kernel_counts()}
    require(counts["scatter_rows_kernel"] > 0,
            f"{part}: the gathers' backward in the run {child}")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    finite_metrics(res["test_result"], f"{part} test")
    return counts, res, wall


def h2_cli():
    """H2: `python -m oovrec_tpu_torch.cli.run --model=AutoInt
    --model_eval_type=ranking` in the shared CLI child on dataset/synth-ind (the
    random mapper, the OOV regime, H_EPOCHS_CLI epoch): rc 0, finite test
    metrics and 7 slices, the gathers' backward launched in the child (it
    prints its counts as it ends); `--eval_only` on its checkpoint, in this
    process, reproduces them to 1e-9. → the child's launches."""
    argv = ["--model=AutoInt", "--model_eval_type=ranking", "--dataset=synth-ind",
            "--data_path=dataset", SYNTH_LOAD_COL, *CLI_OOV, f"--epochs={H_EPOCHS_CLI}"]
    out = cli_out("h2")
    counts, res, wall = cli_child("H2", argv, out)
    value_slices_finite(res["inductive"], "H2 AutoInt")
    log(f"H2: python -m oovrec_tpu_torch.cli.run --model=AutoInt --model_eval_type=ranking "
        f"({H_EPOCHS_CLI} epoch) rc 0 in {wall:.1f} s (wall, in the shared CLI child, the "
        f"corpus included), test {res['test_result']}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'AutoInt-synth-ind.pth')}",
                          "--inductive_eval=True"])
    require(type(again["trainer"].model).__name__ == "AutoInt", "H2: the model")
    agree(res["test_result"], again["test_result"], "H2 eval_only test", tol=1e-9)
    agree_slices(res["inductive"], again["inductive_results"], "H2 eval_only slices", tol=1e-9)
    log(f"H2: --eval_only == the run on AUC, RMSE and the 7 slices (1e-9); the run's "
        f"launches {counts}")
    return counts


# phase I, the sequential family: a corpus at MovieLens-1M's shape (the
# standard RecBole sequential benchmark: 6,040 users, 3,706 items,
# 1,000,209 ratings, at least 20 a user), MAX_ITEM_LIST_LENGTH 50,
# leave-one-out valid and test; each user prefers one of I_GROUPS slices of
# the items, so the loss can fall
I_USERS, I_ITEMS, I_INTERS, I_MIN_A_USER = 6040, 3706, 1_000_209, 20
I_GROUPS, I_IN_GROUP, I_SEED = 32, 0.8, 13
I_L, I_B = 50, 2048
I_STEPS = 64           # I1: a fit's steps: the first I_STEPS batches' rows of
                       # the training split (131,072, so `auto` takes the
                       # device epoch at >= 100,000)
I_COMPARE_STEPS = 4    # I1: graphed against eager steps, bit for bit (8 until phase J)
I_TIME_STEPS = 1       # G4-N1: of those, the steps a timed and a profiled pass run
                       # (2 in I1-N1 and all 4 in G4 and H1 until phase O5)
                       # (4 until phase M: the eager traces' events cost host seconds)
I_EVAL_ROWS = 256      # I1: rows a batch of the scanned full-sort test pass
I_DEFAULT_EVAL_BATCH = 4096  # I1: RecBole's default: one row a batch here
I_DEFAULT_ROWS, I_DEFAULT_BUDGET_S = 64, 20.0  # 1,024 rows until phase J, 256 until P
I_MASK_BATCHES = 16    # I1: MaskItemSequence's host ms a batch, over these
I_MODELS = ("GRU4Rec", "SASRec", "NARM", "STAMP", "FPMC", "BERT4Rec")
I_DEVICE_EPOCH = ("GRU4Rec", "SASRec", "NARM", "STAMP")  # `auto` takes it
I_PER_BATCH_TOO = ("GRU4Rec", "SASRec")  # scanned == per-batch eval, bit for bit
I_BREAKDOWN = ("GRU4Rec", "SASRec")  # a graphed pass's largest kernels, logged
I_EPOCHS_CLI = 1      # I2
I_DATA, I_DATASET = os.path.join("build", "seq", "data"), "ml1m-shaped"
I_TIMES = {}
I_GATHERS = {}        # I1: the gathers' backward launches of each model's fit
I_CORPUS = {}         # I1's dataset and loaders, loaded once, reused by phase J


def ml1m_arrays(seed=I_SEED):
    """(user ids, item ids, timestamps) of a corpus at MovieLens-1M's
    shape, rows in random order: users 1..I_USERS with at least
    I_MIN_A_USER rows each (lognormal counts, the exact total), items
    1..I_ITEMS drawn by a Zipf-like popularity, I_IN_GROUP of a user's rows
    moved to the same popularity rank inside the user's slice of the items
    (item id mod I_GROUPS), timestamps increasing within each user."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(0.0, 1.0, I_USERS)
    counts = I_MIN_A_USER + np.floor(
        raw / raw.sum() * (I_INTERS - I_MIN_A_USER * I_USERS)).astype(np.int64)
    counts[: I_INTERS - counts.sum()] += 1
    uid = np.repeat(np.arange(1, I_USERS + 1), counts)
    pop = 1.0 / (np.arange(I_ITEMS) + 10.0) ** 0.9
    iid = 1 + rng.choice(I_ITEMS, size=I_INTERS, p=pop / pop.sum())
    slot = (iid - 1) // I_GROUPS * I_GROUPS + uid % I_GROUPS + 1
    own = (rng.random(I_INTERS) < I_IN_GROUP) & (slot <= I_ITEMS)
    iid = np.where(own, slot, iid)
    start = np.repeat(np.cumsum(counts) - counts, counts)
    rank = np.arange(I_INTERS) - start
    when = (978_300_000 + np.floor(86_400.0 * rng.random(I_USERS)).astype(np.int64)[uid - 1]
            + 60 * rank)
    order = rng.permutation(I_INTERS)
    return uid[order], iid[order], when[order]


def ml1m_inter_file(seed=I_SEED):
    """`ml1m_arrays` written as the atomic file
    `I_DATA/I_DATASET/I_DATASET.inter` (user and item tokens, integer
    timestamps as the float field). → wall s of the write."""
    t0 = time.perf_counter()
    uid, iid, when = ml1m_arrays(seed)
    d = os.path.join(I_DATA, I_DATASET)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, f"{I_DATASET}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\ttimestamp:float\n")
        np.savetxt(f, np.stack([uid, iid, when], axis=1), fmt="%d", delimiter="\t")
    return time.perf_counter() - t0


def seq_cfg(name, **over):
    """A sequential model's config at its YAML widths (`config/model/`):
    I_B rows a step, one epoch, CE without negatives (FPMC: BPR with one
    uniform negative), leave-one-out full sort over the whole item set,
    256 rows a scanned test batch."""
    d = {
        "model": name, "seed": SEED, "epochs": 1, "train_batch_size": I_B,
        "eval_batch_size": I_EVAL_ROWS * (I_ITEMS + 1), "MAX_ITEM_LIST_LENGTH": I_L,
        "learner": "adam", "learning_rate": 1e-3, "host_scan_steps": 1,
        "train_neg_sample_args": ({"distribution": "uniform", "sample_num": 1}
                                  if name == "FPMC" else {"distribution": "none"}),
        "eval_args": {"split": {"LS": "valid_and_test"}, "order": "TO",
                      "group_by": "user", "mode": "full"},
        "metrics": ["Recall", "MRR", "NDCG", "Hit"], "topk": [10, 20],
        "valid_metric": "MRR@10", "metric_decimal_place": 12, "device": DEVICE,
        "log_tensorboard": False, "checkpoint_dir": os.path.join("build", "seq"),
        "dataset": I_DATASET, "data_path": I_DATA,
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
    }
    d.update(over)
    return Config(d)


def seq_loader(name, cfg, train):
    """The model's training loader over the first I_STEPS batches' rows of
    the training split."""
    train = SeqDatasetSplit(train.parent, train.index[: I_STEPS * I_B])
    if name == "FPMC":
        return TrainBatcher(train, Sampler(["train"], [train], seed=SEED), cfg,
                            InputType.PAIRWISE)
    return TrainBatcher(train, None, cfg, InputType.POINTWISE)


def timed_eval(model, cfg, loader, what, **over):
    """One `EvalRunner` pass, synchronised. → (metrics, wall s)."""
    runner = EvalRunner(model, Config(dict(cfg.as_dict(), **over)))
    sync()
    t0 = time.perf_counter()
    res = runner.evaluate(loader)
    sync()
    wall = time.perf_counter() - t0
    finite_metrics(res, what)
    return res, wall


def mask_transform_ms(cfg, train):
    """MaskItemSequence (`data/transform.py`, a loop over rows by rule: it
    draws per row in the JAX stream's order) on I_MASK_BATCHES host
    batches of I_B training rows: host ms a batch."""
    from oovrec_tpu_torch.data.transform import MaskItemSequence

    mask = MaskItemSequence(cfg, train.item_num)
    times = []
    for b in range(I_MASK_BATCHES):
        rows = slice(b * I_B, (b + 1) * I_B)
        batch = {k: v[rows] for k, v in train.inter.items()}
        t0 = time.perf_counter()
        out = mask(batch)
        times.append((time.perf_counter() - t0) * 1e3)
        require(int(out["mask_count"].min()) >= 1, "MaskItemSequence: a row masked nothing")
    log(f"I1 MaskItemSequence: host ms a batch of {I_B} rows "
        f"{float(np.mean(times)):.3f} (min {min(times):.3f}, max {max(times):.3f}, "
        f"{I_MASK_BATCHES} batches)")
    I_TIMES["MaskItemSequence host ms a batch"] = times
    return times


def default_eval_pass(model, cfg, valid):
    """GRU4Rec's valid pass at RecBole's default eval_batch_size (4,096:
    one row a batch over 3,707 items): the first I_DEFAULT_ROWS rows
    timed, and the whole pass only when those rows project it under
    I_DEFAULT_BUDGET_S. → wall s of what ran."""
    cfg = Config(dict(cfg.as_dict(), eval_batch_size=I_DEFAULT_EVAL_BATCH))
    head = SeqFullSortEvalBatcher(
        SeqDatasetSplit(valid.parent, valid.index[:I_DEFAULT_ROWS]), cfg)
    require(head.rows_per_batch == 1, f"I1 default eval: {head.rows_per_batch} rows a batch")
    _, wall = timed_eval(model, cfg, head, "I1 GRU4Rec default valid pass")
    projected = wall * len(valid) / I_DEFAULT_ROWS
    if projected <= I_DEFAULT_BUDGET_S:
        _, wall = timed_eval(model, cfg, SeqFullSortEvalBatcher(valid, cfg),
                             "I1 GRU4Rec default valid pass")
        log(f"I1 GRU4Rec valid pass at eval_batch_size {I_DEFAULT_EVAL_BATCH} (1 row a "
            f"batch): {len(valid)} rows in {wall:.2f} s")
    else:
        log(f"I1 GRU4Rec valid pass at eval_batch_size {I_DEFAULT_EVAL_BATCH} (1 row a "
            f"batch): stopped at {I_DEFAULT_ROWS} rows, {wall:.2f} s, projected "
            f"{projected:.1f} s for the {len(valid)} rows (over {I_DEFAULT_BUDGET_S:.0f} s)")
    I_TIMES["GRU4Rec default valid pass"] = {"rows": I_DEFAULT_ROWS if projected >
                                             I_DEFAULT_BUDGET_S else len(valid),
                                             "wall_s": wall, "projected_s": projected}
    return wall


def i_corpus():
    """Phase I's corpus (`ml1m_inter_file`), loaded and split once a
    process into I_CORPUS (phase J's corpus too; `main` loads it while the
    kernels build), the set-up timed. → (dataset, loaders)."""
    if "aug" not in I_CORPUS:
        wrote = ml1m_inter_file()
        base = seq_cfg("GRU4Rec")
        t0 = time.perf_counter()
        ds = create_dataset(base)
        loaded = time.perf_counter() - t0
        loaders = data_preparation(base, ds)
        aug = ds.data_augmentation()
        I_CORPUS.update(ds=ds, loaders=loaders, aug=aug,
                        **{"set-up s": (wrote, loaded, time.perf_counter() - t0)})
    return I_CORPUS["ds"], I_CORPUS["loaders"]


def i1_sequential():
    """I1: GRU4Rec, SASRec, NARM, STAMP, FPMC and BERT4Rec at their YAML
    widths on the MovieLens-1M-shaped corpus: each fits one epoch of
    I_STEPS steps through `Trainer.fit` (GRU4Rec, SASRec, NARM and STAMP
    on the plain device epoch, which `auto` takes; FPMC and BERT4Rec on
    the host path), the losses finite and falling, every parameter moved,
    the gathers' backward launched; one scanned full-sort test pass over
    the 6,040 users' examples, 256 rows a batch (GRU4Rec and SASRec also
    per batch, the same metrics); then I_COMPARE_STEPS graphed steps ==
    eager ones bit for bit and the ms a step of each over I_TIME_STEPS of
    them (GRU4Rec's and SASRec's graphed pass: its largest kernels). Also
    MaskItemSequence's host ms a batch and GRU4Rec's valid pass at
    RecBole's default eval batch. → the fits' launches."""
    ds, loaders = i_corpus()
    train_loader, valid_loader, test_loader = loaders
    train, valid, test = (x.split for x in loaders)
    aug, (wrote, loaded, prepared) = I_CORPUS["aug"], I_CORPUS["set-up s"]
    log(f"I1 corpus: {I_INTERS} rows, {I_USERS} users, {I_ITEMS} items -> "
        f"{len(aug['user_id'])} examples ({aug['item_id_list'].shape} item lists), train "
        f"{len(train)}, valid {len(valid)}, test {len(test)}; set-up apart from the phase's "
        f"times: the .inter file written in {wrote:.1f} s, `create_dataset` {loaded:.1f} s, "
        f"with `data_preparation` (augmentation and splits) {prepared:.1f} s")
    I_TIMES["set-up s"] = {"write": wrote, "create_dataset": loaded,
                           "create_dataset + data_preparation": prepared}
    require(type(ds) is SequentialDataset and ds.item_num == I_ITEMS + 1
            and ds.user_num == I_USERS + 1, f"I1: the dataset {type(ds)} {ds.item_num}")
    require(len(valid) == len(test) == I_USERS, "I1: one valid and one test row a user")
    require(all(type(x) is SeqFullSortEvalBatcher and x.rows_per_batch == I_EVAL_ROWS
                for x in (valid_loader, test_loader)),
            f"I1: data_preparation's eval loaders {valid_loader} {test_loader}")
    mask_transform_ms(seq_cfg("BERT4Rec"), train)
    counts = {}
    for i, name in enumerate(I_MODELS):
        what = f"I1 {name}"
        cfg = seq_cfg(name)
        model = quick_start.build_model_and_state(cfg, ds)
        trainer = Trainer(cfg, model)
        loader = seq_loader(name, cfg, train)
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        steps = f_fit(trainer, loader, what)[0]["steps"]
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        I_GATHERS[name] = seen["scatter_rows_kernel"]
        des = list(trainer._device_epochs.values())
        on_device = name in I_DEVICE_EPOCH
        require(bool(des) == on_device and all(d.mode == "plain" for d in des),
                f"{what}: the device epoch {[d.mode for d in des]}")
        require(seen["scatter_rows_kernel"] > 0, f"{what}: the gathers' backward {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(not still, f"{what}: parameters did not move over the fit: {still}")
        del before
        res, wall = timed_eval(model, cfg, test_loader, f"{what} test",
                               device_eval=True)
        require(steps == I_STEPS, f"{what}: {steps} steps")
        line = (f"{what}: {steps} steps ({'device epoch' if on_device else 'host path'}), "
                f"{len(trainer.params)} parameters moved, gathers' backward launches "
                f"{seen['scatter_rows_kernel']}; scanned test pass ({len(test)} rows, "
                f"{I_EVAL_ROWS} a batch) {wall:.3f} s: {dict(res)}")
        I_TIMES[f"{name} scanned test pass s"] = wall
        if name in I_PER_BATCH_TOO:
            again, wall_b = timed_eval(model, cfg, test_loader,
                                       f"{what} test per batch", device_eval=False)
            require(again == res, f"{what}: scanned {dict(res)} vs per-batch {dict(again)}")
            line += f"; per batch {wall_b:.3f} s, the same metrics"
            I_TIMES[f"{name} per-batch test pass s"] = wall_b
        log(line)
        if name == "GRU4Rec":
            default_eval_pass(model, cfg, valid)
        del trainer, loader, model

        def make(name=name, i=i):
            c = seq_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), seq_loader(name, c,
                                                                                  train)

        if on_device:
            a, gde, b, batches = graph_vs_eager(make, what, steps=I_COMPARE_STEPS)
            graph_vs_eager_times(gde, b, batches[:I_TIME_STEPS], what, "I1")
            I_TIMES[what] = F_TIMES.pop(what)
            del a, gde, b, batches
        else:
            host_graph_vs_eager(make, what, I_COMPARE_STEPS, part="I1", times=I_TIMES,
                                time_steps=I_TIME_STEPS)
        if name in I_BREAKDOWN:  # the last profile taken: the graphed pass's
            log(f"{what}: the graphed pass's largest kernels (device ms over "
                f"{I_TIME_STEPS} steps, launches)")
            for us, key, count in getattr(profiled, "rows", [])[:12]:
                log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    log("I1 gathers' backward launches by model: " + json.dumps(I_GATHERS))
    return counts


def i2_cli():
    """I2: `python -m oovrec_tpu_torch.cli.run --model=GRU4Rec` as a
    subprocess on dataset/synth-ind (timestamps loaded, the paper protocol:
    uni250 eval, one sampled negative a row; I_EPOCHS_CLI epoch): rc 0,
    finite test metrics, the gathers' backward launched in the child;
    `--eval_only` on its checkpoint, in this process, reproduces them to
    1e-9. → the child's launches."""
    argv = ["--model=GRU4Rec", "--dataset=synth-ind", "--data_path=dataset",
            "--load_col={'inter': ['user_id','item_id','timestamp','is_new']}",
            f"--epochs={I_EPOCHS_CLI}"]
    out = cli_out("i2")
    counts, res, wall = cli_child("I2", argv, out)
    log(f"I2: python -m oovrec_tpu_torch.cli.run --model=GRU4Rec ({I_EPOCHS_CLI} epoch) rc 0 "
        f"in {wall:.1f} s (wall, in the shared CLI child, the corpus included), test "
        f"{res['test_result']}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'GRU4Rec-synth-ind.pth')}"])
    require(type(again["trainer"].model).__name__ == "GRU4Rec", "I2: the model")
    agree(res["test_result"], again["test_result"], "I2 eval_only test", tol=1e-9)
    log(f"I2: --eval_only == the run on the test metrics (1e-9); the run's launches {counts}")
    I_TIMES["I2 CLI run s"] = wall
    return counts


# phase J, the rest of the plain sequence models, on I1's corpus at their
# YAML widths
J_MODELS = ("Caser", "NextItNet", "DIN", "DIEN", "HGN", "FOSSIL", "TransRec", "SHAN", "NPE",
            "HRM", "CORE", "SRGNN", "GCSAN", "LightSANs", "SINE")
J_DEVICE_EPOCH = ("Caser", "NextItNet")  # `auto` takes the plain device epoch
J_SAMPLED = ("DIN", "DIEN", "TransRec")  # one uniform negative a row
J_CLICK = ("DIN", "DIEN")                # scored by `predict`; the blocked full sort
J_PER_BATCH_TOO = ("Caser", "SRGNN", "LightSANs")  # scanned == per-batch eval
J_STEPS = 32           # J1: host-path fits' steps of I_B rows; the device-epoch
                       # fits take I_STEPS (131,072 rows, so `auto` takes it)
J_COMPARE_STEPS = 4    # J1: graphed against eager steps, bit for bit (I_TIME_STEPS timed)
J_SORT_USERS = 64      # J1: DIN's / DIEN's blocked full sort, timed on these
J_SORT_CHECK = (8, 512)  # J1: users x items held against one unblocked block
J_EPOCHS_CLI = 1       # J2
J_TIMES = {}
J_GATHERS = {}         # J1: the gathers' backward launches of each model's fit


def j_cfg(name):
    """`seq_cfg` with one uniform negative a row for the sampled models."""
    if name in J_SAMPLED:
        return seq_cfg(name, train_neg_sample_args={"distribution": "uniform",
                                                    "sample_num": 1})
    return seq_cfg(name)


def j_loader(name, cfg, train):
    """The model's training loader over the rows of its fit's steps:
    DIN / DIEN pointwise (a positive and a negative row each, I_B rows a
    step), TransRec pairwise, the others plain."""
    steps = I_STEPS if name in J_DEVICE_EPOCH else J_STEPS
    pointwise = name in J_CLICK
    rows = steps * (I_B // 2 if pointwise else I_B)
    split = SeqDatasetSplit(train.parent, train.index[:rows])
    if name not in J_SAMPLED:
        return TrainBatcher(split, None, cfg, InputType.POINTWISE)
    return TrainBatcher(split, Sampler(["train"], [split], seed=SEED), cfg,
                        InputType.POINTWISE if pointwise else InputType.PAIRWISE)


def auc_of(scores, labels):
    """The AUC by ranks (ties averaged)."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    _, tie, count = np.unique(scores, return_inverse=True, return_counts=True)
    ranks = (np.bincount(tie, weights=ranks) / count)[tie]
    pos = labels > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def j_click_eval(name, model, cfg, test):
    """DIN / DIEN: `predict` on the test examples against one uniform
    negative each (finite, inside (0, 1), the AUC); the blocked full sort
    of J_SORT_USERS users timed and projected over the test users, its
    first J_SORT_CHECK users x items held to 1e-6 against one unblocked
    block of those items."""
    rng = np.random.default_rng(SEED + 31)
    rows = {k: v for k, v in test.inter.items()}
    n = len(test)
    neg = rng.integers(1, I_ITEMS + 1, n)
    both = {k: np.concatenate([v, v]) for k, v in rows.items()}
    both[cfg["ITEM_ID_FIELD"]] = np.concatenate([rows[cfg["ITEM_ID_FIELD"]], neg])
    labels = np.r_[np.ones(n), np.zeros(n)]
    model.eval()
    scores = []
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        for start in range(0, 2 * n, I_EVAL_ROWS):
            b = to_device_batch({k: v[start:start + I_EVAL_ROWS] for k, v in both.items()},
                                DEVICE)
            scores.append(model.predict(b).float().cpu().numpy())
    sync()
    wall_p = time.perf_counter() - t0
    scores = np.concatenate(scores)
    require(np.isfinite(scores).all() and (scores > 0).all() and (scores < 1).all(),
            f"J1 {name}: predict outside (0, 1)")
    auc = auc_of(scores, labels)
    batch = to_device_batch({k: v[:J_SORT_USERS] for k, v in rows.items()}, DEVICE)
    with torch.no_grad():
        model.full_sort_scores(batch)  # warm
        sync()
        t0 = time.perf_counter()
        full = model.full_sort_scores(batch)
        sync()
        wall_s = time.perf_counter() - t0
        u, t = J_SORT_CHECK
        one = model.score_items({k: v[:u] for k, v in batch.items()},
                                torch.arange(t, device=full.device))
    err = float((full[:u, :t] - one).abs().max())
    blocks = -(-model.n_items // max(1, model.full_sort_elems
                                        // (J_SORT_USERS * I_L * 4 * model.embedding_size)))
    require(full.shape == (J_SORT_USERS, model.n_items) and bool(torch.isfinite(full).all()),
            f"J1 {name}: the full sort {tuple(full.shape)}")
    require(err <= 1e-6, f"J1 {name}: blocked vs unblocked full sort differ by {err}")
    projected = wall_s * n / J_SORT_USERS
    log(f"J1 {name}: predict on {n} test examples + one uniform negative each in "
        f"{wall_p:.3f} s, AUC {auc:.4f}; the blocked full sort of {J_SORT_USERS} users x "
        f"{model.n_items} items ({blocks} blocks) in {wall_s * 1e3:.1f} ms, == one unblocked "
        f"block on {u} users x {t} items to {err:.2e}; projected over the {n} test users "
        f"{projected:.1f} s (not run)")
    J_TIMES[f"{name} predict AUC"] = auc
    J_TIMES[f"{name} blocked full sort"] = {"users": J_SORT_USERS, "ms": wall_s * 1e3,
                                            "blocks": blocks, "projected_s": projected}


def j1_sequential():
    """J1: the fifteen at their YAML widths on I1's corpus: each fits
    through `Trainer.fit` (Caser and NextItNet I_STEPS steps on the plain
    device epoch that `auto` takes, the others J_STEPS on the host path;
    DIN, DIEN (negatives drawn on the card) and TransRec with one sampled
    negative), the losses finite and falling, every parameter moved, the
    gathers' backward launched; J_COMPARE_STEPS graphed steps == eager
    ones bit for bit and their ms a step; the scanned full-sort test pass
    over the 6,040 users (Caser, SRGNN, LightSANs: == the per-batch pass),
    or for DIN and DIEN `j_click_eval`. → the fits' launches."""
    ds = I_CORPUS["ds"]
    train_loader, valid_loader, test_loader = I_CORPUS["loaders"]
    train, test = train_loader.split, test_loader.split
    counts = {}
    for i, name in enumerate(J_MODELS):
        what = f"J1 {name}"
        cfg = j_cfg(name)
        model = quick_start.build_model_and_state(cfg, ds)
        trainer = Trainer(cfg, model)
        loader = j_loader(name, cfg, train)
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        normal, _, fit_s = f_fit(trainer, loader, what)
        steps = normal["steps"]
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        J_GATHERS[name] = seen["scatter_rows_kernel"]
        des = list(trainer._device_epochs.values())
        on_device = name in J_DEVICE_EPOCH
        require(bool(des) == on_device and all(d.mode == "plain" for d in des),
                f"{what}: the device epoch {[d.mode for d in des]}")
        require(steps == (I_STEPS if on_device else J_STEPS), f"{what}: {steps} steps")
        require(seen["scatter_rows_kernel"] > 0, f"{what}: the gathers' backward {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(not still, f"{what}: parameters did not move over the fit: {still}")
        del before
        line = (f"{what}: {steps} steps ({'device epoch' if on_device else 'host path'}), "
                f"{len(trainer.params)} parameters moved, gathers' backward launches "
                f"{seen['scatter_rows_kernel']}")
        J_TIMES[f"{name} fit s"] = fit_s
        if name in J_CLICK:
            log(line)
            j_click_eval(name, model, cfg, test)
        else:
            res, wall = timed_eval(model, cfg, test_loader, f"{what} test", device_eval=True)
            line += (f"; scanned test pass ({len(test)} rows, {I_EVAL_ROWS} a batch) "
                     f"{wall:.3f} s: {dict(res)}")
            J_TIMES[f"{name} scanned test pass s"] = wall
            if name in J_PER_BATCH_TOO:
                again, wall_b = timed_eval(model, cfg, test_loader, f"{what} test per batch",
                                           device_eval=False)
                require(again == res, f"{what}: scanned {dict(res)} vs per-batch {dict(again)}")
                line += f"; per batch {wall_b:.3f} s, the same metrics"
                J_TIMES[f"{name} per-batch test pass s"] = wall_b
            log(line)
        del trainer, loader, model

        def make(name=name):
            c = j_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), j_loader(name, c, train)

        if on_device:
            a, gde, b, batches = graph_vs_eager(make, what, steps=J_COMPARE_STEPS)
            graph_vs_eager_times(gde, b, batches[:I_TIME_STEPS], what, "J1")
            J_TIMES[what] = F_TIMES.pop(what)
            del a, gde, b, batches
        else:
            host_graph_vs_eager(make, what, J_COMPARE_STEPS, part="J1", times=J_TIMES,
                                time_steps=I_TIME_STEPS)
    log("J1 gathers' backward launches by model: " + json.dumps(J_GATHERS))
    return counts


def j2_cli():
    """J2: `python -m oovrec_tpu_torch.cli.run --model=Caser` as a
    subprocess on dataset/synth-ind (timestamps loaded, the paper
    protocol; J_EPOCHS_CLI epoch): rc 0, finite test metrics, the gathers'
    backward launched in the child; `--eval_only` on its checkpoint, in
    this process, reproduces them to 1e-9. → the child's launches."""
    argv = ["--model=Caser", "--dataset=synth-ind", "--data_path=dataset",
            "--load_col={'inter': ['user_id','item_id','timestamp','is_new']}",
            f"--epochs={J_EPOCHS_CLI}"]
    out = cli_out("j2")
    counts, res, wall = cli_child("J2", argv, out)
    log(f"J2: python -m oovrec_tpu_torch.cli.run --model=Caser ({J_EPOCHS_CLI} epoch) rc 0 "
        f"in {wall:.1f} s (wall, in the shared CLI child, the corpus included), test "
        f"{res['test_result']}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'Caser-synth-ind.pth')}"])
    require(type(again["trainer"].model).__name__ == "Caser", "J2: the model")
    agree(res["test_result"], again["test_result"], "J2 eval_only test", tol=1e-9)
    log(f"J2: --eval_only == the run on the test metrics (1e-9); the run's launches {counts}")
    J_TIMES["J2 CLI run s"] = wall
    return counts


# phase K, the last seven sequential models, on I1's interactions with
# ML-1M's item columns (`genre` 1-6 of 18 an item, `release_year` 81
# values) and a preloaded entity table beside them, at their YAML widths
K_MODELS = ("GRU4RecF", "SASRecF", "FDSA", "RepeatNet", "GRU4RecKG", "KSR", "S3Rec")
K_DEVICE_EPOCH = ("GRU4RecF", "SASRecF", "FDSA", "GRU4RecKG")  # `auto` takes it
K_PER_BATCH_TOO = ("FDSA", "KSR")  # scanned == per-batch eval
K_FROZEN = ("GRU4RecKG", "KSR")    # `freeze_kg`: the entity table stays (weight_decay 0)
K_FEATURES = ["genre", "release_year"]
K_GENRES, K_GENRES_MAX, K_YEARS, K_ENT_DIM = 18, 6, 81, 64
K_STEPS = 32           # K1: host-path fits' steps of I_B rows; the device-epoch
                       # fits take I_STEPS (131,072 rows, so `auto` takes it)
K_COMPARE_STEPS = 4    # K1: graphed against eager steps, bit for bit (I_TIME_STEPS timed)
K_EPOCHS_CLI = 1       # K2
K_TIMES = {}
K_GATHERS = {}         # K1: the gathers' backward launches of each model's fit


def ml1m_side_files(seed=I_SEED):
    """Beside phase I's `.inter`: `I_DATASET.item` (each item's 1 to
    K_GENRES_MAX of K_GENRES genres as `genre:token_seq`, one of K_YEARS
    years as `release_year:token`) and `I_DATASET.ent` (each item's token
    as `ent_id:token` and K_ENT_DIM normal floats as `ent_vec:float_seq`).
    → wall s of the writes."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 1)
    d = os.path.join(I_DATA, I_DATASET)
    counts = rng.integers(1, K_GENRES_MAX + 1, I_ITEMS)
    years = 1919 + rng.integers(0, K_YEARS, I_ITEMS)
    with open(os.path.join(d, f"{I_DATASET}.item"), "w") as f:
        f.write("item_id:token\tgenre:token_seq\trelease_year:token\n")
        for i in range(I_ITEMS):
            genres = rng.choice(K_GENRES, counts[i], replace=False)
            f.write(f"{i + 1}\t{' '.join(f'g{g}' for g in genres)}\t{years[i]}\n")
    vecs = rng.standard_normal((I_ITEMS, K_ENT_DIM)).astype(np.float32)
    with open(os.path.join(d, f"{I_DATASET}.ent"), "w") as f:
        f.write("ent_id:token\tent_vec:float_seq\n")
        for i in range(I_ITEMS):
            f.write(f"{i + 1}\t{' '.join(f'{v:.6f}' for v in vecs[i])}\n")
    return time.perf_counter() - t0


def k_cfg(name):
    """`seq_cfg` with the item columns, the entity table and the
    feature and preload keys of phase K."""
    return seq_cfg(name, selected_features=K_FEATURES, additional_feat_suffix=["ent"],
                   preload_weight={"ent_id": "ent_vec"},
                   load_col={"inter": ["user_id", "item_id", "timestamp"],
                             "item": ["item_id", *K_FEATURES]})


def k_loader(name, cfg, train):
    """The model's plain CE loader over the rows of its fit's steps."""
    steps = I_STEPS if name in K_DEVICE_EPOCH else K_STEPS
    return TrainBatcher(SeqDatasetSplit(train.parent, train.index[: steps * I_B]), None, cfg,
                        InputType.POINTWISE)


def k_repeats(loader, what):
    """The rows of the loader's first K_COMPARE_STEPS batches whose item
    list repeats an item (RepeatNet's scatter adds them up). → that
    count, which must be > 0."""
    rows = 0
    for i, hb in enumerate(loader):
        if i == K_COMPARE_STEPS:
            break
        seq = np.sort(np.asarray(hb["item_id_list"]), axis=1)
        rows += int(((seq[:, 1:] == seq[:, :-1]) & (seq[:, 1:] > 0)).any(axis=1).sum())
    require(rows > 0, f"{what}: no compared row repeats an item")
    return rows


def k1_sequential():
    """K1: the seven at their YAML widths on I1's interactions with the
    `.item` and `.ent` files of `ml1m_side_files`: each fits through
    `Trainer.fit` (GRU4RecF, SASRecF, FDSA and GRU4RecKG I_STEPS steps on
    the plain device epoch that `auto` takes, RepeatNet, KSR and S3Rec's
    pretraining K_STEPS on the host path), the losses finite and falling,
    every parameter moved but a frozen entity table, which stays bit for
    bit, the gathers' backward launched; K_COMPARE_STEPS graphed steps ==
    eager ones bit for bit and their ms a step (RepeatNet's batches repeat
    items); the scanned full-sort test pass over the 6,040 users (FDSA,
    KSR: == the per-batch pass). → the fits' launches."""
    from oovrec_tpu_torch.models.sequential.featseq import TOKEN_SEQ_CAP

    wrote = ml1m_side_files()
    base = k_cfg("GRU4RecF")
    t0 = time.perf_counter()
    ds = create_dataset(base)
    loaded = time.perf_counter() - t0
    train_loader, valid_loader, test_loader = data_preparation(base, ds)
    prepared = time.perf_counter() - t0
    train, test = train_loader.split, test_loader.split
    K_TIMES["set-up s"] = {"write .item and .ent": wrote, "create_dataset": loaded,
                           "create_dataset + data_preparation": prepared}
    require(type(ds) is SequentialDataset and ds.item_num == I_ITEMS + 1
            and len(test) == I_USERS, f"K1: the dataset {type(ds)} {ds.item_num}")
    packed = get_model_class("GRU4RecF").build_estate(ds, base)["seq_feat_tokens"]
    slots = (packed[:, :TOKEN_SEQ_CAP] > 0).sum(axis=1)
    ent = ds.get_preload_weight("ent_id")
    require(packed.shape == (I_ITEMS + 1, TOKEN_SEQ_CAP + 1) and int(slots.max()) == TOKEN_SEQ_CAP
            and not packed[0].any() and (packed[1:, TOKEN_SEQ_CAP] > 0).all(),
            f"K1: the packed item features {packed.shape}, slots {int(slots.max())}")
    require(ent.shape == (I_ITEMS + 1, K_ENT_DIM) and not ent[0].any()
            and bool((np.abs(ent[1:]).sum(axis=1) > 0).all()), f"K1: the preload {ent.shape}")
    log(f"K1 corpus: I1's interactions with {I_DATASET}.item ({len(K_FEATURES)} fields, "
        f"{int((slots == TOKEN_SEQ_CAP).sum())} items at the {TOKEN_SEQ_CAP}-slot cap) and "
        f"{I_DATASET}.ent ({ent.shape[0] - 1} x {K_ENT_DIM}); set-up apart from the phase's "
        f"times: written in {wrote:.1f} s, `create_dataset` {loaded:.1f} s, with "
        f"`data_preparation` {prepared:.1f} s")
    counts = {}
    for name in K_MODELS:
        what = f"K1 {name}"
        cfg = k_cfg(name)
        model = quick_start.build_model_and_state(cfg, ds)
        require(next(model.parameters()).device.type == torch.device(DEVICE).type,
                f"{what}: the model's device")
        frozen = name in K_FROZEN
        if frozen:
            require(model.freeze_kg and torch.equal(model.entity_embedding.detach().cpu(),
                                                    torch.from_numpy(ent)),
                    f"{what}: the entity table is not the frozen preload")
        trainer = Trainer(cfg, model)
        loader = k_loader(name, cfg, train)
        t_model = time.perf_counter()
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        normal, _, fit_s = f_fit(trainer, loader, what)
        steps = normal["steps"]
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        K_GATHERS[name] = seen["scatter_rows_kernel"]
        des = list(trainer._device_epochs.values())
        on_device = name in K_DEVICE_EPOCH
        require(bool(des) == on_device and all(d.mode == "plain" for d in des),
                f"{what}: the device epoch {[d.mode for d in des]}")
        require(steps == (I_STEPS if on_device else K_STEPS), f"{what}: {steps} steps")
        require(seen["scatter_rows_kernel"] > 0, f"{what}: the gathers' backward {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(still == (["entity_embedding"] if frozen else []),
                f"{what}: parameters that did not move over the fit: {still}")
        del before
        res, wall = timed_eval(model, cfg, test_loader, f"{what} test", device_eval=True)
        line = (f"{what}: {steps} steps ({'device epoch' if on_device else 'host path'}), "
                f"{len(trainer.params) - len(still)} parameters moved"
                f"{', the frozen entity table bit for bit' if frozen else ''}, gathers' "
                f"backward launches {seen['scatter_rows_kernel']}; scanned test pass "
                f"({len(test)} rows, {I_EVAL_ROWS} a batch) {wall:.3f} s: {dict(res)}")
        K_TIMES[f"{name} fit s"] = fit_s
        K_TIMES[f"{name} scanned test pass s"] = wall
        if name in K_PER_BATCH_TOO:
            again, wall_b = timed_eval(model, cfg, test_loader, f"{what} test per batch",
                                       device_eval=False)
            require(again == res, f"{what}: scanned {dict(res)} vs per-batch {dict(again)}")
            line += f"; per batch {wall_b:.3f} s, the same metrics"
            K_TIMES[f"{name} per-batch test pass s"] = wall_b
        log(line)
        del trainer, loader, model

        def make(name=name):
            c = k_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), k_loader(name, c, train)

        t_compare = time.perf_counter()
        if on_device:
            a, gde, b, batches = graph_vs_eager(make, what, steps=K_COMPARE_STEPS)
            graph_vs_eager_times(gde, b, batches[:I_TIME_STEPS], what, "K1")
            K_TIMES[what] = F_TIMES.pop(what)
            del a, gde, b, batches
        else:
            if name == "RepeatNet":
                rows = k_repeats(k_loader(name, cfg, train), what)
                log(f"{what}: {rows} of the {K_COMPARE_STEPS * I_B} compared rows repeat an item")
            host_graph_vs_eager(make, what, K_COMPARE_STEPS, part="K1", times=K_TIMES,
                                time_steps=I_TIME_STEPS)
        K_TIMES[f"{name} host s"] = {"fit and eval": t_compare - t_model,
                                     "graphed vs eager, timed": time.perf_counter() - t_compare}
    log("K1 gathers' backward launches by model: " + json.dumps(K_GATHERS))
    return counts


def k2_cli():
    """K2: `python -m oovrec_tpu_torch.cli.run --model=SASRecF
    --selected_features=[category]` in the shared CLI child on dataset/synth-ind
    (timestamps and the item category loaded, the paper protocol;
    K_EPOCHS_CLI epoch): rc 0, finite test metrics, the gathers' backward
    launched in the child; `--eval_only` on its checkpoint, in this
    process, reproduces them to 1e-9. → the child's launches."""
    argv = ["--model=SASRecF", "--dataset=synth-ind", "--data_path=dataset",
            "--selected_features=['category']",
            "--load_col={'inter': ['user_id','item_id','timestamp','is_new'], "
            "'item': ['item_id','category']}", f"--epochs={K_EPOCHS_CLI}"]
    out = cli_out("k2")
    counts, res, wall = cli_child("K2", argv, out)
    log(f"K2: python -m oovrec_tpu_torch.cli.run --model=SASRecF --selected_features=[category] "
        f"({K_EPOCHS_CLI} epoch) rc 0 in {wall:.1f} s (wall, in the shared CLI child, the "
        f"corpus included), test {res['test_result']}")
    again = cli_run.main([f"--eval_only={os.path.join(out, 'SASRecF-synth-ind.pth')}"])
    require(type(again["trainer"].model).__name__ == "SASRecF", "K2: the model")
    agree(res["test_result"], again["test_result"], "K2 eval_only test", tol=1e-9)
    log(f"K2: --eval_only == the run on the test metrics (1e-9); the run's launches {counts}")
    K_TIMES["K2 CLI run s"] = wall
    return counts


# phase L, the general models: the seven traditional models and the
# seven graph models on phase I's interactions read as a general dataset
# (MovieLens-1M's shape, RecBole's standard general benchmark: random order,
# RS 8:1:1 by user, full sort over the 3,707 items), at their YAML widths
L_TRADITIONAL = ("Pop", "Random", "ItemKNN", "EASE", "ADMMSLIM", "NCEPLRec", "SLIMElastic")
# the host solves (numpy, no device call), computed in a worker thread
# from the phase's set-up on, while L2, L3 and phase M run on the card
L_AHEAD = ("ADMMSLIM", "NCEPLRec")
L_GRAPH = ("LightGCN", "NGCF", "SGL", "SpectralCF", "GCMC", "DGCF", "NCL")
L_ZERO_DIAGONAL = {"EASE": "ease_B", "ADMMSLIM": "admm_W", "SLIMElastic": "slim_W"}
L_STEPS = 32           # L2: host steps of I_B rows a fit
L_COMPARE_STEPS = 4    # L2: graphed against eager steps, bit for bit (I_TIME_STEPS timed)
L_SEGMENT_REPS = 20    # the segment sum's timed calls
L_EPOCHS_CLI = 1       # L3
L_TIMES = {}
L_GATHERS = {}         # L2: the kernel's launches of each graph model's fit
L_CORPUS = {}          # the general dataset and its loaders, loaded once


def l_cfg(name, **over):
    """A general model's config at its YAML widths: I_B rows a step, one
    epoch, one uniform negative a row (the pairwise models' negative,
    GCMC's label-0 row), RS 8:1:1 by user in random order, full sort over
    the whole item set, 256 users a test batch."""
    d = {
        "model": name, "seed": SEED, "epochs": 1, "train_batch_size": I_B,
        "eval_batch_size": I_EVAL_ROWS * (I_ITEMS + 1), "learner": "adam",
        "learning_rate": 1e-3, "host_scan_steps": 1,
        "train_neg_sample_args": {"distribution": "uniform", "sample_num": 1},
        "eval_args": {"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                      "mode": "full"},
        "metrics": ["Recall", "MRR", "NDCG", "Hit"], "topk": [10, 20],
        "valid_metric": "MRR@10", "metric_decimal_place": 12, "device": DEVICE,
        "log_tensorboard": False, "checkpoint_dir": os.path.join("build", "general"),
        "dataset": I_DATASET, "data_path": I_DATA,
        "load_col": {"inter": ["user_id", "item_id", "timestamp"]},
    }
    d.update(over)
    return Config(d)


def l_corpus(ahead=True):
    """Phase I's `.inter` file (written again where absent) loaded as a
    general dataset, split once; its loaders, kept in L_CORPUS, and (where
    `ahead`) L1's host solves started in a worker thread."""
    t0 = time.perf_counter()
    path = os.path.join(I_DATA, I_DATASET, f"{I_DATASET}.inter")
    wrote = 0.0 if os.path.exists(path) else ml1m_inter_file()
    base = l_cfg("Pop")
    t1 = time.perf_counter()
    ds = create_dataset(base)
    # `Dataset.build` is deterministic: the phase splits once, and each
    # model's `build_model_and_state` reads the same training split
    splits = ds.build()
    ds.build = lambda: list(splits)
    loaders = data_preparation(base, ds)
    train, valid, test = (x.split for x in loaders)
    prepared = time.perf_counter() - t1
    require(type(ds).__name__ == "Dataset" and ds.item_num == I_ITEMS + 1
            and ds.user_num == I_USERS + 1, f"L: the dataset {type(ds)} {ds.item_num}")
    require(len(train) + len(valid) + len(test) == I_INTERS and len(train) > 0.79 * I_INTERS,
            f"L: the splits {len(train)} {len(valid)} {len(test)}")
    L_CORPUS.update(ds=ds, loaders=loaders,
                    ahead=l_states_ahead(loaders[0].split) if ahead else None)
    L_TIMES["set-up s"] = {"write": wrote, "create_dataset + data_preparation": prepared}
    log(f"L corpus: {I_INTERS} rows, {I_USERS} users, {I_ITEMS} items as a general dataset: "
        f"train {len(train)}, valid {len(valid)}, test {len(test)} (RS 8:1:1 by user); "
        f"set-up apart from the phase's times: the .inter file "
        f"{'written in %.1f s' % wrote if wrote else 'from phase I'}, `create_dataset` with "
        f"`data_preparation` {prepared:.1f} s ({time.perf_counter() - t0:.1f} s in all)")
    return ds, loaders


def l_states_ahead(train):
    """The L_AHEAD models' states (`build_estate`, numpy on the host and
    no device call: a CUDA-graph capture on the card refuses other
    threads' device work) from the training split, in a worker thread.
    → a future of {name: (state, seconds)}; its exception, if any, is
    raised where L1 reads it."""
    from concurrent.futures import ThreadPoolExecutor

    def solve():
        out = {}
        for name in L_AHEAD:
            t0 = time.perf_counter()
            out[name] = (get_model_class(name).build_estate(train, l_cfg(name)),
                         time.perf_counter() - t0)
        return out

    pool = ThreadPoolExecutor(1)
    future = pool.submit(solve)
    pool.shutdown(wait=False)
    return future


def l_build(cfg, ds, ahead=None):
    """`quick_start.build_model_and_state`, the model's `build_estate`
    timed inside it, or handing back `ahead` (a state and its seconds from
    `l_states_ahead`). → (model, the state's seconds (0 for Random, which
    has no state), the build's)."""
    cls = get_model_class(cfg["model"])
    if not hasattr(cls, "build_estate"):
        t0 = time.perf_counter()
        model = quick_start.build_model_and_state(cfg, ds)
        return model, 0.0, time.perf_counter() - t0
    own, inner = "build_estate" in cls.__dict__, cls.build_estate
    seconds = []

    def timed_state(split, config=None):
        if ahead is not None:
            seconds.append(ahead[1])
            return ahead[0]
        t0 = time.perf_counter()
        out = inner(split, config)
        sync()
        seconds.append(time.perf_counter() - t0)
        return out

    cls.build_estate = staticmethod(timed_state)
    try:
        t0 = time.perf_counter()
        model = quick_start.build_model_and_state(cfg, ds)
        sync()
        built = time.perf_counter() - t0
    finally:
        if own:
            cls.build_estate = staticmethod(inner)
        else:
            del cls.build_estate
    require(len(seconds) == 1, f"{cfg['model']}: build_estate ran {len(seconds)} times")
    return model, seconds[0], built


def unit_metrics(result, what):
    finite_metrics(result, what)
    require(all(0.0 <= float(v) <= 1.0 for v in result.values()),
            f"{what}: a metric outside [0, 1]: {result}")


def l1_traditional():
    """L1: the seven traditional models: the state built from the training
    split (timed: the host solves, ADMMSLIM's and NCEPLRec's in the worker
    thread of `l_states_ahead` while L2, L3 and phase M ran; SLIMElastic's
    on the card),
    `Trainer.fit` through its traditional branch (one valid pass, no
    epoch), the test pass; each model's own checks: a zero diagonal
    (EASE, ADMMSLIM, SLIMElastic), at most k non-zeros a row (ItemKNN),
    W ≥ 0 and the columns stopped by the rule or at max_iter
    (SLIMElastic), the top item the most counted (Pop), the same scores
    twice (Random). Launches no kernel. → {}."""
    ds, (train_loader, valid_loader, test_loader) = L_CORPUS["ds"], L_CORPUS["loaders"]
    train = train_loader.split
    counts = np.bincount(train.inter[train.iid_field], minlength=ds.item_num)
    users = {"user_id": torch.arange(1, 65, device=DEVICE)}
    t0 = time.perf_counter()
    ahead = L_CORPUS["ahead"].result()
    L_TIMES["L1 waited for the worker thread s"] = time.perf_counter() - t0
    for name in L_TRADITIONAL:
        what = f"L1 {name}"
        cfg = l_cfg(name)
        model, state_s, built_s = l_build(cfg, ds, ahead.get(name))
        trainer = Trainer(cfg, model)
        sync()
        t0 = time.perf_counter()
        score, valid = trainer.fit(train_loader, valid_loader, saved=False)
        sync()
        fit_s = time.perf_counter() - t0
        require(trainer.train_loss_dict == {} and trainer._global_step == 0,
                f"{what}: the traditional branch trained {trainer.train_loss_dict}")
        unit_metrics(valid, f"{what} valid")
        t0 = time.perf_counter()
        test = trainer.evaluate(test_loader, load_best_model=False)
        sync()
        test_s = time.perf_counter() - t0
        unit_metrics(test, f"{what} test")
        note = ""
        with torch.no_grad():
            if name in L_ZERO_DIAGONAL:
                m = getattr(model, L_ZERO_DIAGONAL[name])
                require(not bool(torch.diagonal(m).any()), f"{what}: a non-zero diagonal")
                note = "zero diagonal"
            if name == "ItemKNN":
                most = int((model.item_sim != 0).sum(dim=1).max())
                require(most <= model.k, f"{what}: {most} non-zeros in a row (k {model.k})")
                note = f"at most {most} non-zeros a row (k {model.k})"
            if name == "SLIMElastic":
                info = model.slim_info
                require(bool((model.slim_W >= 0).all()), f"{what}: a negative weight")
                require(info["stopped"] + info["max_iter"] == I_ITEMS, f"{what}: {info}")
                note += (f", W >= 0, {info['stopped']} columns stopped by the rule and "
                         f"{info['max_iter']} at max_iter after {info['sweeps']} sweeps")
                L_TIMES["SLIMElastic solve"] = info
            if name == "Pop":
                top = int(model.full_sort_scores(users)[0].argmax())
                require(counts[top] == counts.max(), f"{what}: top item {top}")
                note = f"top item {top}, the most counted ({int(counts.max())} rows)"
            if name == "Random":
                a, b = model.full_sort_scores(users), model.full_sort_scores(users)
                require(torch.equal(a, b) and bool((a >= 0).all()) and bool((a < 1).all()),
                        f"{what}: the scores do not repeat in [0, 1)")
                note = "the same scores twice, in [0, 1)"
        log(f"{what}: state {state_s:.2f} s{' (worker thread)' if name in ahead else ''} "
            f"(the build {built_s:.2f} s), fit (one valid "
            f"pass) {fit_s:.2f} s, test pass {test_s:.2f} s; {note + '; ' if note else ''}valid "
            f"{valid[cfg['valid_metric'].lower()]:.4f}, test {dict(test)}")
        L_TIMES[name] = {"state s": state_s, "build s": built_s, "fit s": fit_s,
                         "test pass s": test_s}
        del trainer, model
    return {}


def l_loader(cfg, train):
    """The model's training loader over the rows of L_STEPS batches of the
    training split: pairwise, or pointwise with a label-0 row a negative
    (GCMC: half the rows, two a batch row)."""
    input_type = get_model_class(cfg["model"]).input_type
    rows = L_STEPS * I_B // (2 if input_type == InputType.POINTWISE else 1)
    split = DatasetSplit.view(train.parent, train.index[:rows])
    return TrainBatcher(split, Sampler(["train"], [split], seed=SEED), cfg, input_type)


def l_segment_sum(model):
    """The edge segment sum at LightGCN's edges (`ops/embed_grad.py:
    segment_sum`, messages (E, D) at the model's destinations) with the
    edges' plan (the model's own, `planned("edge_dst")`) and without it:
    each against `scatter_rows_plain`, bit for bit on integer-valued
    messages, to 1e-6 of the largest sum on random ones (a row sums up to
    its degree's ~6,000 messages, in another order), and against a repeat
    run bit for bit; a call's ms (CUDA events, host included), its device
    ms and device activities from a profile, beside the plain version,
    `index_add_` (the library call, atomics) and the bound (the messages
    read once, the ids read once, the table written once). → the numbers."""
    dst, plan = model.planned("edge_dst")
    n = model.n_nodes
    e, d = dst.shape[0], model.embedding_size
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 1600)
    ints = torch.randint(-4, 5, (e, d), generator=g, device=DEVICE).float()
    msg = torch.randn((e, d), generator=g, device=DEVICE)
    want_ints = embed_grad.scatter_rows_plain(ints, dst, n)
    want = embed_grad.scatter_rows_plain(msg, dst, n)
    top = float(want.abs().max())
    out = {"edges": e, "rows": n, "D": d, "largest_sum": top}
    for route, p in (("plan", plan), ("no plan", None)):
        exact = torch.equal(embed_grad.segment_sum(ints, dst, n, plan=p), want_ints)
        kernel = lambda p=p: embed_grad.segment_sum(msg, dst, n, plan=p)  # noqa: E731
        a, b = kernel(), kernel()
        err = float((a - want).abs().max())
        require(exact and torch.equal(a, b) and err <= 1e-6 * top,
                f"L segment sum ({route}): integers exact {exact}, repeat {torch.equal(a, b)}, "
                f"max_abs_err {err} (largest sum {top})")
        device_ms, per, names = per_call(kernel, L_SEGMENT_REPS,
                                         f"profile the edge segment sum ({route})")
        out[route] = {"max_abs_err": err, "ms": time_ms(kernel, [()], L_SEGMENT_REPS),
                      "device_ms": device_ms, "launches_a_call": per, "kernels": names}
    require(out["plan"]["launches_a_call"] == 1,
            f"L segment sum: a call with the plan ran {out['plan']['kernels']}")
    dst64 = dst.long()
    plain = lambda: embed_grad.scatter_rows_plain(msg, dst, n)  # noqa: E731
    library = lambda: torch.zeros((n, d), device=DEVICE).index_add_(0, dst64, msg)  # noqa: E731
    out["plain_ms"], out["library_ms"] = (time_ms(f, [()], L_SEGMENT_REPS)
                                          for f in (plain, library))
    out["bound_ms"], out["bound_by"] = embed_grad_bound(e, d, dst.element_size(), n)
    # the first keys kept for the last lines: the plan route's numbers
    out.update({k: out["plan"][k] for k in ("max_abs_err", "ms", "device_ms")})
    log(f"L segment sum, {e} edges x {d} into {n} rows: bit for bit on integers and on a "
        f"repeat run on both routes (largest sum {top:.1f}); with the plan: ms a call "
        f"{out['plan']['ms']:.4f} (device {out['plan']['device_ms']:.4f}, "
        f"{out['plan']['launches_a_call']:.2f} device activities a call, max_abs_err "
        f"{out['plan']['max_abs_err']:.3g}); without: {out['no plan']['ms']:.4f} (device "
        f"{out['no plan']['device_ms']:.4f}, {out['no plan']['launches_a_call']:.2f} a call); "
        f"plain {out['plain_ms']:.4f}, index_add_ {out['library_ms']:.4f}, bound "
        f"{out['bound_ms']:.4f} ({out['bound_by']})")
    L_TIMES["segment sum"] = out
    return out


def l2_graph():
    """L2: LightGCN and the six graph models at their YAML widths on the
    host path (no model declares the device epoch): the edges of the
    training split (both directions, int32 on the card), a fit of L_STEPS
    steps of I_B rows through `Trainer.fit`, the losses finite and
    falling, every parameter moved, the kernel launched by the segment
    sums and the gathers' backward; the scanned full-sort test pass (it
    propagates the graph every batch); L_COMPARE_STEPS graphed steps ==
    eager ones bit for bit, and their ms a step. LightGCN's edges also
    time the segment sum (`l_segment_sum`). → the fits' launches."""
    ds, (train_loader, _, test_loader) = L_CORPUS["ds"], L_CORPUS["loaders"]
    train = train_loader.split
    counts = {}
    for name in L_GRAPH:
        what = f"L2 {name}"
        cfg = l_cfg(name)
        model, state_s, _ = l_build(cfg, ds)
        require(model.edge_src.shape[0] == 2 * len(train) and model.edge_src.dtype == torch.int32
                and model.edge_src.device.type == torch.device(DEVICE).type,
                f"{what}: the edges {tuple(model.edge_src.shape)} {model.edge_src.dtype}")
        if name == "LightGCN":
            l_segment_sum(model)
        trainer = Trainer(cfg, model)
        loader = l_loader(cfg, train)
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        normal, _, fit_s = f_fit(trainer, loader, what)
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        L_GATHERS[name] = seen["scatter_rows_kernel"]
        require(not trainer._device_epochs and normal["steps"] == L_STEPS,
                f"{what}: {normal['steps']} steps, device epochs {trainer._device_epochs}")
        require(seen["scatter_rows_kernel"] > 0, f"{what}: the kernel's launches {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(not still, f"{what}: parameters did not move over the fit: {still}")
        del before
        res, wall = timed_eval(model, cfg, test_loader, f"{what} test", device_eval=True)
        unit_metrics(res, f"{what} test")
        log(f"{what}: edges {model.edge_src.shape[0]} (state {state_s:.2f} s), {L_STEPS} host "
            f"steps, {len(trainer.params)} parameters moved, the kernel's launches "
            f"{seen['scatter_rows_kernel']} (segment sums and gathers' backward, a warm-up and "
            f"a capture); scanned test pass ({len(test_loader.split)} rows) {wall:.3f} s: "
            f"{dict(res)}")
        L_TIMES[f"{name} fit s"] = fit_s
        L_TIMES[f"{name} scanned test pass s"] = wall
        del trainer, loader, model

        def make(name=name):
            c = l_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), l_loader(c, train)

        host_graph_vs_eager(make, what, L_COMPARE_STEPS, part="L2", times=L_TIMES,
                            time_steps=I_TIME_STEPS)
        no_edge_sorts(what, L_TIMES[what], seen, fixed_edges=True)
    log("L2 the kernel's launches by model: " + json.dumps(L_GATHERS))
    return counts


def no_edge_sorts(what, times, fit_counts, fixed_edges):
    """A graph or knowledge model's fixed edges are sorted at its build
    alone: its fit built no plan, its timed steps' traces (graphed and
    eager, `graph_vs_eager_times`) show no plan build and, where the model
    owns fixed edges, no device-wide sort; the others' device-wide sorts
    are their batch ids above 16,384, the same in both traces."""
    eager, graph = times["eager"], times["graph"]
    require(fit_counts["build_plan"] == 0 and eager["plan_builds"] == graph["plan_builds"] == 0,
            f"{what}: plans built in the fit {fit_counts['build_plan']}, in the steps "
            f"{eager['plan_builds']} / {graph['plan_builds']}")
    require(graph["sorts"] == eager["sorts"] and not (fixed_edges and graph["sorts"]),
            f"{what}: sort kernels in the graphed steps {graph['sorts']}, eager {eager['sorts']}")
    log(f"{what}: no plan built in the fit or the steps; device-wide sort kernels in the "
        f"graphed replays {graph['sorts']} (eager {eager['sorts']})")


# L3's, M3's and N2's runs, one after another in the shared CLI child:
# name → (the run's directory, its launches, its wall s)
GENERAL_CLI = {}
L3_RUNS, M3_RUNS, N2_RUNS = ("LightGCN", "Pop"), ("MultiVAE", "NeuMF"), ("CKE",)
# N2 runs on the knowledge fixture tests/assets/toy-kg (phase N's corpus
# is written later, and its own load would cost the budget)
CLI_DATASETS = {"CKE": ("toy-kg", "tests/assets",
                        "--load_col={'inter': ['user_id','item_id','rating','timestamp']}")}


def general_cli_child(names):
    """`python -m oovrec_tpu_torch.cli.run --model=<name>` for each of
    `names` (L3_RUNS, M3_RUNS, N2_RUNS) in the shared child, on
    dataset/synth-ind (timestamps loaded; CKE on toy-kg, CLI_DATASETS),
    L_EPOCHS_CLI epoch: rc 0; each run's launches and wall kept in
    GENERAL_CLI. → the runs' wall s."""
    wall = 0.0
    for name in names:
        part = "l3" if name in L3_RUNS else "m3" if name in M3_RUNS else "n2"
        out = cli_out(f"{part}-{name.lower()}")
        dataset, path, load_col = CLI_DATASETS.get(name, (
            "synth-ind", "dataset",
            "--load_col={'inter': ['user_id','item_id','timestamp','is_new']}"))
        rc, lines, child, run_s = cli_process([
            f"--model={name}", f"--dataset={dataset}", f"--data_path={path}", load_col,
            f"--epochs={L_EPOCHS_CLI}", *cli_flags(out)])
        for line in lines:
            if "training [" in line or "test result" in line:
                log(f"  [{part.upper()} {name}] {line.split(' INFO ')[-1][:160]}")
        require(rc == 0, f"{part.upper()} {name}: rc {rc}: " + "\n".join(lines[-30:]))
        GENERAL_CLI[name] = (out, child, run_s, dataset)
        wall += run_s
    log(f"{', '.join(names)}: {len(names)} runs in the shared CLI child in {wall:.1f} s (runs "
        f"{[round(GENERAL_CLI[n][2], 1) for n in names]} s)")
    return wall


def general_cli_check(part, names, gathering):
    """`part`'s runs of the child (`general_cli_child`): finite test
    metrics in [0, 1], the gathers' backward launched by each run of
    `gathering` and no kernel by the others; `--eval_only` on each
    checkpoint, in this process, reproduces the run to 1e-9. → the runs'
    launches."""
    total = {k: 0 for k in kernel_counts()}
    for name in names:
        out, child, run_s, dataset = GENERAL_CLI[name]
        require(child.get("scatter_rows_kernel", 0) > 0 if name in gathering
                else not any(child.values()), f"{part} {name}: launches {child}")
        total = {k: total[k] + child.get(k, 0) for k in total}
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)
        unit_metrics(res["test_result"], f"{part} {name} test")
        again = cli_run.main([f"--eval_only={os.path.join(out, f'{name}-{dataset}.pth')}"])
        require(type(again["trainer"].model).__name__ == name, f"{part} {name}: the model")
        agree(res["test_result"], again["test_result"], f"{part} {name} eval_only test",
              tol=1e-9)
        log(f"{part}: python -m oovrec_tpu_torch.cli.run --model={name} ({L_EPOCHS_CLI} epoch) "
            f"rc 0 in {run_s:.1f} s, test {res['test_result']}; --eval_only == the run "
            f"(1e-9); launches {child}")
    return total


def l3_cli():
    """L3: LightGCN's and Pop's runs in the shared CLI child
    (`general_cli_child`, then M3's and N2's); LightGCN's run launched the
    kernel, no run of Pop's did. → the launches of L3's runs."""
    L_TIMES["L3, M3 and N2 CLI runs s"] = general_cli_child(L3_RUNS + M3_RUNS + N2_RUNS)
    L_TIMES["L3 CLI runs s"] = sum(GENERAL_CLI[n][2] for n in L3_RUNS)
    return general_cli_check("L3", L3_RUNS, ("LightGCN",))


# phase M, the rest of the general family, on L's corpus and split at the
# models' YAML widths: M1 the eight pair and pointwise embedding models on
# row batches, M2 the seven models trained on user batches
M_PAIRS = ("NeuMF", "DMF", "SimpleX", "FISM", "NAIS", "LINE", "ConvNCF", "NNCF")
M_USERS = ("MultiVAE", "MultiDAE", "CDAE", "RecVAE", "MacridVAE", "RaCT", "ENMF")
M_BLOCKED = ("NAIS", "ConvNCF", "NNCF")  # the blocked full sort, against the pairs
M_STEPS = 16           # M1: host steps of I_B rows a fit
M_COMPARE_STEPS = 4    # M1, M2: graphed against eager steps, bit for bit (I_TIME_STEPS timed)
M_USER_EPOCHS = 2      # M2: epochs of user batches of I_B (three an epoch)
M_STAGE_STEPS = 2      # M2: RaCT's critic_pretrain and finetune steps
M_SORT_USERS = 8       # M1: users of the blocked full sort held against the pairs
# M1: the slowest full sorts (36 and 54 TFLOP over the whole test split)
# run their scanned test pass over the first M_SLICE_USERS test users (2 of
# 24 batches), the whole split's time projected: a depth cut for the 750 s
# budget
M_SLICED, M_SLICE_USERS = ("NAIS", "ConvNCF"), 512
# M1: a parameter no loss moves: BPR reads the difference of two of
# ConvNCF's scores, in which `out`'s bias cancels (its gradient is 0)
M_UNMOVED = {"ConvNCF": ("out.bias",)}
# the models whose loss gathers no table row (their towers read rows of the
# training matrix): no gathers' backward
M_NO_GATHER = ("DMF", "MultiVAE", "MultiDAE", "RecVAE", "MacridVAE", "RaCT")
M_TIMES = {}
M_GATHERS = {}         # M1, M2: the gathers' backward launches of each model's fit


def m_loader(cfg, train):
    """The model's training loader over the rows of M_STEPS batches of the
    training split (pointwise: half the rows, a label-0 row a negative)."""
    input_type = get_model_class(cfg["model"]).input_type
    rows = M_STEPS * I_B // (2 if input_type == InputType.POINTWISE else 1)
    split = DatasetSplit.view(train.parent, train.index[:rows])
    return TrainBatcher(split, Sampler(["train"], [split], seed=SEED), cfg, input_type)


def m_test_users(loader, n=None):
    """The full-sort test loader over its first `n` users (all where None),
    its batches of the whole loader's shape."""
    if n is None:
        return loader
    part = copy.copy(loader)
    part.uid_list, part._pos, part._hist = loader.uid_list[:n], loader._pos[:n], loader._hist[:n]
    part.n_global_users = len(part.uid_list)
    return part


def m_blocked_sort(model, what, tol=1e-5):
    """The blocked full sort of M_SORT_USERS users against the per-pair
    definition (`_score` on every (user, item) pair in one call), to `tol`
    of the largest score. → max_abs_err."""
    users = torch.arange(1, M_SORT_USERS + 1, device=DEVICE)
    items = torch.arange(model.n_items, device=DEVICE)
    model.eval()
    with torch.no_grad():
        blocked = model.full_sort_scores({"user_id": users})
        pairs = model._score(users.repeat_interleave(model.n_items),
                             items.repeat(M_SORT_USERS)).reshape(M_SORT_USERS, -1)
    err, top = float((blocked - pairs).abs().max()), float(pairs.abs().max())
    require(bool(torch.isfinite(blocked).all()) and err <= tol * max(1.0, top),
            f"{what}: the blocked full sort is {err} from the pairs (largest {top})")
    log(f"{what}: blocked full sort of {M_SORT_USERS} users x {model.n_items} items == the "
        f"per-pair definition, max_abs_err {err:.3g} (largest score {top:.3g})")
    return err


def m1_pairs():
    """M1: NeuMF, DMF, SimpleX, FISM, NAIS, LINE, ConvNCF and NNCF at their
    YAML widths on the host path: the state built from the training split
    (timed: the padded histories, NNCF's neighbours, the training
    matrix); M_STEPS steps of I_B rows (one uniform negative a row, as a
    pairwise negative or a label-0 row) through `Trainer.fit`, finite
    falling losses, every parameter moved (but `M_UNMOVED`), the gathers'
    backward launched (none for DMF, `M_NO_GATHER`); the scanned full-sort
    test pass over the whole test split (`M_SLICED`: its first users); NAIS's,
    ConvNCF's and NNCF's blocked full sort against the per-pair
    definition; M_COMPARE_STEPS graphed steps == eager ones bit for bit,
    and the ms a step of each. NAIS's and ConvNCF's test pass runs over
    the first M_SLICE_USERS test users. → the fits' launches."""
    ds, (train_loader, _, test_loader) = L_CORPUS["ds"], L_CORPUS["loaders"]
    train = train_loader.split
    counts = {}
    for name in M_PAIRS:
        what = f"M1 {name}"
        cfg = l_cfg(name)
        model, state_s, _ = l_build(cfg, ds)
        trainer = Trainer(cfg, model)
        loader = m_loader(cfg, train)
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        normal, _, fit_s = f_fit(trainer, loader, what)
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        M_GATHERS[name] = seen["scatter_rows_kernel"]
        require(not trainer._device_epochs and normal["steps"] == M_STEPS,
                f"{what}: {normal['steps']} steps, device epochs {trainer._device_epochs}")
        require((seen["scatter_rows_kernel"] > 0) == (name not in M_NO_GATHER),
                f"{what}: the gathers' backward {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(still == list(M_UNMOVED.get(name, ())),
                f"{what}: parameters did not move over the fit: {still}")
        del before
        loader = m_test_users(test_loader, M_SLICE_USERS if name in M_SLICED else None)
        res, wall = timed_eval(model, cfg, loader, f"{what} test", device_eval=True)
        unit_metrics(res, f"{what} test")
        M_TIMES[name] = {"state s": state_s, "fit s": fit_s, "scanned test pass s": wall,
                         "test users": len(loader.uid_list)}
        if name in M_SLICED:
            M_TIMES[name]["whole test split projected s"] = (
                wall * len(test_loader.uid_list) / len(loader.uid_list))
        if name in M_BLOCKED:
            M_TIMES[name]["blocked max_abs_err"] = m_blocked_sort(model, what)
        moved = len(trainer.params) - len(still)
        log(f"{what}: state {state_s:.2f} s, {M_STEPS} host steps, {moved} parameters moved, "
            f"the gathers' backward {seen['scatter_rows_kernel']} launches; "
            f"scanned test pass ({len(loader.uid_list)} of {len(test_loader.uid_list)} test users) "
            f"{wall:.3f} s: {dict(res)}")
        del trainer, loader, model

        def make(name=name):
            c = l_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), m_loader(c, train)

        host_graph_vs_eager(make, what, M_COMPARE_STEPS, part="M1", times=M_TIMES,
                            time_steps=I_TIME_STEPS)
    log("M1 the gathers' backward launches by model: "
        + json.dumps({k: M_GATHERS[k] for k in M_PAIRS}))
    return counts


class Epochs:
    """`loader` over `n` epochs as one pass (a loader for more steps than
    one epoch of user batches holds)."""

    def __init__(self, loader, n):
        self.loader, self.n, self.split = loader, n, loader.split

    def __len__(self):
        return self.n * len(self.loader)

    def __iter__(self):
        for _ in range(self.n):
            yield from self.loader


def m_user_fit(trainer, loader, what, read=None):
    """`Trainer.fit` over `loader`, its losses finite; the parameters
    `read` names (all where None) moved, every other one unchanged bit for
    bit. → (losses, wall s)."""
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    losses = []
    inner = trainer._train_epoch

    def watched(*a, **k):
        total = inner(*a, **k)
        losses.extend(trainer.last_losses.tolist())
        return total

    trainer._train_epoch = watched
    sync()
    t0 = time.perf_counter()
    trainer.fit(loader, None, saved=False)
    sync()
    wall = time.perf_counter() - t0
    trainer._train_epoch = inner
    require(losses and np.isfinite(losses).all(), f"{what}: losses {losses}")
    read = set(before) if read is None else read
    moved = {n for n in before if not torch.equal(before[n], trainer.params[n])}
    require(moved == read, f"{what}: moved but not read {sorted(moved - read)}, read but "
            f"unmoved {sorted(read - moved)}")
    log(f"{what}: {len(losses)} steps in {wall:.2f} s, losses {[round(x, 4) for x in losses]}; "
        f"{len(moved)} parameters moved, {len(before) - len(moved)} unchanged bit for bit")
    return losses, wall


def m2_users():
    """M2: MultiVAE, MultiDAE, CDAE, RecVAE, MacridVAE, RaCT and ENMF at
    their YAML widths on user batches of I_B (`UserTrainBatcher`: three an
    epoch, the last padded): M_USER_EPOCHS epochs through `Trainer.fit`,
    finite losses, every parameter the loss reads moved and the others
    unchanged; RaCT trains `actor_pretrain` (its critic unchanged), then
    M_STAGE_STEPS steps of `critic_pretrain` (the actor unchanged) and of
    `finetune` (the critic unchanged) from that state; the scanned
    full-sort test pass; M_COMPARE_STEPS graphed steps == eager ones bit
    for bit (each trainer's dropout generator seeded alike), and the ms a
    step of each. → the fits' launches."""
    ds, (train_loader, _, test_loader) = L_CORPUS["ds"], L_CORPUS["loaders"]
    train = train_loader.split
    counts = {}
    for name in M_USERS:
        what = f"M2 {name}"
        cfg = l_cfg(name, epochs=M_USER_EPOCHS)
        model, state_s, _ = l_build(cfg, ds)
        trainer = Trainer(cfg, model)
        loader = UserTrainBatcher(train, cfg)
        require(len(loader) == 3, f"{what}: {len(loader)} user batches")
        hist = getattr(model, "user_hist_matrix", model.hist_items if name == "ENMF" else None)
        require(hist.device.type == torch.device(DEVICE).type and hist.shape[0] == I_USERS + 1,
                f"{what}: the state {tuple(hist.shape)} on {hist.device}")
        critic = {n for n in trainer.params if n.startswith("critic_")}
        reset_kernel_counts()
        losses, fit_s = m_user_fit(trainer, loader, what, set(trainer.params) - critic)
        seen = kernel_counts()
        require(len(losses) == 3 * M_USER_EPOCHS and not trainer._device_epochs
                and (seen["scatter_rows_kernel"] > 0) == (name not in M_NO_GATHER),
                f"{what}: {len(losses)} steps, launches {seen}")
        M_TIMES[name] = {"state s": state_s, "fit s": fit_s}
        if name == "RaCT":
            state = {k: v.clone() for k, v in model.state_dict().items()}
            for stage, read in (("critic_pretrain", critic),
                                ("finetune", set(trainer.params) - critic)):
                c = l_cfg(name, epochs=1, train_stage=stage)
                staged = quick_start.build_model_and_state(c, ds)
                staged.load_state_dict(state)
                t = Trainer(c, staged)
                batches = list(loader)[:M_STAGE_STEPS]
                _, M_TIMES[name][f"{stage} s"] = m_user_fit(t, batches, f"{what} {stage}", read)
                state = {k: v.clone() for k, v in staged.state_dict().items()}
                del t, staged
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        M_GATHERS[name] = seen["scatter_rows_kernel"]
        res, wall = timed_eval(model, cfg, test_loader, f"{what} test", device_eval=True)
        unit_metrics(res, f"{what} test")
        M_TIMES[name]["scanned test pass s"] = wall
        log(f"{what}: state {state_s:.2f} s, the gathers' backward "
            f"{seen['scatter_rows_kernel']} launches; scanned test pass "
            f"({len(test_loader.split)} rows) {wall:.3f} s: {dict(res)}")
        del trainer, loader, model

        def make(name=name):
            c = l_cfg(name)
            return (Trainer(c, quick_start.build_model_and_state(c, ds)),
                    Epochs(UserTrainBatcher(train, c), 2))

        host_graph_vs_eager(make, what, M_COMPARE_STEPS, part="M2", times=M_TIMES,
                            time_steps=I_TIME_STEPS)
    log("M2 the gathers' backward launches by model: "
        + json.dumps({k: M_GATHERS[k] for k in M_USERS}))
    return counts


def m3_cli():
    """M3: MultiVAE's and NeuMF's runs after L3's in the shared CLI child
    (`general_cli_child`): NeuMF's run launched the gathers' backward,
    MultiVAE's (rows of its matrix, no gather) launched nothing.
    → the launches of M3's runs."""
    M_TIMES["M3 CLI runs s"] = sum(GENERAL_CLI[n][2] for n in M3_RUNS)
    return general_cli_check("M3", M3_RUNS, ("NeuMF",))


# phase N, the knowledge models, on I's interactions (`ml1m_inter_file`)
# with a seeded knowledge graph beside them (`n_kg_files`), within the
# range of the KGAT paper's three KGs (Wang et al., KDD 2019, Table 1:
# 9-42 relations, 0.46-2.56 M triples): every item linked to its own
# entity, about N_ENTITIES entities, N_RELATIONS relations, N_TRIPLES
# triples, items the heads of N_ITEM_HEADS of them, the tails Zipf-skewed
# over the other entities, `kg_reverse_r` off; RS 8:1:1 by user, full sort
N_DATA, N_DATASET = os.path.join("build", "kg", "data"), "ml1m-kg"
N_ENTITIES, N_RELATIONS, N_TRIPLES, N_ITEM_HEADS, N_SEED = 60_000, 40, 500_000, 0.8, 17
N_MODELS = ("CKE", "CFKG", "KGAT", "KGCN", "KGNNLS", "MKR", "KTUP", "RippleNet", "KGIN",
            "MCCLK")
N_BLOCKED = ("KGCN", "KGNNLS", "MKR", "KTUP", "RippleNet")  # against the pairs
N_PLANNED = ("KGAT", "KGIN", "MCCLK")  # the models that own fixed edges (their plans)
N_STEPS = 16           # N1: host steps of I_B rows a fit
N_COMPARE_STEPS = 4    # N1: graphed against eager steps, bit for bit (I_TIME_STEPS timed)
N_SORT_TOL = 1e-6      # N1: blocked and hoisted full sorts against the pairs, of the largest
N_PROJ_EDGES = 65_536  # N1: KGAT's edges whose per-edge projections are held against the table
N_HOST_BATCHES = 8     # N1: KGTrainBatcher's and KGSampler's host ms a batch, over these
N_TIMES = {}
N_GATHERS = {}         # N1: the gathers' backward launches of each model's fit
N_CORPUS = {}          # the knowledge dataset, its loaders and its KGSampler, loaded once


def n_cfg(name, **over):
    """A knowledge model's config at its YAML widths: `l_cfg`'s protocol
    on phase N's corpus."""
    return l_cfg(name, dataset=N_DATASET, data_path=N_DATA,
                 checkpoint_dir=os.path.join("build", "kg"), **over)


def n_kg_files(seed=N_SEED):
    """Phase I's `.inter` (written again where absent) linked into
    `N_DATA/N_DATASET`, with the `.link` (item k ↔ entity e<k>) and the
    seeded `.kg` beside it. → wall s."""
    t0 = time.perf_counter()
    src = os.path.join(I_DATA, I_DATASET, f"{I_DATASET}.inter")
    if not os.path.exists(src):
        ml1m_inter_file()
    d = os.path.join(N_DATA, N_DATASET)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    dst = os.path.join(d, f"{N_DATASET}.inter")
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)
    items = np.arange(1, I_ITEMS + 1).astype(str)
    with open(os.path.join(d, f"{N_DATASET}.link"), "w") as f:
        f.write("item_id:token\tentity_id:token\n")
        f.write("\n".join(np.char.add(np.char.add(items, "\te"), items)) + "\n")
    rng = np.random.default_rng(seed)
    others = N_ENTITIES - I_ITEMS
    on_item = rng.random(N_TRIPLES) < N_ITEM_HEADS
    heads = np.where(on_item, np.char.add("e", rng.integers(1, I_ITEMS + 1, N_TRIPLES).astype(str)),
                     np.char.add("x", rng.integers(0, others, N_TRIPLES).astype(str)))
    pop = 1.0 / (np.arange(others) + 10.0) ** 0.8
    tails = np.char.add("x", rng.choice(others, N_TRIPLES, p=pop / pop.sum()).astype(str))
    rel_pop = 1.0 / (np.arange(N_RELATIONS) + 2.0)
    rels = np.char.add("r", rng.choice(N_RELATIONS, N_TRIPLES, p=rel_pop / rel_pop.sum())
                       .astype(str))
    with open(os.path.join(d, f"{N_DATASET}.kg"), "w") as f:
        f.write("head_id:token\trelation_id:token\ttail_id:token\n")
        f.write("\n".join(np.char.add(np.char.add(np.char.add(np.char.add(heads, "\t"), rels),
                                                  "\t"), tails)) + "\n")
    return time.perf_counter() - t0


def n_corpus():
    """Phase N's files (`n_kg_files`) loaded as a `KnowledgeBasedDataset`,
    split once; its loaders and the `KGSampler` of `data_preparation`,
    kept in N_CORPUS; the set-up timed apart."""
    t0 = time.perf_counter()
    wrote = n_kg_files()
    base = n_cfg("CKE")
    t1 = time.perf_counter()
    ds = create_dataset(base)
    created = time.perf_counter() - t1
    splits = ds.build()
    ds.build = lambda: list(splits)
    loaders = data_preparation(base, ds)
    prepared = time.perf_counter() - t1
    train, valid, test = (x.split for x in loaders)
    heads, _, tails = ds.kg_triples
    require(type(ds).__name__ == "KnowledgeBasedDataset" and ds.item_num == I_ITEMS + 1
            and ds.user_num == I_USERS + 1 and len(heads) == N_TRIPLES
            and ds.relation_num == N_RELATIONS + 2 and ds.item_num < ds.entity_num <= N_ENTITIES,
            f"N: the dataset {type(ds)} items {ds.item_num} entities {ds.entity_num} "
            f"relations {ds.relation_num} triples {len(heads)}")
    require(len(train) + len(valid) + len(test) == I_INTERS,
            f"N: the splits {len(train)} {len(valid)} {len(test)}")
    N_CORPUS.update(ds=ds, loaders=loaders, kg_sampler=loaders[0].kg_sampler)
    N_TIMES["set-up s"] = {"write": wrote, "create_dataset": created,
                           "create_dataset + data_preparation": prepared}
    edges = 2 * len(train) + 2 * len(heads)
    log(f"N corpus: {I_INTERS} rows, {I_USERS} users, {I_ITEMS} items, {ds.entity_num} "
        f"entities, {ds.relation_num} relations ([PAD] and [UI-Relation] included), "
        f"{len(heads)} triples ({int(np.isin(heads, np.arange(1, I_ITEMS + 1)).sum())} with an "
        f"item head); train {len(train)}, valid {len(valid)}, test {len(test)}; KGAT's "
        f"collaborative graph {edges} edges over {ds.user_num + ds.entity_num} nodes; set-up "
        f"apart from the phase's times: the files {wrote:.1f} s, `create_dataset` "
        f"{created:.1f} s, with `data_preparation` {prepared:.1f} s "
        f"({time.perf_counter() - t0:.1f} s in all)")
    return ds, loaders


def n_loader(cfg, train):
    """The model's `KGTrainBatcher` over the rows of N_STEPS batches of the
    training split (pointwise: half the rows, a label-0 row a negative),
    its triples from the dataset, its negative tails from the corpus'
    `KGSampler`."""
    input_type = get_model_class(cfg["model"]).input_type
    rows = N_STEPS * I_B // (2 if input_type == InputType.POINTWISE else 1)
    split = DatasetSplit.view(train.parent, train.index[:rows])
    return KGTrainBatcher(split, Sampler(["train"], [split], seed=SEED), cfg, input_type,
                          kg_dataset=N_CORPUS["ds"], kg_sampler=N_CORPUS["kg_sampler"])


def n_host_costs(loader):
    """KGTrainBatcher's host cost a batch of I_B rows against
    `TrainBatcher`'s on the same rows, and of it the `KGSampler`'s draw of
    the batch's negative tails (a Python loop over the rows), over
    N_HOST_BATCHES batches. → {name: [ms a batch]}."""
    out = {"TrainBatcher ms": [], "KGTrainBatcher ms": [], "KGSampler ms": []}
    for b in range(N_HOST_BATCHES):
        idx = np.arange(b * loader.step, (b + 1) * loader.step)
        t0 = time.perf_counter()
        TrainBatcher._make_batch(loader, idx)
        t1 = time.perf_counter()
        batch = loader._make_batch(idx)
        t2 = time.perf_counter()
        loader.kg_sampler.sample_negatives(batch["kg_head"], 1)
        t3 = time.perf_counter()
        for k, v in zip(out, (t1 - t0, t2 - t1, t3 - t2)):
            out[k].append(v * 1e3)
    log(f"N1 host: a batch of {len(batch['weight'])} rows, TrainBatcher "
        f"{np.median(out['TrainBatcher ms']):.1f} ms, KGTrainBatcher "
        f"{np.median(out['KGTrainBatcher ms']):.1f} ms, of it KGSampler "
        f"{np.median(out['KGSampler ms']):.1f} ms (medians of {N_HOST_BATCHES})")
    return out


def n_kgat_projection(model, what):
    """KGAT's per-relation projection table (`_projections`) against the
    per-edge definition W_r e_v at (rel, src) and (rel, dst) of
    N_PROJ_EDGES edges spread over the graph, to N_SORT_TOL of the
    largest. → max_abs_err."""
    n, R = model.n_nodes, model.n_relations
    D, K = model.embedding_size, model.kg_embedding_size
    edges = torch.linspace(0, len(model.ckg_src) - 1, N_PROJ_EDGES, device=DEVICE).long()
    with torch.no_grad():
        e = model.node_embedding.weight
        table = model._projections(e)
        rel = model.ckg_rel[edges].long()
        W = model.trans_w.reshape(R, D, K)[rel]
        err = top = 0.0
        for ids in (model.ckg_src[edges].long(), model.ckg_dst[edges].long()):
            per_edge = torch.einsum("ed,edk->ek", e[ids], W)
            err = max(err, float((table[rel * n + ids] - per_edge).abs().max()))
            top = max(top, float(per_edge.abs().max()))
    require(err <= N_SORT_TOL * max(1.0, top),
            f"{what}: the projection table is {err} from the per-edge products (largest {top})")
    log(f"{what}: the (R, N, K) projection table ({R} x {n} x {K}) == the per-edge W_r e_v "
        f"on {N_PROJ_EDGES} edges, max_abs_err {err:.3g} (largest {top:.3g})")
    return err


def n1_knowledge():
    """N1: CKE, CFKG, KGAT, KGCN, KGNNLS, MKR, KTUP, RippleNet, KGIN and
    MCCLK at their YAML widths on the host path: the state built from the
    training split (timed: KGAT's collaborative graph, KGCN's and
    KGNNLS's neighbours, RippleNet's ripple sets, KGIN's and MCCLK's
    edges); N_STEPS steps of I_B rows from `KGTrainBatcher` (one uniform
    negative a row, as a pairwise negative or a label-0 row; a triple and
    its negative tail a row) through `Trainer.fit`, finite losses, every
    parameter moved, the gathers' backward launched and no other kernel;
    the scanned full-sort test pass over the whole test split; KGCN's,
    KGNNLS's, MKR's, KTUP's and RippleNet's full sort against the
    per-pair definition for M_SORT_USERS users and KGAT's projection table
    against the per-edge products, to N_SORT_TOL; N_COMPARE_STEPS graphed
    steps == eager ones bit for bit, and the ms a step of the first
    I_TIME_STEPS. KGTrainBatcher's and KGSampler's host ms a batch first.
    → the fits' launches."""
    ds, (train_loader, _, test_loader) = N_CORPUS["ds"], N_CORPUS["loaders"]
    train = train_loader.split
    N_TIMES["host ms a batch"] = n_host_costs(train_loader)
    counts = {}
    for name in N_MODELS:
        what = f"N1 {name}"
        cfg = n_cfg(name)
        model, state_s, _ = l_build(cfg, ds)
        require(model.n_entities == ds.entity_num and model.n_relations == ds.relation_num,
                f"{what}: {model.n_entities} entities, {model.n_relations} relations")
        trainer = Trainer(cfg, model)
        loader = n_loader(cfg, train)
        before = {n: p.detach().clone() for n, p in trainer.params.items()}
        reset_kernel_counts()
        normal, _, fit_s = f_fit(trainer, loader, what, falls=False)
        seen = kernel_counts()
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        N_GATHERS[name] = seen["scatter_rows_kernel"]
        require(not trainer._device_epochs and normal["steps"] == N_STEPS,
                f"{what}: {normal['steps']} steps, device epochs {trainer._device_epochs}")
        require(seen["scatter_rows_kernel"] > 0
                and not any(n for k, n in seen.items() if k != "scatter_rows_kernel"),
                f"{what}: launches {seen}")
        still = [n for n in before if torch.equal(before[n], trainer.params[n])]
        require(not still, f"{what}: parameters did not move over the fit: {still}")
        del before
        res, wall = timed_eval(model, cfg, test_loader, f"{what} test", device_eval=True)
        unit_metrics(res, f"{what} test")
        N_TIMES[name] = {"state s": state_s, "fit s": fit_s, "scanned test pass s": wall}
        if name in N_BLOCKED:
            N_TIMES[name]["blocked max_abs_err"] = m_blocked_sort(model, what, tol=N_SORT_TOL)
        if name == "KGAT":
            N_TIMES[name]["projection max_abs_err"] = n_kgat_projection(model, what)
        log(f"{what}: state {state_s:.2f} s, {N_STEPS} host steps, {len(trainer.params)} "
            f"parameters moved, the gathers' backward {seen['scatter_rows_kernel']} launches; "
            f"scanned test pass ({len(test_loader.uid_list)} test users) {wall:.3f} s: "
            f"{dict(res)}")
        del trainer, loader, model

        def make(name=name):
            c = n_cfg(name)
            return Trainer(c, quick_start.build_model_and_state(c, ds)), n_loader(c, train)

        host_graph_vs_eager(make, what, N_COMPARE_STEPS, part="N1", times=N_TIMES,
                            time_steps=I_TIME_STEPS)
        no_edge_sorts(what, N_TIMES[what], seen, fixed_edges=name in N_PLANNED)
    log("N1 the gathers' backward launches by model: "
        + json.dumps({k: N_GATHERS[k] for k in N_MODELS}))
    return counts


def n2_cli():
    """N2: CKE's run after L3's and M3's in the shared CLI child
    (`general_cli_child`, on toy-kg at the YAML widths), run here if L3
    has not run: the gathers' backward launched, `--eval_only` == the run
    to 1e-9. → its launches."""
    if "CKE" not in GENERAL_CLI:
        general_cli_child(N2_RUNS)
    N_TIMES["N2 CLI run s"] = sum(GENERAL_CLI[n][2] for n in N2_RUNS)
    return general_cli_check("N2", N2_RUNS, ("CKE",))


# ---------------------------------------------------------------- phase O
# the mesh: one child process, one NCCL group of one rank (the card holds
# one; NCCL takes no two ranks on one device)
O_IDS, O_ROWS, O_DIM = 2048, 100_000, 64  # O1: the exchanges' lookup
O_REPS = 20             # O1: timed calls
O_STEPS = 16            # O3: mesh steps held against the plain trainer's
O_BPR_B = 2048          # O3: BPR's rows a step
O_EPOCHS_CLI = 1        # O4
O_TIMEOUT = 420         # s the child may take
O_TIMES = {}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def o1_exchange(mesh):
    """Both exchanges at S = 1 on NCCL against the plain gather."""
    from oovrec_tpu_torch.parallel import sharded_embedding as se

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    table = torch.randn(O_ROWS, O_DIM, generator=g, device=DEVICE)
    ids = torch.randint(0, O_ROWS, (O_IDS,), generator=g, device=DEVICE)
    cot = torch.randn(O_IDS, O_DIM, generator=g, device=DEVICE)
    leaf = table.clone().requires_grad_(True)
    plain = embed_grad.gather_rows(leaf, ids)
    (g_plain,) = torch.autograd.grad(plain, [leaf], cot)
    lookups = {
        "psum": lambda t: (se.psum_lookup(t, ids, mesh.model_group, 1, 0), None),
        "alltoall": lambda t: se.alltoall_lookup(t, ids, mesh.model_group, 1, 0),
    }

    def fwd_bwd(lookup, t):
        rows, _ = lookup(t)
        return torch.autograd.grad(rows, [t], cot)

    out, counted = {}, {}
    for kind, lookup in lookups.items():
        blk = table.clone().requires_grad_(True)
        before = dict(se.COLLECTIVES)
        launches.reset_launch_counts()
        rows, overflow = lookup(blk)
        (grad,) = torch.autograd.grad(rows, [blk], cot)
        sync()
        for k, v in launches.launch_counts().items():
            counted[k] = counted.get(k, 0) + v
        calls = {k: v - before.get(k, 0) for k, v in se.COLLECTIVES.items()
                 if v - before.get(k, 0)}
        require(torch.equal(rows, plain), f"O1 {kind}: rows differ from the plain gather")
        require(torch.equal(grad, g_plain), f"O1 {kind}: gradient differs from the plain one")
        over = 0 if overflow is None else int(overflow)
        require(over == 0, f"O1 {kind}: overflow {over}")
        out[kind] = {
            "collectives": calls, "overflow": over,
            "ms": time_ms(lambda: lookup(blk), [()], O_REPS),
            "fwd_bwd_ms": time_ms(lambda: fwd_bwd(lookup, blk), [()], O_REPS),
        }
    out["plain"] = {"ms": time_ms(lambda: embed_grad.gather_rows(leaf, ids), [()], O_REPS),
                    "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                        embed_grad.gather_rows(leaf, ids), [leaf], cot), [()], O_REPS)}
    log(f"O1 exchanges == the plain gather bit for bit: {json.dumps(out)}")
    return out, counted


def hits_of(run):
    """(the hits every collect_topk call received, the result) of `run()`."""
    from oovrec_tpu_torch.eval.collector import Collector

    seen, collect = [], Collector.collect_topk

    def recording(self, pos_idx, pos_len, weight, *a, **kw):
        seen.append((np.array(pos_idx), np.array(pos_len), np.array(weight)))
        return collect(self, pos_idx, pos_len, weight, *a, **kw)

    Collector.collect_topk = recording
    try:
        result = run()
    finally:
        Collector.collect_topk = collect
    return seen, result


def o2_serving(mesh):
    """Phase 3's IV full sort on the plain runner and under the mesh."""
    model = build_model()
    mapper = RandomOOVMapper(model.spec, N_OLD_USERS, N_OLD_ITEMS,
                             N_OLD_USERS + N_NEW_USERS, N_OLD_ITEMS + N_NEW_ITEMS)
    mapper.set_eval()
    _, iv_splits = synth_interactions(model, mapper)
    c = serving_cfg(True, N_OLD_ITEMS)
    EvalRunner(model, c).evaluate(loader(iv_splits, c))  # warm: kernel 1's library, allocator
    runs = {}
    for meshed in (False, True):
        c = serving_cfg(True, N_OLD_ITEMS)
        if meshed:
            c["use_mesh"], c["mesh"] = True, {"data": 1, "model": 1}
        runner = EvalRunner(model, c, mesh=mesh_from_cfg(c))
        iv_loader = loader(iv_splits, c)
        require(runner._use_fused(iv_loader.item_num), "O2: kernel 1 not on the path")
        launches.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        hits, result = hits_of(lambda: runner.evaluate(iv_loader))
        sync()
        wall = time.perf_counter() - t0
        runs[meshed] = (hits, dict(result), launches.launch_counts(), wall / len(iv_loader))
    (h0, r0, _, ms0), (h1, r1, counts, ms1) = runs[False], runs[True]
    require(r0 == r1, f"O2: mesh metrics {r1} vs plain {r0}")
    require(len(h0) == len(h1) and all(all(np.array_equal(a, b) for a, b in zip(x, y))
                                       for x, y in zip(h0, h1)), "O2: hits differ")
    require(counts["fused_topk_scores"] == len(iv_loader), f"O2: kernel 1 launches {counts}")
    O_TIMES["O2 ms a batch"] = {"mesh": ms1 * 1e3, "plain": ms0 * 1e3}
    log(f"O2 IV full sort under the mesh == plain bit for bit (hits, {r1}); "
        f"{ms1 * 1e3:.2f} ms a batch (wall) vs {ms0 * 1e3:.2f} plain")
    return counts


def mesh_from_cfg(cfg):
    from oovrec_tpu_torch.parallel.mesh import maybe_mesh_from_config

    return maybe_mesh_from_config(cfg)


def o_ctr_rows(n):
    """n seeded labelled rows over phase 4's field layout (old users and
    items)."""
    rng = np.random.default_rng(SEED + 23)
    user_feat = {"user_id": np.arange(N_CTR_OLD_USERS),
                 "gender": rng.integers(1, 3, N_CTR_OLD_USERS),
                 "age": rng.random(N_CTR_OLD_USERS).astype(np.float32),
                 "age__bucket": np.ones(N_CTR_OLD_USERS, np.int64)}
    item_feat = {"item_id": np.arange(N_CTR_OLD_ITEMS),
                 "category": rng.integers(1, 64, N_CTR_OLD_ITEMS),
                 "price": rng.random(N_CTR_OLD_ITEMS).astype(np.float32),
                 "price__bucket": np.ones(N_CTR_OLD_ITEMS, np.int64)}
    inter = {"user_id": rng.integers(1, N_CTR_OLD_USERS, n),
             "item_id": rng.integers(1, N_CTR_OLD_ITEMS, n), "hour": rng.integers(0, 25, n),
             "label": (rng.random(n) < 0.3).astype(np.float32)}
    return DatasetSplit(inter, N_CTR_OLD_USERS, N_CTR_OLD_ITEMS, user_feat=user_feat,
                        item_feat=item_feat)


def o3_pair(name, make_model, make_loader, cfg_over):
    """O_STEPS steps of the plain trainer and of the mesh trainer from one
    seed: losses and parameters bit for bit. → the mesh run's launches."""
    from oovrec_tpu_torch.parallel import train_step

    runs = {}
    for meshed in (False, True):
        over = dict(cfg_over, use_mesh=True, mesh={"data": 1, "model": 1}) if meshed else cfg_over
        cfg = Config(over)
        trainer = Trainer(cfg, make_model())
        reduce_ms, reduce = [], train_step.allreduce_grads

        def timed(grads, group, reduce=reduce, reduce_ms=reduce_ms):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = reduce(grads, group)
            end.record()
            reduce_ms.append((start, end))
            return out

        walls, step = [], trainer._step

        def timed_step(batch, frozen, step=step, walls=walls):
            sync()
            t0 = time.perf_counter()
            loss = step(batch, frozen)
            sync()
            walls.append(time.perf_counter() - t0)
            return loss

        train_step.allreduce_grads = timed
        trainer._step = timed_step
        try:
            launches.reset_launch_counts()
            trainer._train_epoch(make_loader(cfg), 0)
        finally:
            train_step.allreduce_grads = reduce
        # the first two steps warm up and capture the plain trainer's graph
        wall = float(np.median(walls[2:]))
        require(len(trainer.last_losses) == O_STEPS, f"O3 {name}: {len(trainer.last_losses)}")
        require(meshed == (trainer.mesh is not None), f"O3 {name}: mesh {trainer.mesh}")
        runs[meshed] = (trainer.last_losses.copy(),
                        {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
                        launches.launch_counts(), wall,
                        float(np.median([s.elapsed_time(e) for s, e in reduce_ms[2:]]))
                        if reduce_ms else 0.0)
        del trainer
    (l0, p0, _, ms0, _), (l1, p1, counts, ms1, red1) = runs[False], runs[True]
    require(np.array_equal(l0, l1), f"O3 {name}: losses {l1[:4]} vs {l0[:4]}")
    require(list(p0) == list(p1) and all(torch.equal(p0[n], p1[n]) for n in p0),
            f"O3 {name}: parameters differ")
    O_TIMES[f"O3 {name}"] = {"mesh ms a step": ms1 * 1e3, "plain ms a step": ms0 * 1e3,
                             "all-reduce ms a step": red1,
                             "all-reduce share": red1 / (ms1 * 1e3)}
    log(f"O3 {name}: {O_STEPS} mesh steps == the plain trainer's bit for bit; "
        f"{json.dumps(O_TIMES[f'O3 {name}'])}, launches {counts}")
    return counts


def o3_training():
    rows = o_ctr_rows(O_STEPS * CTR_B)
    seen_x = o3_pair("xDeepFM", lambda: build_ranking_model(SEED + 29),
                     lambda cfg: TrainBatcher(rows, None, cfg, InputType.POINTWISE),
                     ctr_train_dict(train_oov=False))
    require(seen_x["cin_layer_pooled"] > 0 and seen_x["cin_layer_pooled_bwd"] > 0,
            f"O3 xDeepFM: kernels 4 and 5 not on the mesh step: {seen_x}")
    rng = np.random.default_rng(SEED + 31)
    n = O_STEPS * O_BPR_B
    pairs = DatasetSplit({"user_id": rng.integers(1, N_OLD_USERS, n),
                          "item_id": rng.integers(1, N_OLD_ITEMS, n)}, N_OLD_USERS, N_OLD_ITEMS)
    bpr_cfg = {"seed": SEED, "train_batch_size": O_BPR_B, "learner": "adam",
               "learning_rate": 1e-3, "epochs": 1, "device_epoch": False,
               "host_scan_steps": 1, "train_oov": False,
               "train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}}
    seen_b = o3_pair("BPR", build_model, lambda cfg: TrainBatcher(
        pairs, Sampler(["train"], [pairs], seed=SEED), cfg, InputType.PAIRWISE), bpr_cfg)
    return {k: seen_x[k] + seen_b[k] for k in seen_x}


def o4_cli(port):
    """The `-m` entry's main under the mesh, then `--eval_only`."""
    out = cli_out("o")
    mesh_flags = ["--use_mesh=True", "--num_processes=1", "--process_id=0",
                  f"--coordinator_address=127.0.0.1:{port}"]
    argv = ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
            *[f for f in CLI_OOV if f != "--inductive_eval=True"],
            f"--epochs={O_EPOCHS_CLI}", *cli_flags(out), *mesh_flags]
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    res = cli_run.main(argv)
    wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    tr = res["trainer"]
    require(tr.mesh is not None and tr.mesh.shape == {"data": 1, "model": 1},
            f"O4: mesh {tr.mesh}")
    ckpt = os.path.join(out, "BPR-synth-ind.pth")
    require(os.path.isfile(ckpt), "O4: rank 0 wrote no checkpoint")
    finite_metrics(res["test_result"], "O4 test")
    again = cli_run.main([f"--eval_only={ckpt}", *mesh_flags])
    agree(dict(res["test_result"]), dict(again["test_result"]), "O4 eval_only", tol=1e-9)
    O_TIMES["O4 s"] = wall
    log(f"O4 cli.run.main under the mesh ({O_EPOCHS_CLI} epoch, synth-ind) in {wall:.1f} s, "
        f"checkpoint by rank 0, --eval_only == the run (1e-9): {dict(res['test_result'])}")
    return counts


# O5: one model of each loss class at its YAML widths on the mesh at one
# rank, from the files phases I, K, L and N write (the general dataset is
# L's, read from phase I's `.inter`; the sequential one K1's, with its
# `.item` and `.ent`; FM on O3's ranking rows)
O5_MODELS = ("FM", "GRU4Rec", "BERT4Rec", "S3Rec", "LightGCN", "SGL", "NCL", "SimpleX",
             "MultiVAE", "RaCT", "ENMF", "DirectAU", "KGAT", "MCCLK", "Pop")
O5_SEQ, O5_KG = ("GRU4Rec", "BERT4Rec", "S3Rec"), ("KGAT", "MCCLK")
O5_STEPS = 4            # O5: eager mesh steps held against the plain trainer's
O5_FM_EVAL_ROWS = 65_536  # O5: FM's test pass (the value eval)
O5_CORPUS = {}          # O5's datasets and loaders, loaded once in phase O's child


def o5_corpora():
    """The sequential, general and knowledge datasets of the files that
    phases I, K and N wrote, each split once, with their loaders, in
    O5_CORPUS (phase O's child loads them on its `load` line, while the
    script runs phases L-P)."""
    if O5_CORPUS:
        return O5_CORPUS
    t0 = time.perf_counter()
    for kind, base in (("seq", k_cfg("S3Rec")), ("general", l_cfg("Pop")),
                       ("kg", n_cfg("CKE"))):
        ds = create_dataset(base)
        splits = ds.build()
        ds.build = lambda splits=splits: list(splits)
        O5_CORPUS[kind] = (ds, data_preparation(base, ds))
    O_TIMES["O5 corpora s"] = time.perf_counter() - t0
    log(f"O5 corpora: {O_TIMES['O5 corpora s']:.1f} s")
    return O5_CORPUS


def o5_case(name):
    """(config dict, model, the O5_STEPS host batches, the test loader) of
    one representative."""
    def first(loader):
        out = []
        while len(out) < O5_STEPS:
            for hb in loader:
                out.append(hb)
                if len(out) == O5_STEPS:
                    break
        return out

    if name == "FM":
        cfg = ctr_train_dict(train_oov=False, device_eval=False)
        c = Config(cfg)
        model = e_ranking_model(name, SEED + 37)
        train = TrainBatcher(o_ctr_rows(O5_STEPS * CTR_B), None, c, InputType.POINTWISE)
        return cfg, model, first(train), PlainEvalBatcher(o_ctr_rows(O5_FM_EVAL_ROWS), c)
    kind = "seq" if name in O5_SEQ else "kg" if name in O5_KG else "general"
    ds, (train_loader, _, test) = o5_corpora()[kind]
    train = train_loader.split
    over = {"device_eval": False, "use_fused_topk": name == "DirectAU"}
    if kind == "seq":
        cfg = k_cfg(name)
        cfg = Config(dict(cfg.as_dict(), **over))
        split = SeqDatasetSplit(train.parent, train.index[: O5_STEPS * I_B])
        loader = TrainBatcher(split, None, cfg, InputType.POINTWISE)
    else:
        cfg = n_cfg(name, **over) if kind == "kg" else l_cfg(name, **over)
        cls = get_model_class(name)
        if getattr(cls, "train_on_users", False):
            loader = UserTrainBatcher(train, cfg)
        else:
            rows = O5_STEPS * I_B // (2 if cls.input_type == InputType.POINTWISE else 1)
            split = DatasetSplit.view(train.parent, train.index[:rows])
            sampler = Sampler(["train"], [split], seed=SEED)
            loader = (KGTrainBatcher(split, sampler, cfg, cls.input_type, kg_dataset=ds,
                                     kg_sampler=train_loader.kg_sampler) if kind == "kg"
                      else TrainBatcher(split, sampler, cfg, cls.input_type))
    model = quick_start.build_model_and_state(cfg, ds)
    return cfg.as_dict(), model, first(loader), test


def o5_pair(name):
    """O5_STEPS eager mesh steps (`use_mesh`, {data: 1, model: 1}) of one
    representative against the plain trainer's (captured) steps from the
    same state on the same host batches, the losses and every parameter
    bit for bit; then one test pass of each, the metrics bit for bit.
    → (the mesh run's launches, its ms a step, the plain one's)."""
    cfg, model, batches, test = o5_case(name)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = {}
    for meshed in (False, True):
        over = dict(cfg, use_mesh=True, mesh={"data": 1, "model": 1}) if meshed else cfg
        model.load_state_dict(start)
        trainer = Trainer(Config(over), model)
        require(meshed == (trainer.mesh is not None), f"O5 {name}: mesh {trainer.mesh}")
        model.train()
        launches.reset_launch_counts()
        walls, losses = [], []
        for hb in batches:
            sync()
            t0 = time.perf_counter()
            losses.append(trainer._step(trainer._to_device(hb), False))
            sync()
            walls.append(time.perf_counter() - t0)
        result = trainer.evaluate(test, load_best_model=False)
        sync()
        runs[meshed] = (torch.stack(losses).cpu(), {n: p.detach().clone() for n, p
                                                    in model.named_parameters()},
                        dict(result), launches.launch_counts(), float(np.median(walls[1:])))
        del trainer
    (l0, p0, r0, _, ms0), (l1, p1, r1, counts, ms1) = runs[False], runs[True]
    require(torch.isfinite(l1).all() and torch.equal(l0, l1),
            f"O5 {name}: losses {l1.tolist()} vs {l0.tolist()}")
    require(list(p0) == list(p1) and all(torch.equal(p0[n], p1[n]) for n in p0),
            f"O5 {name}: parameters differ")
    finite_metrics(r1, f"O5 {name} test")
    require(r0 == r1, f"O5 {name}: mesh test pass {r1} vs plain {r0}")
    return counts, ms1, ms0


def o5_models():
    """O5: each of O5_MODELS through `o5_pair`; kernel 1 on DirectAU's full
    sort (`use_fused_topk`: the ID towers; the graph models have none, here
    and in the JAX package) and the gathers' backward in the graph and
    knowledge steps on the mesh runs. → the mesh runs' launches."""
    o5_corpora()
    counts, times = {}, {}
    for name in O5_MODELS:
        seen, ms1, ms0 = o5_pair(name)
        counts = {k: counts.get(k, 0) + n for k, n in seen.items()}
        times[name] = {"mesh ms a step": ms1 * 1e3, "plain ms a step": ms0 * 1e3}
        if name == "DirectAU":  # the two-tower model: the graph models have no towers
            require(seen["fused_topk_scores"] > 0, f"O5 DirectAU: kernel 1 {seen}")
        if name in ("LightGCN", "SGL", "NCL", "KGAT", "MCCLK"):
            require(seen["scatter_rows_kernel"] > 0, f"O5 {name}: the gathers' backward {seen}")
        log(f"O5 {name}: {O5_STEPS} eager mesh steps == the plain trainer's bit for bit, "
            f"the test pass too; {json.dumps(times[name])}, launches {seen}")
    O_TIMES["O5"] = times
    return counts


def o_child(argv) -> int:
    """Phase O's process: started early (`start_phase_o`), it waits for a
    line on its stdin, then the NCCL bootstrap and O1-O4; their numbers
    and each part's launches into the JSON file `argv[1]`."""
    import torch.distributed as dist

    from oovrec_tpu_torch.parallel.distributed import backend_for, initialize_distributed
    from oovrec_tpu_torch.parallel.mesh import make_mesh

    port, out = int(argv[0]), argv[1]
    if sys.stdin.readline().strip() == "load":  # O5's corpora, ahead of the go
        o5_corpora()
        sys.stdin.readline()
    t0 = time.perf_counter()
    info = initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=DEVICE)
    require(dist.get_backend() == backend_for(DEVICE) and info["process_count"] == 1,
            f"O: {info}")
    mesh = make_mesh(1, 1)
    O_TIMES["bootstrap s"] = time.perf_counter() - t0
    log(f"O: NCCL process group {info} in {O_TIMES['bootstrap s']:.1f} s, mesh {mesh.shape}")
    seen, parts = {}, {}
    parts["O1"], seen["O1"] = o1_exchange(mesh)
    for part, run in (("O2", lambda: o2_serving(mesh)), ("O3", o3_training),
                      ("O4", lambda: o4_cli(port)), ("O5", o5_models)):
        t1 = time.perf_counter()
        seen[part] = run()
        O_TIMES[f"{part} s"] = time.perf_counter() - t1
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"O1": parts["O1"], "launches": seen, "times": O_TIMES}, f)
    return 0


O_CHILD = {}  # phase O's child, started by `start_phase_o`


def start_phase_o():
    """Start phase O's child, which imports this script and waits for
    `phase_o`: its start overlaps the kernels' build (a depth cut for the
    750 s budget, phase P). Killed at exit if `phase_o` never runs."""
    import atexit

    out = os.path.join("build", "phase_o.json")
    with contextlib.suppress(FileNotFoundError):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), "--phase-o",
                             str(free_port()), out], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    O_CHILD.update(proc=proc, out=out)


def o5_load():
    """Phase O's child loads O5's datasets (`o5_corpora`) now, from the
    files phases I, K and N wrote, ahead of its go (a depth cut for the
    750 s budget)."""
    proc = O_CHILD.get("proc")
    if proc is not None and proc.poll() is None:
        proc.stdin.write("load\n")
        proc.stdin.flush()


def phase_o():
    """Phase O in its child (started here unless `start_phase_o` ran); its
    checks, its numbers. → each part's launches."""
    if "proc" not in O_CHILD:
        start_phase_o()
    proc, out = O_CHILD.pop("proc"), O_CHILD.pop("out")
    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate("go\n", timeout=O_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    proc = SimpleNamespace(returncode=proc.returncode, stdout=stdout, stderr=stderr)
    for line in proc.stdout.splitlines():
        if line.startswith(("O", "phase", "  ")) or "Error" in line or "error" in line:
            log(f"  [O] {line[:400]}")
    require(proc.returncode == 0, f"phase O: rc {proc.returncode}: "
            + "\n".join((proc.stdout + proc.stderr).splitlines()[-40:]))
    with open(out) as f:
        res = json.load(f)
    seen = res["launches"]
    require(seen["O1"]["scatter_rows_kernel"] > 0 and seen["O2"]["fused_topk_scores"] > 0
            and seen["O3"]["cin_layer_pooled"] > 0 and seen["O3"]["cin_layer_pooled_bwd"] > 0
            and seen["O5"]["fused_topk_scores"] > 0 and seen["O5"]["scatter_rows_kernel"] > 0,
            f"phase O launches {seen}")
    O_TIMES.update(res["times"], O1=res["O1"], wall_s=time.perf_counter() - t0)
    log(f"phase O: {O_TIMES['wall_s']:.1f} s (from its child's go; the child's start "
        f"overlapped the build where `start_phase_o` ran first)")
    log("phase O times: " + json.dumps(O_TIMES))
    return seen


# ---------------------------------------------------------------- phase P
# the surfaces users reach for after a run: the hyper-parameter search by
# its `-m` entry in the shared CLI child (P1), the case study on phase A's
# checkpoint (P2), the cost report of xDeepFM (P3), the significance test
# (P4) and the TensorBoard writer (P5); BPR at D 64 on dataset/synth-ind
# with phase A's OOV flags, full-sort evals of 256 users a batch
P_ITEMS = 901           # synth-ind's item ids, the padding id 0 included
P_EVAL_USERS = 256      # users a full-sort eval batch (phase C's)
P_EPOCHS = 1            # epochs a trial, a seed's run (P4) and P5's run
P_EVALS, P_STARTUP = 3, 2  # P1: trials, the random ones before the TPE steps
P_HYPER = "learning_rate loguniform (1e-4, 1e-2)\nembedding_size choice [32, 64]\n"
# P1: the card's allocated bytes after the last trial may exceed those
# after the first by at most a few of the caching allocator's 2 MiB blocks
P_MEM_SLACK = 8 << 20
P_CASE_USERS, P_CASE_K = 256, 10  # P2
P_TIE = 1e-5            # P2: ranks whose neighbour scores within this are exempt
P_SEEDS = (2020, 2021)  # P4
P_TIMES = {}


def p_argv():
    """BPR on synth-ind with phase A's OOV flags, fused full-sort evals."""
    return ["--model=BPR", "--dataset=synth-ind", "--data_path=dataset", SYNTH_LOAD_COL,
            *[f for f in CLI_OOV if not f.startswith("--inductive_eval")],
            f"--epochs={P_EPOCHS}", "--use_fused_topk=True",
            f"--eval_batch_size={P_EVAL_USERS * P_ITEMS}", "--metric_decimal_place=12",
            f"--seed={SEED}", f"--device={DEVICE}"]


def p_config(**over):
    return {**parse_cli_args(p_argv()), **over}


def p1_hyper():
    """P1: `python -m oovrec_tpu_torch.cli.run_hyper` (bayes, P_STARTUP
    random trials then a TPE step, one epoch a trial) in the shared CLI
    child: rc 0, kernel 1 launched by every trial, the trials equal to
    the port's `HyperTuning` replayed here on the recorded scores, the best
    trial's test metrics reproduced to 1e-9 by one run of its parameters
    with `use_fused_topk` False, the card's allocated bytes after the last
    trial within P_MEM_SLACK of those after the first. → the search's
    launches."""
    from oovrec_tpu_torch.train.hyper_tuning import HyperTuning

    out = cli_out("p1")
    params, result = os.path.join(out, "p.hyper"), os.path.join(out, "hyper.txt")
    with open(params, "w") as f:
        f.write(P_HYPER)
    argv = [*p_argv(), "--algo=bayes", f"--n_startup={P_STARTUP}", f"--max_evals={P_EVALS}",
            f"--params_file={params}", f"--output_file={result}", f"--checkpoint_dir={out}"]
    rc, lines, child, wall = cli_process(argv, module="oovrec_tpu_torch.cli.run_hyper")
    require(rc == 0, f"P1: rc {rc}: " + "\n".join(lines[-30:]))
    trials = [json.loads(x[len("CLI trial "):]) for x in lines if x.startswith("CLI trial ")]
    require(len(trials) == P_EVALS
            and all(t["launches"]["fused_topk_scores"] > 0 for t in trials)
            and child["fused_topk_scores"] > 0, f"P1: trials {trials}, launches {child}")
    mem = [t["allocated"] for t in trials]
    require(mem[-1] <= mem[0] + P_MEM_SLACK, f"P1: allocated bytes after each trial {mem}")
    with open(result) as f:
        text = f.read()
    scores = [float(x.rsplit("valid_score: ", 1)[1]) for x in text.splitlines()
              if "valid_score: " in x]
    replay = iter(scores)
    ht = HyperTuning(lambda **kw: {"best_valid_score": next(replay)}, algo="bayes",
                     params_file=params, max_evals=P_EVALS, seed=SEED, n_startup=P_STARTUP)
    ht.run()
    again = os.path.join(out, "replayed.txt")
    ht.export_result(again)
    with open(again) as f:
        require(f.read() == text, f"P1: the replayed search differs:\n{text}")
    best_line = next(x for x in lines if x.startswith("test result of best run: "))
    best_test = ast.literal_eval(re.search(r"\{.*\}", best_line).group(0))
    fixed = p_config(**ht.best_params, use_fused_topk=False, checkpoint_dir=out)
    dense = quick_start.objective_function(config_dict=fixed)
    agree(best_test, dict(dense["test_result"]), "P1 best trial, dense eval", tol=1e-9)
    P_TIMES["P1 search s"] = wall
    P_TIMES["P1 allocated bytes after each trial"] = mem
    log(f"P1: python -m oovrec_tpu_torch.cli.run_hyper (bayes, {P_EVALS} trials, "
        f"{P_STARTUP} random) rc 0 in {wall:.1f} s; trials {ht.params_list}, valid "
        f"{scores}; kernel 1 a trial {[t['launches']['fused_topk_scores'] for t in trials]}; "
        f"== HyperTuning replayed; the best trial's test == its dense rerun (1e-9); "
        f"allocated after each trial {mem} bytes")
    return child


def p2_case_study():
    """P2: `case_study_from_checkpoint` on phase A's checkpoint for
    P_CASE_USERS users at k P_CASE_K, its items against kernel 1's top-k
    over the same towers and training-history bitmap: equal wherever the
    kernel's neighbouring scores differ by more than P_TIE. → {}."""
    from oovrec_tpu_torch.utils.case_study import case_study_from_checkpoint

    ckpt = os.path.join(CLI_DIR, "a", "BPR-synth-ind.pth")
    loaded = quick_start.load_data_and_model(ckpt)
    ds, model = loaded.dataset, loaded.model
    uids = np.arange(1, P_CASE_USERS + 1)
    tokens = [str(t) for t in ds.id2token(ds.uid_field, uids)]
    train = loaded.train_loader.split
    u_col, i_col = np.asarray(train.inter[ds.uid_field]), np.asarray(train.inter[ds.iid_field])
    hist = [np.unique(i_col[u_col == u]) for u in uids]
    width = max(1, max(len(h) for h in hist))
    items = torch.zeros((len(uids), width), dtype=torch.int64)
    for r, h in enumerate(hist):
        items[r, :len(h)] = torch.as_tensor(h)
    bitmap = build_hist_bitmap(items.to(DEVICE), torch.as_tensor([len(h) for h in hist],
                                                                 device=DEVICE), ds.item_num)
    counted = fused_topk_scores.launches  # the reference's launch is not the path's
    with torch.no_grad():
        batch = to_device_batch({ds.uid_field: uids}, DEVICE)
        k_vals, k_idx = fused_topk_scores(model.user_tower(batch).float().contiguous(),
                                          model.item_tower().float().contiguous(), bitmap,
                                          P_CASE_K + 1)
    fused_topk_scores.launches = counted
    k_vals, k_idx = k_vals.cpu().numpy(), k_idx.cpu().numpy().astype(np.int64)
    t0 = time.perf_counter()
    scores, top = case_study_from_checkpoint(tokens, ckpt, k=P_CASE_K)
    P_TIMES["P2 case study s"] = time.perf_counter() - t0
    got = np.stack([ds.token2id(ds.iid_field, [str(t) for t in row]) for row in top])
    require(got.shape == (len(uids), P_CASE_K) and np.isfinite(scores).all(),
            f"P2: {got.shape}, finite {np.isfinite(scores).all()}")
    gaps = np.abs(np.diff(k_vals, axis=1))          # (n, k): gap to the next rank
    near = np.zeros((len(uids), P_CASE_K), bool)
    near |= gaps[:, :P_CASE_K] <= P_TIE
    near[:, 1:] |= gaps[:, :P_CASE_K - 1] <= P_TIE
    same = got == k_idx[:, :P_CASE_K]
    require(same[~near].all(), f"P2: {int((~same & ~near).sum())} ranks differ from kernel 1")
    require(np.abs(scores - k_vals[:, :P_CASE_K]).max() <= 1e-4,
            f"P2: scores {np.abs(scores - k_vals[:, :P_CASE_K]).max()} from kernel 1's")
    log(f"P2: case_study_from_checkpoint ({len(uids)} users, k {P_CASE_K}) in "
        f"{P_TIMES['P2 case study s']:.1f} s == kernel 1's top-{P_CASE_K} over the same "
        f"towers and history bitmap at every rank but {int(near.sum())} exempt (a neighbour "
        f"within {P_TIE}; {int((~same).sum())} of them differ)")
    return {}


def p3_flops():
    """P3: `get_flops` of xDeepFM at its published widths on CTR_B rows,
    the CIN kernels launched, equal to the count of the same weights and
    batch on the CPU (the kernel wrappers' plain versions: `fused_cin`
    True there); `get_environment` and `get_device_usage`. → {}."""
    from oovrec_tpu_torch.utils.flops import get_device_usage, get_environment, get_flops

    rng = np.random.default_rng(SEED + 9)
    n_u, n_i = N_CTR_OLD_USERS, N_CTR_OLD_ITEMS
    split = DatasetSplit(
        {"user_id": rng.integers(1, n_u, CTR_B), "item_id": rng.integers(1, n_i, CTR_B),
         "hour": rng.integers(0, 25, CTR_B),
         "label": (rng.random(CTR_B) < 0.5).astype(np.float32)}, n_u, n_i,
        user_feat={"user_id": np.arange(n_u), "gender": rng.integers(1, 3, n_u),
                   "age": rng.random(n_u).astype(np.float32),
                   "age__bucket": np.ones(n_u, np.int64)},
        item_feat={"item_id": np.arange(n_i), "category": rng.integers(1, 64, n_i),
                   "price": rng.random(n_i).astype(np.float32),
                   "price__bucket": np.ones(n_i, np.int64)})
    batch = TrainBatcher(split, None, ctr_train_cfg(), InputType.POINTWISE)._make_batch(
        np.arange(CTR_B))
    card = build_ranking_model(SEED + 9)
    host = build_ranking_model(SEED + 9, device="cpu")
    host.load_state_dict(card.state_dict())
    card.fused_cin = host.fused_cin = True
    before = kernel_counts()
    t0 = time.perf_counter()
    on_card = get_flops(card, to_device_batch(batch, DEVICE))
    sync()
    P_TIMES["P3 get_flops on the card s"] = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernel_counts().items()}
    t0 = time.perf_counter()
    on_cpu = get_flops(host, to_device_batch(batch, "cpu"))
    P_TIMES["P3 get_flops on the CPU s"] = time.perf_counter() - t0
    require(launched["cin_layer_pooled"] > 0 and launched["cin_layer_pooled_bwd"] > 0,
            f"P3: launches {launched}")
    require(math.isfinite(on_card["flops_per_step"])
            and on_card["flops_per_step"] == on_cpu["flops_per_step"]
            and on_card["params"] == on_cpu["params"], f"P3: card {on_card}, CPU {on_cpu}")
    P_TIMES["P3 flops_per_step"] = on_card["flops_per_step"]
    log(f"P3: get_flops(xDeepFM, {CTR_B} rows) on the card, the CIN kernels launched "
        f"({launched['cin_layer_pooled']} forward, {launched['cin_layer_pooled_bwd']} backward): "
        f"{on_card}; on the CPU the same {on_cpu['flops_per_step']:.0f}")
    log(f"P3: get_environment {json.dumps(get_environment())}")
    log(f"P3: get_device_usage {get_device_usage()}")
    return {}


def p4_significance():
    """P4: `significance_test` of two learning rates over P_SEEDS, one
    epoch a run, kernel 1 in every eval: finite values. → {}."""
    from oovrec_tpu_torch.cli.significance_test import significance_test

    out = cli_out("p4")
    t0 = time.perf_counter()
    res = significance_test(p_config(learning_rate=1e-3, checkpoint_dir=out),
                            p_config(learning_rate=1e-2, checkpoint_dir=out),
                            seeds=list(P_SEEDS), metric="MRR@10")
    P_TIMES["P4 significance test s"] = time.perf_counter() - t0
    require(len(res["a_values"]) == len(res["b_values"]) == len(P_SEEDS)
            and all(math.isfinite(v) for v in res["a_values"] + res["b_values"]),
            f"P4: {res}")
    log(f"P4: significance_test (BPR lr 1e-3 vs 1e-2, seeds {list(P_SEEDS)}) in "
        f"{P_TIMES['P4 significance test s']:.1f} s: {json.dumps(res)}")
    return {}


def p5_tensorboard():
    """P5: one epoch with `log_tensorboard: true`: where
    `torch.utils.tensorboard` imports, the run's event files and their
    tags; where it does not, the writer off and nothing written. → {}."""
    from oovrec_tpu_torch.utils.tensorboard import get_tensorboard

    out = cli_out("p5")
    tb = os.path.join(out, "tb")
    cfg = p_config(log_tensorboard=True, tensorboard_dir=tb, checkpoint_dir=out)
    off = os.environ.pop("OOVREC_DISABLE_TENSORBOARD", None)
    try:
        t0 = time.perf_counter()
        res = quick_start.run(config_dict=cfg, saved=False)
        P_TIMES["P5 run s"] = time.perf_counter() - t0
        writer = get_tensorboard(res["config"], os.path.join(out, "probe"))
    finally:
        if off is not None:
            os.environ["OOVREC_DISABLE_TENSORBOARD"] = off
    finite_metrics(res["test_result"], "P5 test")
    if writer is None:
        require(not os.path.exists(tb), f"P5: {tb} written with the writer off")
        log("P5: torch.utils.tensorboard does not import here: the writer is off "
            "(get_tensorboard gives None) and the run wrote no event file, as the JAX "
            "package's contract says")
        return {}
    writer.close()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tags = set()
    for root, _, files in os.walk(tb):
        if any(f.startswith("events.out.tfevents.") for f in files):
            acc = EventAccumulator(root)
            acc.Reload()
            tags |= set(acc.Tags()["scalars"])
    want = {"Loss/Train", "Valid_score", "Valid/mrr@10", "hparam/best_valid_result"}
    require(want <= tags, f"P5: tags {sorted(tags)}")
    log(f"P5: one epoch with log_tensorboard true: event files under {tb}, tags {sorted(tags)}")
    return {}


SERVING = {}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # no event files from the script's hundreds of runs (the CLI child
    # inherits it); P5 lifts it for its own run
    os.environ["OOVREC_DISABLE_TENSORBOARD"] = "1"

    log(f"card: {smi}")
    t_start = t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(cuda_build.build_kernels, ["topk_score", "cin_fused",
                                                          "cin_fused_bwd", "sparse_rows",
                                                          "embed_grad"])
        # while nvcc runs (a depth cut for the 750 s budget, phase P): the
        # shared CLI child and phase O's child start, and the profiler's
        # first window, which sets its tracing up (about 12 s), opens and
        # closes
        cli_server()
        start_phase_o()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=DEVICE).add_(1)
            sync()
        log(f"the CLI and phase O children started, the profiler set up: "
            f"{time.perf_counter() - t0:.1f} s")
        # and the host's work of later phases: phase C's files, phase I's
        # corpus, phase N's files and corpus (their set-up times logged as
        # before, apart from their phases')
        c_corpus()
        i_corpus()
        n_corpus()
        log(f"phases C, I and N's corpora: {time.perf_counter() - t0:.1f} s")
        built = building.result()
    log(f"build: {built} ({time.perf_counter() - t0:.1f} s)")
    for name, out in cuda_build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernel_cases()
    cin_cases()
    cin_bwd_cases()
    sparse_rows_cases()
    embed_grad_times = embed_grad_timing(embed_grad_cases())
    timing = kernel_timing()
    cin_times = cin_timing()
    cin_times.update(cin_bwd_timing())
    sparse_times = sparse_rows_timing()
    launches = serving()
    cin_launches, ind, mapper = ranking()
    train_launches = ranking_training(ind, mapper)
    retrieval_training()
    sparse_launches, gather_launches = retrieval_sparse_training()
    t0 = time.perf_counter()
    cli_retrieval()
    embed_grad.scatter_rows_kernel.launches = 0
    cli_b, _ = cli_ranking()
    gathers_b = embed_grad.scatter_rows_kernel.launches
    embed_grad.scatter_rows_kernel.launches = 0
    k6_c, k1_c, _ = cli_corpus()
    gathers_c = embed_grad.scatter_rows_kernel.launches
    log(f"CLI phases A-C: {time.perf_counter() - t0:.1f} s")
    # phase D, the embedders; each kernel's launches counted by part
    t0 = time.perf_counter()
    on_d = {}
    for part, run in (("D1", d1_embedders), ("D2", d2_ranking_lsh), ("D3", d3_fdhe_serving),
                      ("D4", lsh_device_epoch)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        # a part that compares a kernel with its plain path resets that
        # kernel's count itself and returns the main run's
        on_d[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_d[part]}")
    gathers, gather_bound = gather_backward_ms()
    log(f"phase D: {time.perf_counter() - t0:.1f} s")
    require(on_d["D2"]["cin_layer_pooled"] > 0 and on_d["D2"]["cin_layer_pooled_bwd"] > 0
            and on_d["D3"]["fused_topk_scores"] > 0 and on_d["D4"]["sparse_adam_rows_kernel"] > 0
            and all(on_d[p]["scatter_rows_kernel"] > 0 for p in ("D1", "D2")),
            f"phase D launches {on_d}")
    # phase E, the paper's other three models; counted by part as D is
    t0 = time.perf_counter()
    on_e = {}
    for part, run in (("E1", e1_ranking_track), ("E2", e2_dcnv2),
                      ("E3", lambda: e3_ranking(ind, mapper)), ("E4", e4_directau)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_e[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_e[part]}")
    log(f"phase E: {time.perf_counter() - t0:.1f} s")
    require(on_e["E4"]["fused_topk_scores"] > 0 and on_e["E4"]["sparse_adam_rows_kernel"] > 0
            and all(on_e[p]["scatter_rows_kernel"] > 0 for p in ("E1", "E2", "E3")),
            f"phase E launches {on_e}")
    # phase F, the device-resident and scanned paths; counted by part
    t0 = time.perf_counter()
    on_f = {}
    for part, run in (("F1", lambda: f1_xdeepfm_plain(ind)), ("F2", lambda: f2_pointwise(ind)),
                      ("F3", f3_bpr_fdhe), ("F4", lambda: f4_host_scan(ind)),
                      ("F5", f5_scanned_eval)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_f[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_f[part]}")
    log(f"phase F: {time.perf_counter() - t0:.1f} s")
    require(on_f["F1"]["cin_layer_pooled"] > 0 and on_f["F1"]["cin_layer_pooled_bwd"] > 0
            and on_f["F4"]["cin_layer_pooled"] > 0 and on_f["F3"]["sparse_adam_rows_kernel"] > 0
            and on_f["F5"]["fused_topk_scores"] > 0
            and all(on_f[p]["scatter_rows_kernel"] > 0 for p in ("F1", "F2", "F4")),
            f"phase F launches {on_f}")
    # the graphed passes' kernels, as their profiler traces show them
    require(all(F_TRACE[p]["cin_layer_pooled"] > 0 and F_TRACE[p]["cin_layer_pooled_bwd"] > 0
                for p in ("F1", "F4"))
            and all(F_TRACE[p]["scatter_rows_kernel"] > 0 for p in ("F1", "F2", "F3", "F4")),
            f"phase F graphed traces {F_TRACE}")
    log("phase F kernels replayed, from the traces: " + json.dumps(F_TRACE))
    log("phase F times: " + json.dumps(F_TIMES))
    # phase G, the trainer's leftovers and LR / FM / DeepFM / FFM; counted
    # by part as F is (a part whose checks reset counts returns its own)
    t0 = time.perf_counter()
    on_g, f_trace = {}, dict(F_TRACE)
    for part, run in (("G1", lambda: g1_learners(ind)), ("G2", g2_dynamic), ("G3", g3_cli),
                      ("G4", lambda: g4_zoo(ind))):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_g[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_g[part]}")
    log(f"phase G: {time.perf_counter() - t0:.1f} s")
    g_trace = {p: c for p, c in F_TRACE.items() if p not in f_trace}
    require(on_g["G1"]["cin_layer_pooled"] > 0 and on_g["G1"]["cin_layer_pooled_bwd"] > 0
            and on_g["G2"]["fused_topk_scores"] > 0 and on_g["G3"]["cin_layer_pooled_bwd"] > 0
            and on_g["G3"]["sparse_adam_rows_kernel"] > 0
            and all(on_g[p]["scatter_rows_kernel"] > 0 for p in ("G1", "G3", "G4")),
            f"phase G launches {on_g}")
    require(g_trace["G1"]["cin_layer_pooled"] > 0 and g_trace["G1"]["cin_layer_pooled_bwd"] > 0
            and g_trace["G4"]["scatter_rows_kernel"] > 0, f"phase G graphed traces {g_trace}")
    log("phase G kernels replayed, from the traces: " + json.dumps(g_trace))
    log("phase G times: " + json.dumps(G_TIMES))
    # phase H, the rest of the context zoo; counted by part as G is
    t0 = time.perf_counter()
    on_h, g_done = {}, dict(F_TRACE)
    for part, run in (("H1", lambda: h1_zoo(ind, mapper)), ("H2", h2_cli)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_h[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_h[part]}")
    log(f"phase H: {time.perf_counter() - t0:.1f} s")
    h_trace = {p: c for p, c in F_TRACE.items() if p not in g_done}
    require(all(on_h[p]["scatter_rows_kernel"] > 0 for p in ("H1", "H2")),
            f"phase H launches {on_h}")
    require(h_trace["H1"]["scatter_rows_kernel"] > 0, f"phase H graphed traces {h_trace}")
    log("phase H kernels replayed, from the traces: " + json.dumps(h_trace))
    log("phase H times: " + json.dumps(H_TIMES))
    # phase I, the sequential family; counted by part as H is
    t0 = time.perf_counter()
    on_i, h_done = {}, dict(F_TRACE)
    for part, run in (("I1", i1_sequential), ("I2", i2_cli)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_i[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_i[part]}")
    log(f"phase I: {time.perf_counter() - t0:.1f} s")
    i_trace = {p: c for p, c in F_TRACE.items() if p not in h_done}
    require(all(on_i[p]["scatter_rows_kernel"] > 0 for p in ("I1", "I2")),
            f"phase I launches {on_i}")
    require(i_trace["I1"]["scatter_rows_kernel"] > 0, f"phase I graphed traces {i_trace}")
    log("phase I kernels replayed, from the traces: " + json.dumps(i_trace))
    log("phase I times: " + json.dumps(I_TIMES))
    # phase J, the rest of the plain sequence models; counted by part as I is
    t0 = time.perf_counter()
    on_j, i_done = {}, dict(F_TRACE)
    for part, run in (("J1", j1_sequential), ("J2", j2_cli)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_j[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_j[part]}")
    log(f"phase J: {time.perf_counter() - t0:.1f} s")
    j_trace = {p: c for p, c in F_TRACE.items() if p not in i_done}
    require(all(on_j[p]["scatter_rows_kernel"] > 0 for p in ("J1", "J2")),
            f"phase J launches {on_j}")
    require(j_trace["J1"]["scatter_rows_kernel"] > 0, f"phase J graphed traces {j_trace}")
    log("phase J kernels replayed, from the traces: " + json.dumps(j_trace))
    log("phase J times: " + json.dumps(J_TIMES))
    # phase K, the last seven sequential models; counted by part as J is
    t0 = time.perf_counter()
    on_k, j_done = {}, dict(F_TRACE)
    for part, run in (("K1", k1_sequential), ("K2", k2_cli)):
        reset_kernel_counts()
        sync()
        t1 = time.perf_counter()
        seen = run()
        sync()
        on_k[part] = {**kernel_counts(), **seen}
        log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {on_k[part]}")
    log(f"phase K: {time.perf_counter() - t0:.1f} s")
    k_trace = {p: c for p, c in F_TRACE.items() if p not in j_done}
    require(all(on_k[p]["scatter_rows_kernel"] > 0 for p in ("K1", "K2")),
            f"phase K launches {on_k}")
    require(k_trace["K1"]["scatter_rows_kernel"] > 0, f"phase K graphed traces {k_trace}")
    log("phase K kernels replayed, from the traces: " + json.dumps(k_trace))
    log("phase K times: " + json.dumps(K_TIMES))
    o5_load()  # phase O's child loads O5's corpora while phases L-P run
    # phases L and M, the general models on one corpus, counted by part as
    # K is. L1 runs last: its host solves (a worker thread from `l_corpus`
    # on) finish while L2, L3 and phase M run on the card
    t_l = t0 = time.perf_counter()
    l_corpus()
    on_l, on_m, k_done = {}, {}, dict(F_TRACE)

    def parts(counts, runs):
        for part, run in runs:
            reset_kernel_counts()
            sync()
            t1 = time.perf_counter()
            seen = run()
            sync()
            counts[part] = {**kernel_counts(), **seen}
            log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches "
                f"{counts[part]}")

    parts(on_l, (("L2", l2_graph), ("L3", l3_cli)))
    l_s = time.perf_counter() - t0
    l_trace = {p: c for p, c in F_TRACE.items() if p not in k_done}
    t0, l_done = time.perf_counter(), dict(F_TRACE)
    parts(on_m, (("M1", m1_pairs), ("M2", m2_users), ("M3", m3_cli)))
    log(f"phase M: {time.perf_counter() - t0:.1f} s")
    m_trace = {p: c for p, c in F_TRACE.items() if p not in l_done}
    t0 = time.perf_counter()
    parts(on_l, (("L1", l1_traditional),))
    log(f"phase L: {l_s + time.perf_counter() - t0:.1f} s (L2, L3, then L1 after phase M; "
        f"L and M {time.perf_counter() - t_l:.1f} s)")
    require(all(on_l[p]["scatter_rows_kernel"] > 0 for p in ("L2", "L3"))
            and not any(on_l["L1"].values()), f"phase L launches {on_l}")
    require(l_trace["L2"]["scatter_rows_kernel"] > 0, f"phase L graphed traces {l_trace}")
    log("phase L kernels replayed, from the traces: " + json.dumps(l_trace))
    log("phase L times: " + json.dumps(L_TIMES))
    require(all(on_m[p]["scatter_rows_kernel"] > 0 for p in ("M1", "M2", "M3"))
            and not any(n for c in on_m.values() for k, n in c.items()
                        if k != "scatter_rows_kernel"),
            f"phase M launches {on_m} (kernels 1-6 none, the gathers' backward in each part)")
    require(all(m_trace[p]["scatter_rows_kernel"] > 0 for p in ("M1", "M2")),
            f"phase M graphed traces {m_trace}")
    log("phase M kernels replayed, from the traces: " + json.dumps(m_trace))
    log("phase M times: " + json.dumps(M_TIMES))
    # phase N, the knowledge models, on their own corpus; counted by part as
    # M is (N2's run went with L3's in the shared CLI child)
    t0, n_done, on_n = time.perf_counter(), dict(F_TRACE), {}
    parts(on_n, (("N1", n1_knowledge), ("N2", n2_cli)))
    log(f"phase N: {time.perf_counter() - t0:.1f} s (its corpus loaded while the kernels "
        f"built)")
    n_trace = {p: c for p, c in F_TRACE.items() if p not in n_done}
    require(all(on_n[p]["scatter_rows_kernel"] > 0 for p in ("N1", "N2"))
            and not any(n for c in on_n.values() for k, n in c.items()
                        if k not in ("scatter_rows_kernel", "build_plan")),
            f"phase N launches {on_n} (kernels 1-6 none, the gathers' backward in each part; "
            "plans built with KGAT's, KGIN's and MCCLK's models)")
    require(n_trace["N1"]["scatter_rows_kernel"] > 0, f"phase N graphed traces {n_trace}")
    log("phase N kernels replayed, from the traces: " + json.dumps(n_trace))
    log("phase N times: " + json.dumps(N_TIMES))
    # phase P, the surfaces after a run; counted by part as N is (P1's run
    # in the shared CLI child, whose launches it returns)
    t0, on_p = time.perf_counter(), {}
    parts(on_p, (("P1", p1_hyper), ("P2", p2_case_study), ("P3", p3_flops),
                 ("P4", p4_significance), ("P5", p5_tensorboard)))
    P_TIMES["wall s"] = time.perf_counter() - t0
    log(f"phase P: {P_TIMES['wall s']:.1f} s")
    require(on_p["P1"]["fused_topk_scores"] > 0 and on_p["P3"]["cin_layer_pooled"] > 0 and on_p["P3"]["cin_layer_pooled_bwd"] > 0
            and on_p["P4"]["fused_topk_scores"] > 0 and on_p["P5"]["fused_topk_scores"] > 0,
            f"phase P launches {on_p}")
    log(f"{smi}; phase P times: " + json.dumps(P_TIMES))
    stop_cli_server()
    # phase O, the mesh, in a child process of its own
    on_o = phase_o()
    cli = {  # each kernel's launches on the CLI paths (A launches none)
        "fused_topk_scores": {"C": k1_c},
        "cin_layer_pooled": {"B": cli_b["cin_layer_pooled"]},
        "cin_layer": {"B": cli_b["cin_layer"]},
        "cin_layer_pooled_bwd": {"B": cli_b["cin_layer_pooled_bwd"]},
        "cin_layer_bwd": {"B": cli_b["cin_layer_bwd"]},
        "sparse_adam_rows_kernel": {"C": k6_c},
        "scatter_rows_kernel": {"B": gathers_b, "C": gathers_c},
    }

    kernels = [{
        "name": "fused_topk_scores",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/topk_score.cu",
        "replaces": "oovrec_tpu/ops/topk_score.py:134",
        "launches": launches,
        **timing,
    }, {
        "name": "cin_layer_pooled",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:368",
        "launches": cin_launches["cin_layer_pooled"],
        **cin_times["cin_layer_pooled"],
    }, {
        "name": "cin_layer",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:129",
        "launches": cin_launches["cin_layer"],
        **cin_times["cin_layer"],
    }, {
        "name": "cin_layer_pooled_bwd",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused_bwd.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:414",
        "launches": train_launches["cin_layer_pooled_bwd"],
        **cin_times["cin_layer_pooled_bwd"],
    }, {
        "name": "cin_layer_bwd",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/cin_fused_bwd.cu",
        "replaces": "oovrec_tpu/ops/cin_fused.py:155",
        "launches": train_launches["cin_layer_bwd"],
        **cin_times["cin_layer_bwd"],
    }, {
        "name": "sparse_adam_rows_kernel",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/sparse_rows.cu",
        "replaces": "oovrec_tpu/ops/sparse_rows.py:127",
        "launches": sparse_launches,
        **sparse_times,
    }, {
        # not a Pallas kernel: the backward of the JAX package's custom-VJP
        # gather; its launches are the device-epoch run's (3 a step)
        "name": "scatter_rows_kernel",
        "route": "cuda",
        "source": "oovrec_tpu_torch/csrc/embed_grad.cu",
        "replaces": "oovrec_tpu/ops/embed_grad.py:90",
        "launches": gather_launches,
        **embed_grad_times,
    }]
    for k in kernels:
        k["launches_cli"] = cli[k["name"]]
        k["launches_d"] = {part: c[k["name"]] for part, c in on_d.items()}
        k["launches_e"] = {part: c[k["name"]] for part, c in on_e.items()}
        k["launches_f"] = {part: c[k["name"]] for part, c in on_f.items()}
        k["launches_f_trace"] = {part: c[k["name"]] for part, c in f_trace.items()}
        k["launches_g"] = {part: c[k["name"]] for part, c in on_g.items()}
        k["launches_g_trace"] = {part: c[k["name"]] for part, c in g_trace.items()}
        k["launches_h"] = {part: c[k["name"]] for part, c in on_h.items()}
        k["launches_h_trace"] = {part: c[k["name"]] for part, c in h_trace.items()}
        k["launches_i"] = {part: c[k["name"]] for part, c in on_i.items()}
        k["launches_i_trace"] = {part: c[k["name"]] for part, c in i_trace.items()}
        k["launches_j"] = {part: c[k["name"]] for part, c in on_j.items()}
        k["launches_j_trace"] = {part: c[k["name"]] for part, c in j_trace.items()}
        k["launches_k"] = {part: c[k["name"]] for part, c in on_k.items()}
        k["launches_k_trace"] = {part: c[k["name"]] for part, c in k_trace.items()}
        k["launches_l"] = {part: c[k["name"]] for part, c in on_l.items()}
        k["launches_l_trace"] = {part: c[k["name"]] for part, c in l_trace.items()}
        k["launches_m"] = {part: c[k["name"]] for part, c in on_m.items()}
        k["launches_m_trace"] = {part: c[k["name"]] for part, c in m_trace.items()}
        k["launches_n"] = {part: c[k["name"]] for part, c in on_n.items()}
        k["launches_n_trace"] = {part: c[k["name"]] for part, c in n_trace.items()}
        k["launches_o"] = {part: c[k["name"]] for part, c in on_o.items()}
        k["launches_p"] = {part: c[k["name"]] for part, c in on_p.items()}
    log("gathers' backward (ops/embed_grad.py, not a Pallas kernel): " + json.dumps({
            "ms": gathers, "bound_ms": gather_bound,
            "device_epoch": GATHER_RESULTS.get("device_epoch"), "cases": EMBED_GRAD_TIMES}))
    log("the edge segment sum (ops/embed_grad.py:segment_sum, the same kernel): "
        + json.dumps(L_TIMES["segment sum"]))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(o_child(sys.argv[2:]) if sys.argv[1:2] == ["--phase-o"] else main())
