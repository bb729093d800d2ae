"""Smoke test of the PyTorch port (imagetranslate_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card, drives the serving path at BERT-base width
(encode -> KV-cached beam search, then the translate CLI end to end), the
supervised training path at the same width (MTTrainer steps, then the training
CLI end to end), the unsupervised-MT path (MASS steps, then
back-translation steps, through MTTrainer and through the training CLI) and
the long-sequence path (a 2048-token source through encode and beam search,
the masked LM and the long-document LM through their trainers and CLIs) and
the captioning path (ResNet grid -> beam search over the grid, the text +
image and the grid + object dual decodes, the caption CLI's loop and the CLI
itself) and caption training (CaptionTrainer's caption, object, MT-stream
and multimodal steps, its epoch loop and dev decode, then the binarize ->
train -> caption CLIs) and image MT training (ImageMTTrainer's multimodal
MASS, contrastive, text MASS and MT steps, back-translation with images,
then cli.train_mt --train -> cli.translate and mmid_sim), the sentence
similarity and caption -> image models (SenSim and Caption2Image steps,
translate_img's three decode rounds, their four CLIs), the MoE FFN (MT
steps and the beam decode of an MoE model), the object detector (Faster
R-CNN at 800 pixels, cli.extract_objects, cli.caption --obj), packed MT
training (steps on 64 x 256 packed rows, cli.train_mt --pack --profile) and
the tensor- and data-parallel path (the beam decode through the
vocab-sharded projection K2b on four ranks that share the card,
cli.train_mt --mesh 2x2, cli.translate --dp 2), ZeRO-1, the pipeline and
expert parallelism, the other trainers and CLIs on meshes (the MLM, the
long-document LM's sequence parallelism, SenSim, Caption2Image, captioning,
image MT under ZeRO-1), layer and FFN recompute
(remat, remat_ffn) in full-width training, the ITR1 record files through the
binarizer, training and translation CLIs with the native host libraries, and
the recipe ladder (cli.recipe_check), and checks that each path went through
its kernels.

Run from the root of a checkout, with one visible CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  — card name and power limit, sm_90, TF32 off.
  2. build   — nvcc build of imagetranslate_tpu_torch/csrc/*.cu.
  3. kernel  — project_topk kernel vs its plain version: random cases at
               V=32000 for every decode path's M (256, 128, 32, 768), ragged
               M (100, 1000) and M=1, each at k = 1, 4, 16, the caption
               trainer's dev decode (M=80, k=5), and at ragged
               vocab sizes (84, 30522, 32003: a last tile and range with
               fewer columns than k), values and lse within 1e-4 and
               indices equal wherever the next candidate is more than that
               away; exact tie cases at every boundary of the kernel's
               work (a thread's columns, the quad that shares a row, two
               vocab tiles of a block, two ranges, one tie in each of 125
               ranges, a ragged last range, all-equal rows); two launches
               bit-equal at M=256 and M=768; kernel and library chain
               (F.linear bf16 + torch.topk + torch.logsumexp, a yardstick)
               in turns at (M, k) = (256, 4), (768, 4), (128, 1), (32, 4)
               with each bound, the plain version at M=256, and the
               kernel's two launches apart by torch.profiler.
  4. decode  — BERT-base (V=32000, 768, 12 heads, 3072, 6+3 layers, bf16,
               random weights from a numpy seed) encode + beam_search at
               B=64, S=64, beam 4, L=88; LAUNCHES must equal the decode steps.
               Then the same model in fp32 at B=8, S=16: K2's plain version
               on the card, no K2 launch.
  5. cli     — a tokenizer trained on a generated corpus, a full-width
               checkpoint at its vocab, and cli.translate.main on 50 lines.
  6. kernel  — the fused dropout attention kernels (forward and backward) vs
     (K1)      their plain versions, element by element under the shared
               Philox mask: forward and dq, dk, dv, dbias at rate 0 and 0.1,
               both bias layouts, at the training shape (B=256, T=S=64, H=12,
               D=64), the packed shape (B=32, T=S=256), the MLM step's
               (B=16, T=S=512), T != S, and ragged shapes at the gate's edges
               (S = 257, 511, 512 at D = 16, 64, 128), the decoder's shapes of
               phase 7 (T=S=63; T=63, S=64) and the shapes of the MASS and
               back-translation steps of phases 10 and 11 (the MASS decoder's
               T=S=32 and T=32, S=64; the translation buffer's odd width 81
               as the encoder's T=S) and of the caption steps of phase 19
               (T=S=31, and T=31 over the S=49 grid slots and S=16
               detections, at B=32 and B=8; the MT stream's B=128 at T=S=64,
               T=S=63 and T=63, S=64) and of the image MT steps of phase 20
               (the multimodal MASS decoder's T=16 over S=16, 32 and 49 at
               B=32 and B=8; T=S=32 for the captions and the negatives; the
               text MASS steps' B=128 at T=S=32 and T=32, S=64) and of
               phase 21 (the SenSim pairs and pools at B=128, S=64, the
               Caption2Image captions at B=32, T=32, and every batch shape
               of its two training CLIs' batchers) and of phase 24 (the
               packed rows' B=64 at T=S=256, T=S=255 and T=255 over S=256,
               and the bucketed batches of the same pairs); bf16 outputs within
               2^-6 of the plain result's largest magnitude (a few bf16 ulps), fp32 dbias
               within 1e-4 of it. S = 513 and fp32 inputs raise before a
               launch; two launches on the same inputs give the same bits.
               Mask statistics straight from the kernel (keep rate within 4
               sigma, same seed -> same output, another seed -> another
               mask). Times of kernel, plain version and
               F.scaled_dot_product_attention (a yardstick, never on the
               path), forward and backward, taken in turns, at the training
               and the MLM shape; kernel times at the packed shape.
  7. train   — MTTrainer at BERT-base width (fp32 masters, bf16 compute,
               dropout 0.1) on numpy batches of B=256, S=T=64 over the full
               vocabulary: 3 warm-up steps, 9 timed; the loss is finite and
               falls; forward and backward launches = 12 per step, each at a
               shape that phase 6 held against the plain version. Then a
               paired reading of the same step with the fused cross-entropy
               (use_pallas_xent) off and on: two fresh trainers from one seed
               on the same batches, first losses equal to 1e-4, then blocks
               of steps in the order off, on, on, off; ms/step and peak
               memory of each arm.
  8. train   — generated parallel corpus -> cli.train_tokenizer ->
     cli       cli.create_mt_batches -> cli.train_mt.main at full width ->
               cli.translate.main on the checkpoint it wrote ->
               load_checkpoint with the optimizer state -> cli.score_pairs
               (forced scores of 8 sources x 4 candidates, the shard window
               --resume 1 --end 8).

  9. kernel  — the fused label-smoothed cross-entropy kernels (forward and
     (K5)      backward; runs between phases 6 and 7) vs their plain version:
               the MT step's shape (N=16128, V=32000), the MASS step's
               (N=8192), phase 20's text MASS step's (N=4096), phase 24's
               packed step's (N=16320) and its bucketed batches', the
               back-translation step's, ragged V (84, 30522,
               32003), N not a multiple of 8, N=1, fp32 and bf16 logits,
               eps 0 and 0.1, targets outside the vocabulary, an all-masked
               g, and two shapes past 2^31 bytes (one of them past 2^31
               elements); loss rows within 1e-4 relative, dx within 1e-6 +
               1e-4 relative (fp32) or one bf16 ulp (bf16). Times of kernel,
               plain version and F.cross_entropy(label_smoothing=) (a
               yardstick, never on the path) at N=16128, V=32000.
 10. umt     — MTTrainer with use_pallas_xent at BERT-base width: MASS steps
     train     on numpy MassBatches (B=256, S=64, full vocabulary), then
               reset_for_finetune and back-translation steps (greedy decode
               with frozen weights + an MT step on the synthetic pairs, B=128);
               losses finite, the MASS loss falls, parameters change, K5
               launches = 1 + 1 per train step, K1 launches = 12 + 12 per
               train step, K2 launches = the decodes' steps; every shape the
               steps give K1 and K5 was held against the plain version.
 11. umt     — two generated monolingual corpora -> a two-language tokenizer
     cli       -> monolingual shards (data.binarize.write_mt) ->
               cli.train_mt.main --mass_train --step --fstep --langs from a
               checkpoint whose config.json sets use_pallas_xent ->
               cli.translate.main on the result; the same launch and shape
               checks as phase 10.

 12. kernel  — the flash attention kernel (runs between phases 9 and 7) vs its
     (K3)      plain version (the same tile-by-tile arithmetic in tensor ops)
               and, on a sample of query rows, vs an fp64 computation, with a
               padding bias (rows padded to random lengths, one row wholly
               padded, the bias a view of a wider buffer) and without one:
               B=8, T=S=2048, H=12, D=64; S = 1024, 1032, 1536, 4096, 5000;
               T=64 and T=8 against S=2048; a ragged T=2000; D=32 and D=128;
               shapes ragged around the 128-query and 128-key tiles
               ((2, 1000, 1031, 4, 64), (2, 129, 1087, 3, 128),
               (1, 8, 1025, 2, 32), (3, 1153, 2049, 2, 64)); the shape phase
               13's CLI batches have; bf16 outputs within 2^-7 of the plain
               result's largest magnitude and 2^-6 of the fp64 one's. Outside
               the gate (fp32 on the card, a per-query bias, T < 8) the
               dispatch takes the plain attention and the wrapper raises, as
               it does on strides or dtypes the kernel cannot read; the
               gradient behind the kernel equals the plain attention's; two
               launches at B=8, T=S=2048 are bit-equal. Times at B=8,
               T=S=2048, H=12, D=64, in turns: the kernel with the bias and
               without, F.scaled_dot_product_attention with the mask and
               without (a yardstick, never on the path), its plain version
               and the plain attention; TFLOP/s, the share of the bound and
               the time of the exponentials alone on the SFUs; the kernel at
               D=32 (H=24) and D=128 (H=6).
 13. long    — BERT-base with 2048 positions, bf16: encode + beam_search
     source    (beam 4, L=2048) on B=8 sources of 2048 tokens: K3 launches = 6
               (one per encoder layer, none in the decode), K2 launches = the
               decode steps. Then the encode alone with use_pallas_attention
               on and off, blocks in the order on, off, off, on: tokens/s of
               each, outputs within 2^-4 of the largest value. Then 6 lines of
               1025..1040 tokens through cli.translate.main (the tokenizer
               cuts a line at 512 tokens: no K3 launch) and, whole, through
               the CLI's build_model + translate_batches: 6 K3 launches per
               batch.
 14. lm      — LMTrainer at the LM CLI's default width (768/12/3072, 6 layers,
               512 positions, V=32000, fp32 masters, bf16 compute) over
               generated block files: train_epoch of 10 steps at B=16, T=512
               (the masked-budget projection) with a validation and both
               checkpoint slots, then 8 timed steps; the loss falls, every
               parameter changes, K1 launches = 6 + 6 per step (one forward
               and one backward per encoder layer), each at a shape phase 6
               held, no K3 or K5 launch. Then a paired reading of the MLM
               step with fused_attn_dropout off and on: two trainers from one
               seed, blocks of 4 steps in the order off, on, on, off (three
               times), ms/step median and spread and positions/s of each
               arm, K1 launches counted per block. Then a 2048-position LM
               of the same width: validate_and_save on two dev batches of
               B=8, T=2048: 6 K3 launches per batch, dev loss within 5e-4
               relative of the same evaluation with use_pallas_attention off.
               Then LongDocTrainer.from_options at preset 3 (hidden 256, 6
               layers, 4096 positions): train_epoch of 6 steps at B=8, T=4096
               with a validation, then 6 timed steps.
 15. lm cli  — documents -> cli.create_batches -> cli.train_lm -> cli.train_lm
               --reformer --size 1 -> cli.train_mt --lm (the weights start
               from the LM's) -> cli.translate, through files.

 16. kernel  — the beam decode attention kernel (runs after phase 12) vs its
     (K4)      plain version: the gather form (no row maps, a slice of a
               longer cache read in place) at every shape phases 17, 18,
               19, 21 and 22 launch (R = 256, 768, 32, 96, 80 rows; 1 .. L-1
               live positions)
               and at edge shapes (one position, 7, 88, 512 and 20000
               positions, D = 8, 24, 32, 64, 128, odd row counts); with random
               rowsel/wanc row maps on the TPU kernel's own inputs (window
               only, an unaligned prefix of 44, the first and the last
               window slot); shapes whose work plan splits a row over a
               cluster of blocks, or keeps its scores in the fp32 scratch,
               with and without row maps (R=32, n=2048 up to n=57344);
               bf16 outputs within 2^-7 of the plain result's largest
               magnitude; two launches bit-equal at R=256 and R=768. What
               the kernel cannot take raises before a launch. Times of
               kernel, plain version and F.scaled_dot_product_attention (a
               yardstick, never on the path) at R=256, n=88 and R=768, n=32,
               H=12, D=64; then kernel and SDPA at the live positions the
               decodes sweep (R=256: n = 1, 8, 22, 44, 88; R=768: n = 1, 8,
               16, 32), at R=32, n=2048, R=3, H=2, n=20000 and R=2,
               n=40000, each also after a read flush of L2, and the sums
               over one MT and one caption decode.
 17. decode  — phase 4's decode with decode_attention_impl="fused": K4
     K4        launches = 3 per step, each at a shape phase 16 held; beside it
               the same decode with "onehot" on the same weights, blocks in
               the order fused, onehot, onehot, fused: tok/s of each, the
               share of equal tokens, and the two results' sequence scores
               under one model within 2e-2 relative.
 18. caption — ImageSeq2Seq at BERT-base width with the ResNet-18 grid
               encoder at 224 pixels and the object stream, bf16, random
               weights and batch statistics from a numpy seed: the bf16 grid
               against an fp32 model's on 4 images (within 2^-4 of the
               largest value); encode_images + beam_search at B=192, beam 4,
               L=32 on uint8 images (K4 = 3 a step, K2 = 1 a step);
               beam_search_dual over text + image and over grid + objects
               (K4 = 6 a step); cli.caption.caption_batches over batches
               built from arrays (a full batch, a tail, a tail with
               detections); images/s and peak memory of each; then, where
               Pillow is installed, cli.caption.main over a folder of 20
               JPEGs written here.
 19. caption — CaptionTrainer at the CLI's defaults (768/12/3072, 6 + 6
     train     layers, ResNet-18 at 224, V=32000, fp32 masters, bf16
               compute, dropout 0.1, use_pallas_xent on) on numpy batches of
               B=32 uint8 images and T=32 captions: 3 warm-up and 9 timed
               caption steps (the loss falls, every BatchNorm statistic
               moves, K1 = 12 + 12 a step at shapes phase 6 held, K5 = 0);
               train_epoch over array batchers, the caption stream and the
               MT stream (B=128, S=T=64: K1 = 18 + 18 a step) interleaved,
               with the prefetch thread, the meter and a .latest save;
               caption_images of 16 images at beam 5, L=32 (K2 = 1 and K4 =
               6 a step, at (M, k) and (R, n) phases 3 and 16 held); the
               object step with 16 detection slots (10 live, a row with
               none) and the image tower frozen (K1 = 24 + 24 a step; the
               ResNet's parameters bit-equal, its statistics moved) and its
               grid + objects dev decode (K4 = 12 a step); a paired reading
               of the caption step with fused_attn_dropout off and on on one
               trainer (blocks off, on, on, off; launches not counted); then,
               where Pillow is installed, JPEGs ->
               cli.binarize_captions_from_list -> cli.train_captioning (3
               steps) -> cli.caption. Before the CLIs, CaptionTrainer with
               mm_mode "mixed": train_epoch over 4 caption batches, each
               trained by multimodal MASS (K1 = 30 + 30) or the contrastive
               step (12 + 12) as the host draws of its step say, K5 = 0.
 20. image   — ImageMTTrainer at cli.train_mt's defaults (768/12/3072, 6 + 6
     MT        layers, ResNet-18 at 224, V=32000, fp32 masters, bf16
               compute, dropout 0.1, use_pallas_xent on) on numpy batches:
               ticks of an image step (B=32 images, T=32 captions; mode
               "mixed", host steps chosen so that the timed ticks draw both
               modes), a text MASS step (B=128, S=64) and an MT step
               (B=128, S=T=64), 3 warm-up and 6 timed, each step timed
               alone; K1 = 30 + 30 a multimodal MASS step, 12 + 12 a
               contrastive one, 18 + 18 a text MASS or MT step, K5 = 1 + 1 a
               text MASS step, at shapes phases 6 and 9 held; every
               BatchNorm statistic moves, none in a text MASS step. Then the
               fine-tune phase through train_epoch: two ticks of an image
               step, a back-translation step (greedy decode through K2 at
               (M, k) phase 3 held, then an MT step) and an MT step, K5 = 0.
               Then, where Pillow is installed, JPEGs ->
               cli.binarize_captions_from_list, phase 11's shards ->
               cli.train_mt --train --mass_train --fstep --langs from a text
               checkpoint grafted into the core -> cli.translate, and
               mmid_sim over folders of JPEGs.
 21. module  — SenSim at cli.train_sensim's defaults (768/12/3072, 6 layers,
     11        V=32000, fp32 masters, bf16 compute, dropout 0.1): B=128 pairs
               at S=64 with negative pools of 128 rows, 3 warm-up and 6
               timed steps, K1 = 24 + 24 a step (4 encodes); Caption2Image
               at cli.train_txt2image's defaults against a frozen BERT-base
               captioner with ResNet-18 at 224: B=32 captions of T=32, the
               target grid (encode_images in inference mode) timed apart,
               K1 = 6 + 6 a step; translate_img's three decode rounds
               (Caption2Image -> grid -> beam search of a "fused"
               captioner) at B=64, S=64, beam 4, L=88 with EOS outside the
               vocabulary: K2 = 1 and K4 = 3 a step, sentences/s; then
               cli.train_sensim (2 steps, pools from phase 11's shards, a
               dev set) -> cli.get_sen_sim, and, where Pillow is
               installed, cli.train_txt2image from a captioner checkpoint
               -> cli.translate_img on 8 lines; every K1, K2 and K4 shape
               held by phases 6, 3 and 16.
 22. moe     — MTTrainer at phase 7's shape (B=256, S=T=64, dropout 0.1,
               use_pallas_xent on) with an MoE FFN of 8 experts, top-2
               (capacity 1.25, groups of 256, aux weight 0.01), paired with
               the dense step in blocks of 3 (dense, moe, moe, dense): K1 =
               12 + 12 and K5 = 1 + 1 a step in both; one training-mode
               forward's aux losses finite and positive, first-choice
               fractions summing to 1, the share of choices past capacity;
               then phase 4's beam decode (B=64, S=64, beam 4, L=88) on the
               MoE model in bf16 with decode_attention_impl="fused": K2 = 1
               and K4 = 3 a step, tok/s.

 23. detector — FasterRCNN (ResNet-50 FPN, the JAX defaults: pre-NMS top-k
               1000 a level, 256 proposals, 36 detections, fp32) from a
               random torchvision state_dict saved as .pth and read back
               through load_torchvision_frcnn: B=8 uint8 images at 800, 5
               timed forwards (ms a batch, images/s, the convolutions' and
               linear layers' operations over 67 TFLOP/s fp32, peak memory),
               the time of its stages, the launches and time of one RPN-stage
               NMS (8 x 4507 boxes, 256 slots); image 0 against the same
               module on the CPU (labels and valid equal; scores rtol 2e-3 /
               atol 1e-4, boxes 2e-3 / 5e-2, features 1e-2); then, where
               Pillow is installed, cli.extract_objects over 20 JPEGs
               (--batch 8, a tail of 4) read back through ObjectStore, and
               cli.caption --obj --fcnn over 200 JPEGs at its default --batch
               192 and --max_len 32 (a BERT-base captioner with the object
               stream, fused: K2 = 1 and K4 = 6 a step, at shapes phases 3
               and 16 held), images/s.
 24. pack    — phase 7's model with the fused cross-entropy on 16 packed
               batches of 64 rows x 256 tokens (6000 pairs of 6-60 tokens)
               beside the bucketed batches cli.train_mt builds of the same
               pairs without --pack, blocks of 6 steps in the order bucketed,
               packed, packed, bucketed: ms/step, target tok/s and the share
               of real target slots of each; K1 = 12 + 12 and K5 = 1 + 1 a
               step at shapes phases 6 and 9 held (packed: T=S=256, T=S=255
               and T=255, S=256 with a per-row segment bias; K5 at N=16320);
               then cli.train_mt --pack --profile DIR for 16 steps of its
               default model (6+6 layers, K1 = 18 + 18 a step), the trace of
               steps 10-15 written.
 25. kernel  — K2b's merge (itt_topk_merge) on a BERT-base head (V=32000,
     (K2b)     E=768, bf16), one process: K2 on each of n = 2, 4 column
               slices, indices shifted, merged, against K2 over the whole
               vocabulary (indices equal, values bit-equal, lse within
               1e-5) and against the plain merge on the same gathered
               triples, at M = 256, 100, 1 and k = 1, 4, 16, with ties
               across the shard boundaries (columns 77, 333, 900 and one in
               each further quarter equal) and all-equal rows. One rank's
               K2b (K2 on V/4 + the merge) and the merge alone timed at
               M=256, k=4, n=4 beside the plain version and the library
               chain.
 26. tp path — four spawned ranks on the one card over gloo: phase 4's
               decode (BERT-base bf16, B=64, S=64, beam 4) under meshes 1x4
               and 2x2 against the one-process decode (sequence scores
               within 2e-2: bf16 near-ties may part the tokens), each rank's
               merge and K2 launches equal to its decode steps, every K2
               launch over V/n rows; in the same ranks cli.train_mt --mesh
               2x2 for 4 MT steps and a dev decode (loss finite, K1 and the
               merge launched; BLEU scored where sacrebleu is installed);
               then cli.translate --dp 2 under torchrun (two ranks, gloo)
               on 50 lines of that checkpoint, byte for byte --dp 0's file.
               Alone, ~1.5 min with the build: python3 -c "import
               chip_smoke as cs; card = cs.phase_device(); cs.phase_build();
               print(cs.phase_kernel_k2b()); print(cs.phase_tp_path(card))"
 27. remat   — phase 7's trainer (BERT-base, V=32000, fp32 masters, bf16
               compute, dropout 0.1, the fused cross-entropy) on B=256,
               S=T=64 and on phase 24's packed 64 x 256 batches, each in
               three arms from one seed: no recompute, remat_ffn, remat.
               The objective bit-equal across the arms and every gradient
               within 1e-6 of its tensor's largest value of the arm without
               recompute, under torch's deterministic algorithms (the
               largest difference printed; 0 expected); first-step
               losses bit-equal; K1 launches a step 12 + 12 without
               recompute and with remat_ffn, 24 + 12 with remat (each
               attention's forward again in the backward, with its seed),
               K5 1 + 1, at shapes phase 6 held; ms/step and peak memory of
               each arm.
 28. itr1    — the native host libraries (librecordio and libbpe built by
               g++ on this host and in use; the JPEG decoder where
               jpeglib.h is found); a generated corpus through
               cli.create_mt_batches --packed (the ITR1 file's batches
               equal to the marshal file's) -> cli.train_mt on the ITR1
               file at its default model (6+6, K1 18 + 18 a step) ->
               cli.translate; cli.create_batches --packed (rows equal to
               the marshal blocks') -> cli.train_lm; where Pillow is
               installed, cli.binarize_captions_from_list --packed ->
               CaptionTrainer steps over JPEGs. K1 shapes that phase 6 did
               not hold are held here after the run. Host numbers beside
               the CPU's name: from_packed against the list batcher over
               200000 pairs, the C++ BPE encode against the Python one.
 29. recipe  — cli.recipe_check at its default steps and floors on a
               generated sample corpus (a word-for-word substitution
               cipher), its ledger in the temporary workdir, where
               sacrebleu and Pillow are installed (else the phase says
               which is missing and does not run).
               Phases 27-29 alone, ~3 min with the build: python3 -c
               "import tempfile, chip_smoke as cs; card = cs.phase_device();
               cs.phase_build(); pack = cs.pack_shapes(); f, b, k1 =
               cs.phase_kernel_attention(pack[2]); xf, xb, k5 =
               cs.phase_kernel_xent(pack[3]); print(cs.phase_remat(card, k1,
               k5, pack)); corpus = cs.prepare_umt_corpus(tempfile.mkdtemp());
               print(cs.phase_itr1(card, k1, k5, corpus));
               print(cs.phase_recipe(card, k1))"
 30. 14b     — module 14b parts 1-3 at BERT-base width (V=32000, 6+3
               layers, B=256, S=T=64, fp32 masters), on ranks that share
               the card over gloo (one spawn of four; the 2x1 and 1x2
               meshes on ranks 0 and 1):
               correctness only, no speed is read. ZeRO-1 at 2x1 and 2x2:
               two fp32 steps with and without --zero from one seed under
               deterministic algorithms, the largest parameter difference
               within 1e-5 of the largest value, each rank's optimizer state
               smaller by (1 - 1/D) of its split tensors'; three bf16 steps
               at dropout 0.1 under --zero (K1, and K5 at 2x1). GPipe (M=4) at 1x2 and 1x4 (the last
               stage of 1x4 holds no decoder layer): two fp32 steps at
               dropout 0 against one process (losses and merged parameters
               within 1e-4); at 1x2 a bf16 step at dropout 0.1 (K1 12 M + 12
               M over the stages, 24 M forwards under remat, K5 1 + 1) and
               a fused beam decode of the gathered model (K2 and 3 K4 a
               step). Expert parallelism (8 experts, top-2) at 1x2 and 2x2:
               two fp32 steps against one process, routers and their
               moments equal across each model group to 1e-6 of their
               largest value; at 1x2 a bf16 step
               (K1) and phase 4's beam decode of the MoE model (K2b and K4
               every step, scores within 2e-2). Then cli.train_mt --mesh
               2x2 --zero, --mesh 1x4 --pp-microbatches 4 and --mesh 2x2
               --moe-experts 4 in the four ranks, and cli.translate on the
               pipelined checkpoint in one process. Alone, ~3 min with the
               build: python3 -c "import chip_smoke as cs; card =
               cs.phase_device(); cs.phase_build(); k1, k5 =
               cs.p30_shapes(); f, b, c1 = cs.phase_kernel_attention(k1);
               xf, xb, c5 = cs.phase_kernel_xent(k5); e, c4 =
               cs.phase_kernel_decode_attention(cs.decode_path_shapes());
               print(cs.phase_14b(card, c1, c5, c4))"
 31. 14b 4-6 — module 14b parts 4-6 on four ranks sharing the card over
               gloo, correctness only. The BERT-base MLM (V=32000, B=16,
               T=512: the masked budget over the global batch) at 1x2 and
               2x2: two fp32 steps at dropout 0 against one process (losses
               and parameters within 1e-4), a bf16 step at dropout 0.1 (K1
               6 + 6 a rank on its 6 heads); at 2x2 the dev evaluation at
               2048 positions (K3 6 a rank) within 5e-4 of one process. The
               long-document LM (preset 3, T=4096) under sequence
               parallelism at 1x4 and 2x2: each rank's logits and an fp32
               step against one process. At 2x1: SenSim (both pools) and
               Caption2Image fp32 steps against one process; a caption step
               with the ResNet in training mode (the running statistics of
               the global batch within 1e-4 of one process's) and the dev
               decode of 16 images split over the ranks (K2 and K4 every
               step); ImageMTTrainer with and without --zero (fp32, within
               1e-5), then a bf16 text MASS step (K5 1 + 1 a rank) and a
               back-translation step (K2, K4). Then cli.train_lm --mesh
               2x2, cli.train_lm --reformer --mesh 1x4 and (with Pillow)
               cli.train_captioning, cli.train_sensim, cli.train_txt2image
               and cli.train_mt --train --zero at --mesh 2x2 (768 wide, two
               layers a stack). Alone, ~5 min
               with the build: python3 -c "import chip_smoke as cs; card =
               cs.phase_device(); cs.phase_build(); k5, k3, k4 =
               cs.p31_shapes(); xf, xb, c5 = cs.phase_kernel_xent(k5); f,
               c3 = cs.phase_kernel_flash(k3); e, c4 =
               cs.phase_kernel_decode_attention(cs.decode_path_shapes() +
               k4); print(cs.phase_mesh_families(card, set(), c5, c3, c4))"

``--profile`` adds a phase after 4 (one more decode) and one after 7 (three
more train steps) under torch.profiler, printing the device time by operation
and the device's busy share of that same profiled run (the union of kernel
intervals over its wall time), then three more train steps with input shapes
recorded, printing the dtype casts' (aten::copy_) device time by shape,
three steps of the paired reading's fused-cross-entropy arm, five long
encodes with K3 and five with the plain attention (phase 13), and three MLM
steps (phase 14), one caption decode over the grid and one over grid +
objects (phase 18), one caption train step (phase 19), one image MT
tick (phase 20), one detector batch (phase 23) and three packed steps (phase
24).

The second-to-last line is a JSON object describing each kernel, with its
launches on its main path, its times, and its bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over the H100's published
rate for their type (989 TFLOP/s dense bf16 on the tensor cores; 67 TFLOP/s
fp32 outside them, for the cross-entropy). The last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4  # fp32 sums of 768 bf16 products taken in another order
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores, published
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def log(msg: str):
    print(msg, flush=True)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 (Hopper) card, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} capability {cap}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from imagetranslate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")


def _time_ms(fn, iters: int = 50, setup=None, clean: bool = False) -> float:
    """Mean device time of fn with a cold L2 (a 64 MiB write between
    launches evicts the 49 MB weight, as the decoder layers do between two
    decode steps). The write leaves ~50 MB of dirty lines in L2, which the
    timed call pays to write back as it evicts them; ``clean`` flushes by
    reading the 64 MiB instead, so that the call finds clean lines (as after
    layers that mostly read weights). ``setup`` runs before each timed call,
    untimed. The card is kept busy (~1 ms) while the host enqueues the events
    and fn, so that the time between the events is the device's and holds no
    wait for the host's enqueue (the Python wrapper takes longer than a short
    kernel)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup is not None:
            setup()
        if clean:
            flush.sum(dtype=torch.int32)
        else:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def topk_bound(M: int, k: int, E: int = 768, V: int = 32000):
    """K2's bound at one shape: h, W and the bias read once, the outputs
    written once, 2 M E V operations on the bf16 tensor cores."""
    return bound(M * E * 2 + V * E * 2 + V * 4 + M * (8 * k + 4),
                 2.0 * M * E * V)


def k2_random_cases(V: int = 32000):
    """(M, k, V) of phase 3's random cases at the full vocabulary: every
    decode path's M (phase 4: 256; back-translation: 128; long source: 32;
    caption: 768), ragged row tiles (100, 1000) and M=1, each at the three
    list lengths the kernel is built for (k <= 4, 8, 16); and the caption
    trainer's dev decode (phase 19: 16 images at beam 5)."""
    n_img, beam, _ = CAPTION_EVAL
    return ([(M, k, V) for M in (256, 100, 1, 32, 128, 768, 1000)
             for k in (1, 4, 16)] + [(n_img * beam, beam, V)])


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import topk_project as tkp

    E, V = 768, 32000
    max_err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def random_inputs(M, vocab):
        h = torch.randn(M, E, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(vocab, E, generator=gen, device="cuda")
             * 0.05).bfloat16()
        b = torch.randn(vocab, generator=gen, device="cuda") * 0.1
        return h, w, b

    def random_case(M, k, vocab):
        h, w, b = random_inputs(M, vocab)
        val, idx, lse = tkp.project_topk(h, w, b, k)
        torch.cuda.synchronize()
        rval, ridx, rlse = tkp.project_topk_reference(h, w, b, k + 1)
        logits = h.float() @ w.float().T + b
        err = max((val - rval[:, :k]).abs().max().item(),
                  (lse - rlse).abs().max().item())
        # The kernel's indices must name logits equal to its values...
        err_at = (logits.gather(1, idx.long()) - val).abs().max().item()
        # ...and equal the plain version's wherever no other candidate lies
        # within the tolerance.
        gaps = rval[:, :-1] - rval[:, 1:]                  # [M, k]
        clear = gaps[:, :k] > TOL
        clear[:, 1:] &= gaps[:, :k - 1] > TOL
        bad = (idx != ridx[:, :k]) & clear
        if (err > TOL or err_at > TOL or bad.any()
                or idx.dtype != torch.int32):
            raise AssertionError(
                f"kernel vs plain at M={M} k={k} V={vocab}: err {err:.3g}, "
                f"err_at_idx {err_at:.3g}, {int(bad.sum())} index "
                "mismatches")
        log(f"[kernel] M={M} k={k} V={vocab} {tkp.work_plan(M, vocab, k)}: "
            f"max abs err {err:.3g} (at kernel idx {err_at:.3g}), "
            "indices ok")
        return max(err, err_at)

    cases = k2_random_cases()
    # Ragged vocab sizes: the CLI phase's tokenizer vocab (less than one
    # tile), BERT's 30522 and 32003 (a last tile, and range, of 3 columns:
    # fewer than k).
    cases += [(256, k, 84) for k in (1, 4, 16)]
    cases += [(256, 4, 30522), (100, 16, 30522), (256, 4, 32003),
              (100, 16, 32003), (1, 16, 32003), (1, 4, 32003)]
    for M, k, vocab in cases:
        max_err = max(max_err, random_case(M, k, vocab))

    # Exact ties: the lowest vocab index wins at every boundary of the
    # kernel's work (tests/test_topk_project.py:65-90, re-placed): within a
    # thread's columns (a thread holds columns 2t, 2t + 1 mod 8), across the
    # quad that shares a row, across two vocab tiles of one block, across
    # two ranges and in a ragged last range.
    def ties(M, k, top, low=(), lv=2.0, value=3.0, vocab=V):
        b = torch.zeros(vocab, device="cuda")
        b[list(top)] = value
        if low:
            b[list(low)] = lv
        h = torch.ones(M, E, device="cuda").bfloat16()
        w = torch.zeros(vocab, E, device="cuda").bfloat16()
        val, idx, lse = tkp.project_topk(h, w, b, k)
        rval, ridx, rlse = tkp.project_topk_reference(h, w, b, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(val, rval)
                and (lse - rlse).abs().max().item() <= TOL
                and (idx == idx[:1]).all()):
            raise AssertionError(f"tie case {top} {low} k={k}: kernel "
                                 f"{idx[0].tolist()} plain "
                                 f"{ridx[0].tolist()}")
        return idx[0].tolist()

    per_range = tuple(r * 256 + (37 * r) % 256 for r in range(125))
    cases = [
        (dict(M=100, k=4, top=(5, 700, 1300, 2000), low=(9, 1290)),
         [5, 700, 1300, 2000]),
        (dict(M=100, k=6, top=(5, 700, 1300, 2000), low=(9, 1290)),
         [5, 700, 1300, 2000, 9, 1290]),
        (dict(M=7, k=4, top=(31999, 256, 255, 128, 127)),
         [127, 128, 255, 256]),
        (dict(M=7, k=2, top=(126, 127, 128, 129), value=1.0), [126, 127]),
        (dict(M=256, k=16, top=tuple(range(127, V, 128))),
         list(range(127, 16 * 128, 128))),
        (dict(M=1, k=16, top=(), value=0.0), list(range(16))),
        (dict(M=768, k=4, top=(), value=0.0), [0, 1, 2, 3]),
        # One thread's columns: the pair (2, 3) and the next j (10, 11).
        (dict(M=64, k=3, top=(11, 10, 3, 2)), [2, 3, 10]),
        (dict(M=64, k=2, top=(10, 3), low=(2,)), [3, 10]),
        # Across the quad: columns 0, 2, 4, 6 belong to its four threads.
        (dict(M=130, k=4, top=(6, 4, 2, 1, 0)), [0, 1, 2, 4]),
        (dict(M=130, k=9, top=(14, 12, 10, 8, 6, 4, 2, 0, 7, 5)),
         [0, 2, 4, 5, 6, 7, 8, 10, 12]),
        # Across two vocab tiles of one block (M=256: ranges of 2 tiles of
        # 256 columns; k > 4: tiles of 128).
        (dict(M=256, k=3, top=(511, 257, 256, 255)), [255, 256, 257]),
        (dict(M=256, k=12, top=tuple(range(120, 140))),
         list(range(120, 132))),
        # Across two ranges (M=256: columns 0..511 | 512..; M=768: ranges of
        # 1536 columns).
        (dict(M=256, k=4, top=(1024, 1023, 512, 511)),
         [511, 512, 1023, 1024]),
        (dict(M=768, k=4, top=(3072, 3071, 1536, 1535)),
         [1535, 1536, 3071, 3072]),
        # 125 tied values, one in each range of M=1 (k=16: 125 ranges of 256
        # columns): the 16 lowest win.
        (dict(M=1, k=16, top=per_range), sorted(per_range)[:16]),
        (dict(M=1, k=4, top=per_range), sorted(per_range)[:4]),
        # A ragged last tile and range (32000..32002) with fewer columns
        # than k.
        (dict(M=100, k=5, top=(32002, 32000, 31999, 5), vocab=32003),
         [5, 31999, 32000, 32002, 0]),
        (dict(M=1, k=4, top=(32002, 32001, 32000, 7), vocab=32003),
         [7, 32000, 32001, 32002]),
        (dict(M=1, k=16, top=(32002, 32000, 5), vocab=32003),
         [5, 32000, 32002] + [i for i in range(14) if i != 5]),
        (dict(M=1, k=16, top=(), value=0.0, vocab=32003), list(range(16))),
        # Less than one tile: the CLI phase's vocab.
        (dict(M=3, k=16, top=(83, 80, 2), low=(81,), vocab=84),
         [2, 80, 83, 81, 0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]),
    ]
    for kw, want in cases:
        got = ties(**kw)
        if got != want:
            raise AssertionError(f"tie case {kw}: got {got}, want {want}")
    log(f"[kernel] {len(cases)} exact tie cases ok")

    # Two launches on the same inputs give the same bits.
    for M in (256, 768):
        h, w, b = random_inputs(M, V)
        one = tkp.project_topk(h, w, b, 4)
        two = tkp.project_topk(h, w, b, 4)
        if not all(torch.equal(x, y) for x, y in zip(one, two)):
            raise AssertionError(f"two launches at M={M} differ")
    log("[kernel] two launches bit-equal at M=256 and M=768")

    # Times in turns: the kernel and the library chain a user would write
    # instead (cuBLAS bf16 GEMM, fp32 logits, torch.topk, torch.logsumexp: a
    # yardstick, never on the path; torch.topk's order among ties is
    # unspecified, so it is timed only); the plain version at M=256.
    def chain(h, w, b, k):
        logits = F.linear(h, w).float() + b
        return torch.topk(logits, k), torch.logsumexp(logits, -1)

    shapes = []
    for M, k in ((256, 4), (768, 4), (128, 1), (32, 4)):
        h, w, b = random_inputs(M, V)
        runs = {"kernel": [], "chain": [], "plain": []}
        order = ["kernel", "chain", "chain", "kernel"]
        if M == 256:
            order = ["plain"] + order + ["plain"]
        for name in order:
            fn = {"kernel": tkp.project_topk, "chain": chain,
                  "plain": tkp.project_topk_reference}[name]
            runs[name].append(_time_ms(lambda: fn(h, w, b, k)))
        bound_ms, bound_by = topk_bound(M, k, E, V)
        row = {"M": M, "k": k, "ms": sum(runs["kernel"]) / 2,
               "chain_ms": sum(runs["chain"]) / 2, "bound_ms": bound_ms,
               "bound_by": bound_by}
        if runs["plain"]:
            row["plain_ms"] = sum(runs["plain"]) / 2
        shapes.append(row)
        log(f"[kernel] M={M} E={E} V={V} k={k}: kernel {runs['kernel']} "
            f"ms, chain (F.linear bf16 + topk + logsumexp) {runs['chain']} "
            f"ms, plain {runs['plain']} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}): kernel at {bound_ms / row['ms']:.3f} of it")
    # The call's two launches apart, from torch.profiler: the pass over the
    # vocab ranges and the merge of a row's ranges (device time a call, 10
    # calls a shape with a cold L2, the launch gap between them excluded).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    inputs = [random_inputs(row["M"], V) for row in shapes]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for row, (h, w, b) in zip(shapes, inputs):
            for _ in range(10):
                flush.zero_()
                tkp.project_topk(h, w, b, row["k"])
        torch.cuda.synchronize()
    launches = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "project_topk_" in e.name)
    if len(launches) != 20 * len(shapes):
        log(f"[kernel] the profiler saw {len(launches)} of "
            f"{20 * len(shapes)} launches: no split")
    for n, row in enumerate(shapes):
        mine = launches[20 * n:20 * n + 20]
        if len(launches) != 20 * len(shapes):
            row["split_ms"] = "not measured"
            continue
        row["split_ms"] = {
            part: sum(us for _, name, us in mine
                      if f"project_topk_{part}" in name) / 1e4
            for part in ("ranges", "merge")}
        log(f"[kernel] M={row['M']} k={row['k']}: pass over the ranges "
            f"{row['split_ms']['ranges']:.4f} ms, merge "
            f"{row['split_ms']['merge']:.4f} ms a call (torch.profiler)")
    del flush, inputs
    main = shapes[0]
    # No single PyTorch call computes projection + top-k + logsumexp; the
    # chain of three is reported beside it.
    return {"max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main.pop("plain_ms"), "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "chain_ms": main["chain_ms"], "shapes": shapes}


def bert_base(vocab_size: int):
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    return Seq2SeqConfig(vocab_size=vocab_size, num_languages=2,
                         dropout=0.0, attention_dropout=0.0)


def build_model(cfg, device, seed=SEED):
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.train.weights import (
        random_params,
        state_dict_from_flax,
    )

    model = Seq2Seq(cfg, device=device)
    model.load_state_dict(state_dict_from_flax(random_params(cfg, seed), cfg))
    return model.eval()


def run_decode(model, B, S, K, device, seed=SEED):
    """encode + beam_search as cli/translate.py calls them, with EOS outside
    the vocab so every row decodes to its full limit (bench.py's rule).
    Returns (best, lengths, decode steps, seconds)."""
    import numpy as np
    import torch

    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        max_len_for,
    )

    cfg = model.cfg
    rng = np.random.RandomState(seed)
    src = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, S))).to(device)
    mask = torch.ones((B, S), dtype=torch.bool, device=device)
    langs = torch.zeros((B,), dtype=torch.int32, device=device)
    tgt_langs = torch.ones((B,), dtype=torch.int32, device=device)
    sizes = torch.full((B,), S, dtype=torch.int32, device=device)
    first = torch.full((B,), 6, dtype=torch.int32, device=device)
    L = max_len_for(S, 1.3, 5, cfg.max_position_embeddings)

    steps = 0
    step = model.decode_step

    def counted_step(*a, **kw):
        nonlocal steps
        steps += 1
        return step(*a, **kw)

    model.decode_step = counted_step
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = model.encode(src, mask, langs)
            best, lengths = beam_search(
                model, enc, mask, first, tgt_langs, sizes, beam_width=K,
                max_len=L, len_penalty_ratio=0.8, pad_id=cfg.pad_id,
                eos_id=-1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del model.decode_step
    if best.shape != (B, L) or lengths.shape != (B,):
        raise AssertionError(f"decode shapes {tuple(best.shape)} "
                             f"{tuple(lengths.shape)}, want ({B}, {L})")
    if not (best[:, 0] == 6).all():
        raise AssertionError("decode rows must start with the first token")
    if not ((best >= 0) & (best < cfg.vocab_size)).all():
        raise AssertionError("decoded ids outside the vocab")
    if not (lengths == min(int(1.3 * S + 5), L)).all():
        raise AssertionError(f"lengths {lengths.unique().tolist()}, want "
                             "every row at its limit")
    return best, lengths, steps, seconds


def phase_decode(card):
    import torch

    from imagetranslate_tpu_torch.ops import topk_project as tkp

    device = torch.device("cuda")
    model = build_model(bert_base(32000), device)
    B, S, K = 64, 64, 4
    run_decode(model, B, S, K, device)               # warm-up
    tkp.LAUNCHES = 0
    _, lengths, steps, seconds = run_decode(model, B, S, K, device)
    launches = tkp.LAUNCHES
    if launches != steps or steps == 0:
        raise AssertionError(f"project_topk launched {launches} times in "
                             f"{steps} decode steps")
    tokens = int(lengths.sum())
    log(f"[decode] BERT-base bf16 B={B} S={S} beam={K} L=88: {steps} steps, "
        f"{launches} kernel launches, {tokens} tokens in {seconds:.3f} s = "
        f"{tokens / seconds:.1f} tok/s (encode + beam search; {card})")

    # An fp32 model decodes on the card through K2's plain version (the
    # kernel takes bf16 only): no K2 launch.
    import dataclasses

    fp32 = build_model(dataclasses.replace(bert_base(32000), dtype="float32"),
                       device)
    tkp.LAUNCHES = 0
    _, f_lengths, f_steps, f_seconds = run_decode(fp32, 8, 16, K, device)
    if tkp.LAUNCHES != 0 or f_steps == 0:
        raise AssertionError(f"the fp32 decode launched K2 {tkp.LAUNCHES} "
                             f"times in {f_steps} steps")
    log(f"[decode] BERT-base fp32 B=8 S=16 beam={K}: {f_steps} steps through "
        f"the plain projection + top-k, 0 K2 launches, "
        f"{int(f_lengths.sum())} tokens in {f_seconds:.3f} s")
    del fp32
    return launches, model


def _profile(run, label: str, card: str):
    """``run()`` (returns its wall seconds and a note) under torch.profiler:
    device time by kernel and by aten op, and the device's busy share of
    this same run (the union of its device intervals over the run's wall
    time, which the profiler itself lengthens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, note = run()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    total = sum(e.time_range.elapsed_us() for e in dev)
    log(f"[profile {label}] profiled wall {wall * 1e3:.1f} ms, {note}, "
        f"device busy {busy / 1e3:.1f} ms = {busy / (wall * 1e6):.3f} of it "
        f"(device time summed {total / 1e3:.1f} ms; {card})")
    by_kernel = {}
    for e in dev:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(by_kernel.items(), key=lambda x: -x[1][1])[:14]:
        log(f"[profile {label}] kernel {t / 1e3:9.3f} ms "
            f"{100 * t / total:5.1f} % x{n:5d}  {name[:90]}")
    ops = [a for a in prof.key_averages()
           if a.key.startswith("aten::") and a.self_device_time_total > 0]
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:10]:
        t = a.self_device_time_total
        log(f"[profile {label}] op {t / 1e3:9.3f} ms {100 * t / total:5.1f} % "
            f"x{a.count:5d}  {a.key}")


def _profile_shapes(run, label: str, op: str):
    """One more ``run()`` under torch.profiler with input shapes recorded
    (which costs host time, so it is a run of its own): the device time of
    ``op`` split by its input shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _, note = run()
    rows = [a for a in prof.key_averages(group_by_input_shape=True)
            if a.key == op and a.self_device_time_total > 0]
    total = sum(a.self_device_time_total for a in rows)
    log(f"[profile {label}] {op} by input shapes, {note}: "
        f"{total / 1e3:.3f} ms of device time in "
        f"{sum(a.count for a in rows)} calls")
    for a in sorted(rows, key=lambda a: -a.self_device_time_total)[:12]:
        t = a.self_device_time_total
        log(f"[profile {label}] {op} {t / 1e3:9.3f} ms "
            f"{100 * t / total:5.1f} % x{a.count:5d}  {a.input_shapes[:2]}")


def phase_profile(model, card):
    """One more full-width decode under torch.profiler, after three
    unprofiled ones whose walls are printed for comparison."""
    import torch

    device = torch.device("cuda")
    B, S, K = 64, 64, 4
    walls = [run_decode(model, B, S, K, device)[3] for _ in range(3)]
    log(f"[profile decode] unprofiled walls {walls} s")

    def run():
        _, _, steps, wall = run_decode(model, B, S, K, device)
        return wall, f"{steps} steps"

    _profile(run, "decode", card)


WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron", "pi"]


def run_cli(workdir, device: str, make_cfg, n_lines: int = 50):
    """Tokenizer + full-width checkpoint + cli.translate.main; returns the
    output lines."""
    import numpy as np

    from imagetranslate_tpu_torch.cli.translate import main
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import save_params
    from imagetranslate_tpu_torch.train.weights import random_params

    rng = np.random.RandomState(SEED)
    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 9))) for _ in range(400)))
    tok = os.path.join(workdir, "tok")
    TextProcessor().train_tokenizer([corpus], 300, tok,
                                    {"<en>": 0, "<fa>": 1})
    tp = TextProcessor(tok)
    cfg = make_cfg(tp.vocab_size())
    ckpt = os.path.join(workdir, "model")
    save_params(ckpt, cfg, random_params(cfg, SEED))
    inp = os.path.join(workdir, "in.txt")
    with open(inp, "w") as f:
        f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(1, 12))) for _ in range(n_lines)))
    out = os.path.join(workdir, "out.txt")
    main(["--tok", tok, "--model", ckpt, "--input", inp, "--output", out,
          "--src", "en", "--target", "fa", "--device", device, "--verbose"])
    with open(out) as f:
        lines = f.read().splitlines()
    if len(lines) != n_lines or not all(" ||| " in ln for ln in lines):
        raise AssertionError(f"translate wrote {len(lines)} lines for "
                             f"{n_lines} inputs")
    return lines, cfg


def phase_cli():
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    tkp.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        lines, cfg = run_cli(workdir, "cuda", bert_base)
        seconds = time.perf_counter() - t0
    if tkp.LAUNCHES == 0:
        raise AssertionError("translate never launched project_topk")
    log(f"[cli] translate: {len(lines)} lines (vocab {cfg.vocab_size}, "
        f"hidden {cfg.hidden_size}, {cfg.enc_layers}+{cfg.dec_layers} "
        f"layers) with {tkp.LAUNCHES} kernel launches in {seconds:.1f} s, "
        f"e.g. {lines[0]!r}")


ATTN_TOL = 2.0 ** -6   # bf16 outputs: a few bf16 ulps of the largest value
DBIAS_TOL = 1e-4       # fp32 dbias: sums of ~2^-17-accurate terms
RATE = 0.1
MLM_SHAPE = (16, 512, 512, 12, 64)  # (B, T, S, H, D) of the MLM step


def phase_kernel_attention(extra_shapes=()):
    """Phase 6: the fused dropout attention kernels against their plain
    versions, their mask statistics, and their times. ``extra_shapes``:
    (B, T, S, H, D) of the later phases' steps, checked like the rest."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import train_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"fwd": 0.0, "bwd": 0.0}
    checked = set()   # (B, T, S, H, D, bias rows) held against the plain version

    def inputs(B, T, S, H, D, rows):
        q, k, v, g = (torch.randn(B, n, H, D, generator=gen,
                                  device="cuda").bfloat16()
                      for n in (T, S, S, T))
        bias = torch.randn(B, 1, T if rows else 1, S, generator=gen,
                           device="cuda")
        masked = torch.rand(bias.shape, generator=gen, device="cuda") < 0.2
        bias = torch.where(masked, torch.full_like(bias, -10000.0), bias)
        bias[0, :, 0, :] = -10000.0          # a row whose every key is masked
        return q, k, v, bias, g

    def case(B, T, S, H, D, rows, rate, seed=5):
        q, k, v, bias, g = inputs(B, T, S, H, D, rows)
        if not ta.fused_attention_supported(q, k, bias):
            raise AssertionError(f"gate refuses {(B, T, S, H, D)}")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = ta.fused_dropout_attention(*leaves, rate, seed)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        want = ta.fused_dropout_attention_reference(q, k, v, bias, rate, seed)
        hand = ta.fused_dropout_attention_backward_reference(
            q, k, v, bias, g, rate, seed)
        errs = []
        for name, got, ref in zip(("out", "dq", "dk", "dv", "dbias"),
                                  (out, *grads), (want, *hand)):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} is not finite")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = DBIAS_TOL if name == "dbias" else ATTN_TOL
            if err > tol * scale:
                raise AssertionError(
                    f"kernel vs plain, {name} at {(B, T, S, H, D)} rows="
                    f"{rows} rate={rate}: err {err:.3g} > {tol:.3g} * "
                    f"{scale:.3g}")
            errs.append(err / scale if scale else 0.0)
            key = "fwd" if name == "out" else "bwd"
            worst[key] = max(worst[key], err)
        checked.add((B, T, S, H, D, bias.shape[2]))
        log(f"[kernel K1] B={B} T={T} S={S} H={H} D={D} bias rows="
            f"{T if rows else 1} rate={rate}: err/max out {errs[0]:.2e} dq "
            f"{errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e} dbias "
            f"{errs[4]:.2e}")

    shapes = [
        (256, 64, 64, 12, 64),    # the training shape: encoder layers
        (256, 63, 63, 12, 64),    # decoder self-attention over tgt[:, :-1]
        (256, 63, 64, 12, 64),    # decoder cross-attention
        (32, 256, 256, 12, 64),   # packed rows; four query and key tiles
        (16, 48, 80, 12, 64),     # cross-attention, T != S
        (3, 100, 33, 2, 32),      # ragged T and S
        (2, 7, 255, 2, 64),       # a ragged fourth key tile
        (2, 130, 16, 1, 128),     # D = 128, three query tiles
        (1, 9, 352, 2, 16),       # D = 16, six key tiles
        (2, 1, 1, 1, 16),         # one query, one key
        (256, 32, 32, 12, 64),    # MASS decoder self-attention over the span
        (256, 32, 64, 12, 64),    # MASS decoder cross-attention
        (128, 81, 81, 12, 64),    # BT encoder over the translation buffer
        (128, 63, 81, 12, 64),    # BT decoder cross-attention
        (128, 63, 63, 12, 64),    # BT decoder self-attention
        MLM_SHAPE,                # the MLM step's encoder layers
        (2, 8, 257, 2, 64),       # one key past four tiles
        (2, 7, 511, 2, 64),       # S odd, one key short of the cap
        (1, 9, 512, 2, 16),       # D = 16 at the cap
        (2, 130, 512, 1, 128),    # D = 128 at the cap, three query tiles
    ]
    for shape in extra_shapes:
        if shape not in shapes:
            shapes.append(shape)
    for shape in shapes:
        for rows in (0, 1):
            for rate in (0.0, RATE):
                case(*shape, rows, rate)

    # Outside the gate (S = 513, fp32 inputs) the wrapper raises before any
    # launch.
    q, k, v, bias, _ = inputs(2, 8, 513, 2, 64, 0)
    launches = ta.FWD_LAUNCHES
    q2, k2, v2, bias2, _ = inputs(2, 8, 64, 2, 64, 0)
    for args in ((q, k, v, bias), (q2.float(), k2.float(), v2.float(), bias2)):
        try:
            ta.fused_dropout_attention(*args, RATE, 1)
        except (ValueError, TypeError):
            continue
        raise AssertionError("a shape or dtype outside the gate was launched")
    if ta.FWD_LAUNCHES != launches:
        raise AssertionError("a refused call counted as a launch")

    # Bit-reproducible: two launches on the same inputs give the same bits,
    # dbias included, at the MLM shape in both bias layouts.
    for rows in (0, 1):
        q, k, v, bias, g = inputs(*MLM_SHAPE, rows)
        runs = []
        for _ in range(2):
            out, stats = ta._launch_fwd(q, k, v, bias, RATE, 9)
            runs.append((out, *ta._launch_bwd(q, k, v, bias, g, stats, RATE,
                                              9, True)))
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), *runs):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} differs between two launches "
                                     f"on the same inputs (bias rows "
                                     f"{bias.shape[2]})")
    log("[kernel K1] out, dq, dk, dv and dbias bit-equal across two launches "
        "at the MLM shape, both bias layouts")

    # The Python gate repeats the kernels' shape limits: hold it against the
    # library's own answer over the (S, D) plane and at the grid's edge.
    from imagetranslate_tpu_torch.ops import _build

    lib = _build.load()
    swept = 0
    for Bg, Hg in ((2, 2), (65535, 1), (65536, 1), (1, 65536)):
        for D in (8, 16, 24, 32, 64, 96, 128, 256):
            for S in (1, 15, 64, 255, 256, 257, 272, 352, 353, 512, 513):
                qg = torch.empty((Bg, 3, Hg, D), dtype=torch.bfloat16,
                                 device="meta")
                kg = torch.empty((Bg, S, Hg, D), dtype=torch.bfloat16,
                                 device="meta")
                want = bool(lib.itt_fused_attn_supported(Bg, 3, S, Hg, D))
                if ta.fused_attention_supported(qg, kg, None) != want:
                    raise AssertionError(
                        f"the Python gate and the library disagree at B={Bg} "
                        f"S={S} H={Hg} D={D}: library says {want}")
                swept += 1
    log(f"[kernel K1] the Python gate equals the library's at {swept} shapes")

    # The mask straight from the kernel: q = k = 0 gives uniform probs 1/S,
    # v = identity (S = D) returns them, so out > 0 is the keep-mask.
    B, T, H, n = 64, 64, 12, 64
    z = torch.zeros(B, T, H, n, device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(n, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(B, n, H, n).contiguous()
    nobias = torch.zeros(B, 1, 1, n, device="cuda")

    def kernel_mask(seed):
        out = ta.fused_dropout_attention(z, z, eye, nobias, RATE, seed)
        return out.permute(0, 2, 1, 3) > 0              # [B, H, T, S]

    m1, m1b, m2 = kernel_mask(11), kernel_mask(11), kernel_mask(12)
    torch.cuda.synchronize()
    count = m1.numel()
    keep = m1.float().mean().item()
    sigma = (RATE * (1 - RATE) / count) ** 0.5
    if abs(keep - (1 - RATE)) > 4 * sigma:
        raise AssertionError(f"keep rate {keep} not within 4 sigma "
                             f"({4 * sigma:.2e}) of {1 - RATE}")
    if not torch.equal(m1, m1b):
        raise AssertionError("same seed, different mask")
    if not torch.equal(m1, ta.keep_mask(RATE, 11, B, H, T, n, "cuda")):
        raise AssertionError("the kernel's mask is not the plain version's")
    differ = (m1 != m2).float().mean().item()
    if not 0.15 < differ < 0.21:                        # 2 * 0.1 * 0.9
        raise AssertionError(f"masks of two seeds differ at {differ}")
    log(f"[kernel K1] mask from the kernel: keep rate {keep:.6f} over "
        f"{count} draws (4 sigma = {4 * sigma:.2e}), same seed same mask, "
        f"equal to the plain version's, two seeds differ at {differ:.4f}")

    def timed(B, T, S, H, D, rows, plain_iters):
        """Kernel, plain version and F.scaled_dot_product_attention (the
        library yardstick, never on the port's path), forward and backward,
        cold L2, taken in turns: plain, kernel, SDPA, SDPA, kernel, plain."""
        q, k, v, bias, g = inputs(B, T, S, H, D, rows)
        _, stats = ta._launch_fwd(q, k, v, bias, RATE, 3)
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        gh = g.transpose(1, 2)
        mask = bias.to(torch.bfloat16)
        held = {}

        def sdpa():
            held["out"] = F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, dropout_p=RATE)

        fns = {
            "kernel": (lambda: ta._launch_fwd(q, k, v, bias, RATE, 3),
                       lambda: ta._launch_bwd(q, k, v, bias, g, stats, RATE,
                                              3, False), None, 50),
            "plain": (lambda: ta.fused_dropout_attention_reference(
                q, k, v, bias, RATE, 3),
                lambda: ta.fused_dropout_attention_backward_reference(
                    q, k, v, bias, g, RATE, 3), None, plain_iters),
            "sdpa": (sdpa, lambda: torch.autograd.grad(held["out"],
                                                       (qh, kh, vh), gh),
                     sdpa, 50),
        }
        runs = {name: ([], []) for name in fns}
        for name in ("plain", "kernel", "sdpa", "sdpa", "kernel", "plain"):
            fwd_fn, bwd_fn, setup, iters = fns[name]
            runs[name][0].append(_time_ms(fwd_fn, iters=iters))
            runs[name][1].append(_time_ms(bwd_fn, iters=iters, setup=setup))
        elems = B * H * D
        nbias = bias.numel() * 4
        # The forward reads q, k, v and the bias and writes out and the row
        # statistics; the backward reads q, k, v, g, the bias and the
        # statistics and writes dq, dk, dv (dbias is not asked for).
        bounds = (bound(2 * elems * (2 * T + 2 * S) + nbias + 8 * B * H * T,
                        4.0 * B * H * T * S * D),
                  bound(2 * elems * (3 * T + 4 * S) + nbias + 8 * B * H * T,
                        10.0 * B * H * T * S * D))
        mean = {name: (sum(f) / 2, sum(b) / 2) for name, (f, b) in
                runs.items()}
        for i, what in enumerate(("forward", "backward")):
            log(f"[kernel K1] B={B} T={T} S={S} H={H} D={D} bias rows="
                f"{bias.shape[2]} rate={RATE}, {what}: kernel "
                f"{runs['kernel'][i]} ms, plain {runs['plain'][i]} ms, SDPA "
                f"{runs['sdpa'][i]} ms, bound {bounds[i][0]:.4f} ms "
                f"({bounds[i][1]}); kernel / SDPA "
                f"{mean['kernel'][i] / mean['sdpa'][i]:.3f}")
        return mean, bounds

    mean, bounds = timed(256, 64, 64, 12, 64, 0, 10)   # the training shape
    timed(*MLM_SHAPE, 0, 5)

    # The packed shape (four query tiles, a per-query bias), kernels only.
    pq, pk, pv, pbias, pg = inputs(32, 256, 256, 12, 64, 1)
    _, pstats = ta._launch_fwd(pq, pk, pv, pbias, RATE, 3)
    packed = [_time_ms(lambda: ta._launch_fwd(pq, pk, pv, pbias, RATE, 3)),
              _time_ms(lambda: ta._launch_bwd(pq, pk, pv, pbias, pg, pstats,
                                              RATE, 3, False))]
    log(f"[kernel K1] B=32 T=S=256 H=12 D=64 bias rows=256 rate={RATE}: "
        f"forward kernel {packed[0]:.4f} ms, backward kernel "
        f"{packed[1]:.4f} ms")

    def entry(i, err):
        return {"max_abs_err": err, "ms": mean["kernel"][i],
                "plain_ms": mean["plain"][i], "bound_ms": bounds[i][0],
                "bound_by": bounds[i][1], "library_ms": mean["sdpa"][i]}

    return entry(0, worst["fwd"]), entry(1, worst["bwd"]), checked


XENT_ROWS_TOL = 1e-4          # loss rows, relative (+ 1e-6 absolute)
XENT_DX_TOL = (1e-6, 1e-4)    # fp32 dx: absolute + relative
BF16_ULP = 2.0 ** -7          # bf16 dx: one ulp of the plain result


def phase_kernel_xent(extra_shapes=()):
    """Phase 9: the fused cross-entropy kernels against their plain version,
    and their times. ``extra_shapes``: (N, V) of the later phases' steps.
    Returns the two kernel entries and the set of (N, V, dtype) checked."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import xent

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"fwd": 0.0, "bwd": 0.0}
    checked = set()

    def case(N, V, dtype, eps, masked=False, chunk=4096):
        x = torch.empty((N, V), dtype=dtype, device="cuda")
        for r0 in range(0, N, 16384):      # fp32 draws of a large x in parts
            x[r0:r0 + 16384] = torch.randn(
                (min(16384, N - r0), V), generator=gen, device="cuda") * 3
        t = torch.randint(0, V, (N,), generator=gen, device="cuda")
        t[0] = V + 7                       # outside the vocabulary
        t[N // 3] = -1
        g = torch.rand(N, generator=gen, device="cuda")
        if N > 1:
            g[N // 2] = 0.0                # a masked row
        if masked:
            g.zero_()
        leaf = x.requires_grad_(True)
        # g arrives non-contiguous, as the step's mask / n broadcast does.
        g2 = torch.stack([g, g], dim=1)[:, 0]
        rows = xent.smoothed_xent_rows(leaf, t, eps)
        (dx,) = torch.autograd.grad(rows, leaf, g2)
        torch.cuda.synchronize()
        x = x.detach()
        if dx.dtype != dtype or dx.shape != x.shape or rows.shape != (N,):
            raise AssertionError(f"K5 outputs {rows.shape} {dx.shape} "
                                 f"{dx.dtype} at N={N} V={V} {dtype}")
        if not (torch.isfinite(rows).all() and torch.isfinite(dx).all()):
            raise AssertionError(f"K5 output not finite at N={N} V={V}")
        if masked and dx.count_nonzero().item():
            raise AssertionError("an all-masked g gave a non-zero dx")
        err_rows = err_dx = 0.0
        for r0 in range(0, N, chunk):      # the plain version, in row chunks
            sl = slice(r0, min(N, r0 + chunk))
            want = xent.smoothed_xent_rows_reference(x[sl], t[sl], eps)
            wdx = xent.smoothed_xent_backward_reference(
                x[sl], t[sl], g[sl], eps).float()
            d_rows = (rows[sl] - want).abs()
            d_dx = (dx[sl].float() - wdx).abs()
            if dtype == torch.float32:
                limit = XENT_DX_TOL[0] + XENT_DX_TOL[1] * wdx.abs()
            else:
                # ...plus the fp32 arithmetic's own error where exp(x - logZ)
                # and eps / V nearly cancel.
                limit = BF16_ULP * wdx.abs() + 1e-8
            if ((d_rows > XENT_ROWS_TOL * want.abs() + 1e-6).any()
                    or (d_dx > limit).any()):
                raise AssertionError(
                    f"K5 kernel vs plain at N={N} V={V} {dtype} eps={eps} "
                    f"rows {r0}..: loss err {d_rows.max().item():.3g}, dx "
                    f"err over its limit {(d_dx - limit).max().item():.3g}")
            err_rows = max(err_rows, d_rows.max().item())
            err_dx = max(err_dx, d_dx.max().item())
        worst["fwd"] = max(worst["fwd"], err_rows)
        if dtype == torch.float32:
            worst["bwd"] = max(worst["bwd"], err_dx)
        checked.add((N, V, dtype))
        log(f"[kernel K5] N={N} V={V} {str(dtype)[6:]} eps={eps}"
            f"{' all rows masked' if masked else ''}: max abs err loss "
            f"{err_rows:.3g}, dx {err_dx:.3g}")

    f32, b16 = torch.float32, torch.bfloat16
    cases = [
        (16128, 32000, f32, 0.1), (16128, 32000, f32, 0.0),   # the MT step
        (16128, 32000, b16, 0.1),
        (8192, 32000, f32, 0.1), (8192, 32000, b16, 0.0),     # the MASS step
        (8064, 32000, f32, 0.1),                              # the BT step
        (100, 84, f32, 0.1), (100, 84, b16, 0.1),             # ragged V
        (257, 30522, f32, 0.0), (257, 30522, b16, 0.1),
        (64, 32003, f32, 0.1), (64, 32003, b16, 0.0),
        (13, 32003, f32, 0.1), (13, 32001, b16, 0.1),         # N % 8 != 0
        (1, 32000, f32, 0.1), (1, 84, b16, 0.0), (3, 5, f32, 0.1),
        # past 2^31 bytes (fp32) and past 2^31 elements (bf16)
        (33000, 32768, f32, 0.1), (67200, 32003, b16, 0.1),
    ]
    cases += [(N, V, f32, 0.1) for N, V in extra_shapes
              if (N, V, f32, 0.1) not in cases]
    for c in cases:
        case(*c)
    case(64, 32000, f32, 0.1, masked=True)
    case(64, 32003, b16, 0.1, masked=True)
    torch.cuda.empty_cache()

    # What is outside the gate raises before any launch.
    launches = xent.FWD_LAUNCHES
    x = torch.randn(8, 64, device="cuda")
    t = torch.zeros(8, dtype=torch.int64, device="cuda")
    misaligned = x.flatten()[1:65].view(1, 64)
    for bad in (x.half(), x.double(), x[:, ::2], misaligned):
        try:
            xent.smoothed_xent_rows(bad, t[:bad.shape[0]], 0.1)
        except (ValueError, TypeError):
            continue
        raise AssertionError("logits outside the gate were launched")
    if xent.FWD_LAUNCHES != launches:
        raise AssertionError("a refused call counted as a launch")

    # Times at the MT step's shape, cold L2, plain-kernel-kernel-plain.
    N, V, eps = 16128, 32000, 0.1
    x = torch.randn(N, V, generator=gen, device="cuda") * 3
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    g = torch.rand(N, generator=gen, device="cuda")
    _, log_z = xent._launch_fwd(x, t, eps)
    runs = {"plain": [], "kernel": [], "plain_bwd": [], "kernel_bwd": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            runs["kernel"].append(_time_ms(
                lambda: xent._launch_fwd(x, t, eps), iters=20))
            runs["kernel_bwd"].append(_time_ms(
                lambda: xent._launch_bwd(x, t, log_z, g, eps), iters=20))
        else:
            runs["plain"].append(_time_ms(
                lambda: xent.smoothed_xent_rows_reference(x, t, eps),
                iters=5))
            runs["plain_bwd"].append(_time_ms(
                lambda: xent.smoothed_xent_backward_reference(x, t, g, eps),
                iters=5))
    # The library yardstick: one PyTorch call, never on the port's path.
    xl = x.detach().requires_grad_(True)
    held = {}

    def library():
        held["rows"] = F.cross_entropy(xl, t, reduction="none",
                                       label_smoothing=eps)

    lib_fwd = _time_ms(library, iters=10)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(held["rows"], xl, g),
                       setup=library, iters=10)
    # Forward: x read, loss and logZ written; ~6 fp32 operations and an exp
    # per element. Backward: x read, dx written; about as many operations.
    fwd_bound = bound(N * V * 4 + N * 16, 7.0 * N * V, FP32_FLOPS_PER_S)
    bwd_bound = bound(N * V * 8 + N * 16, 6.0 * N * V, FP32_FLOPS_PER_S)
    log(f"[kernel K5] N={N} V={V} fp32 eps={eps}: forward kernel "
        f"{runs['kernel']} ms, plain {runs['plain']} ms, F.cross_entropy "
        f"{lib_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms; backward kernel "
        f"{runs['kernel_bwd']} ms, plain {runs['plain_bwd']} ms, "
        f"F.cross_entropy backward {lib_bwd:.4f} ms, bound "
        f"{bwd_bound[0]:.4f} ms")
    xb = x.to(torch.bfloat16)
    b16_ms = [_time_ms(lambda: xent._launch_fwd(xb, t, eps), iters=20),
              _time_ms(lambda: xent._launch_bwd(xb, t, log_z, g, eps),
                       iters=20)]
    log(f"[kernel K5] N={N} V={V} bf16 logits: forward kernel "
        f"{b16_ms[0]:.4f} ms (bound {fwd_bound[0] / 2:.4f}), backward kernel "
        f"{b16_ms[1]:.4f} ms (bound {bwd_bound[0] / 2:.4f})")
    del x, xb, xl, held
    torch.cuda.empty_cache()

    def entry(key, err, bnd, lib):
        return {"max_abs_err": err, "ms": sum(runs[key]) / 2,
                "plain_ms": sum(runs["plain" + key[6:]]) / 2,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}

    return (entry("kernel", worst["fwd"], fwd_bound, lib_fwd),
            entry("kernel_bwd", worst["bwd"], bwd_bound, lib_bwd), checked)


FLASH_TOL = 2.0 ** -7    # bf16 outputs: two bf16 ulps of the largest value
FLASH_TOL64 = 2.0 ** -6  # against fp64: the bf16 rounding of p and of the output


def phase_kernel_flash(extra_shapes=()):
    """Phase 12: the flash attention kernel against its plain version (the
    same tile-by-tile arithmetic in tensor ops) and, on a sample of rows,
    against an fp64 computation; its times. ``extra_shapes``: (B, T, S, H, D,
    has_bias) of the later phases, checked like the rest. Returns the kernel
    entry and the set of shapes checked."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import flash_attention as fa
    from imagetranslate_tpu_torch.ops.attention import (
        attention_scale,
        dot_product_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    checked = set()

    def inputs(B, T, S, H, D, has_bias):
        q, k, v = (torch.randn(B, n, H, D, generator=gen,
                               device="cuda").bfloat16() for n in (T, S, S))
        if not has_bias:
            return q, k, v, None
        # Rows padded to a random length (about half on average), one row
        # whose every key is padded; the bias arrives as a view of a wider
        # buffer, as a slice of a batch's mask does.
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lengths[0] = 0
        lengths[-1] = S
        keep = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
        wide = torch.zeros((B, 1, 1, S + 3), device="cuda")
        wide[..., :S] = (1.0 - keep.float())[:, None, None, :] * -10000.0
        return q, k, v, wide[..., :S]

    def fp64_rows(q, k, v, bias, rows):
        """softmax(q k^T scale + bias) v in fp64 for query rows ``rows``."""
        q64 = q[:, rows].double().permute(0, 2, 1, 3)
        s = torch.matmul(q64, k.double().permute(0, 2, 3, 1))
        s = s * attention_scale(q.shape[-1])
        if bias is not None:
            s = s + bias.double()
        out = torch.matmul(torch.softmax(s, dim=-1),
                           v.double().permute(0, 2, 1, 3))
        return out.permute(0, 2, 1, 3)

    def case(B, T, S, H, D, has_bias):
        nonlocal worst
        q, k, v, bias = inputs(B, T, S, H, D, has_bias)
        if not fa.flash_supported(q, k, bias):
            raise AssertionError(f"gate refuses {(B, T, S, H, D, has_bias)}")
        out = fa.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v, bias)
        if out.shape != want.shape or out.dtype != torch.bfloat16:
            raise AssertionError(f"K3 output {out.shape} {out.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"K3 output not finite at {(B, T, S, H, D)}")
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        rows = torch.unique(torch.randint(0, T, (16,), generator=gen,
                                          device="cuda"))
        exact = fp64_rows(q, k, v, bias, rows)
        err64 = (out[:, rows].double() - exact).abs().max().item()
        scale64 = exact.abs().max().item()
        if err > FLASH_TOL * scale or err64 > FLASH_TOL64 * scale64:
            raise AssertionError(
                f"K3 at {(B, T, S, H, D)} bias={has_bias}: err vs plain "
                f"{err:.3g} (limit {FLASH_TOL * scale:.3g}), vs fp64 "
                f"{err64:.3g} (limit {FLASH_TOL64 * scale64:.3g})")
        worst = max(worst, err)
        checked.add((B, T, S, H, D, has_bias))
        log(f"[kernel K3] B={B} T={T} S={S} H={H} D={D} "
            f"{'padding bias' if has_bias else 'no bias'}: max abs err vs "
            f"plain {err:.3g} ({err / scale:.2e} of max), vs fp64 on "
            f"{len(rows)} rows {err64:.3g} ({err64 / scale64:.2e} of max)")

    shapes = [
        (8, 2048, 2048, 12, 64),     # the long-source encode / LM dev batch
        (2, 1024, 1024, 12, 64),     # the dispatch's shortest S
        (2, 1032, 1032, 4, 64),      # S not a multiple of the key tile
        (2, 1536, 1536, 4, 64),
        (1, 4096, 4096, 4, 64),
        (1, 5000, 5000, 2, 64),      # ragged in both
        (2, 64, 2048, 12, 64),       # T != S
        (2, 8, 2048, 12, 64),        # the fewest queries the gate takes
        (2, 2000, 2048, 4, 64),      # a ragged last query tile
        (2, 1100, 1100, 4, 32),      # D = 32
        (2, 1100, 1100, 4, 128),     # D = 128
        # ragged around the 128-query and 128-key tiles
        (2, 1000, 1031, 4, 64),
        (2, 129, 1087, 3, 128),
        (1, 8, 1025, 2, 32),
        (3, 1153, 2049, 2, 64),
    ]
    for shape in shapes:
        for has_bias in (True, False):
            case(*shape, has_bias)
    for shape in extra_shapes:
        if shape not in checked:
            case(*shape)

    # Outside the gate: the dispatch takes the plain attention (fp32 on the
    # card, a per-query bias, T < 8), and the wrapper raises before a launch.
    q, k, v, bias = inputs(2, 16, 1024, 2, 64, True)
    launches = fa.LAUNCHES
    per_query = bias.expand(2, 1, 16, 1024)
    for args in ((q.float(), k.float(), v.float(), bias),
                 (q, k, v, per_query), (q[:, :4], k, v, bias)):
        if fa.flash_supported(args[0], args[1], args[3]):
            raise AssertionError("the gate takes a call outside its rules")
        got = dot_product_attention(*args, use_pallas=True)
        want = dot_product_attention(*args, use_pallas=False)
        if not torch.equal(got, want):
            raise AssertionError("a call outside the gate did not take the "
                                 "plain attention")
        try:
            fa.flash_attention(*args)
        except (ValueError, TypeError):
            continue
        raise AssertionError("a call outside the gate was launched")
    for bad in ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias),
                (q, k, v, bias.double()),
                (q, k, v, torch.zeros((2, 1, 1, 2048), device="cuda")[..., ::2])):
        try:
            fa.flash_attention(*bad)
        except (ValueError, TypeError):
            continue
        raise AssertionError("strides or dtypes the kernel cannot read were "
                             "launched")
    if fa.LAUNCHES != launches:
        raise AssertionError("a refused call counted as a launch")
    # Through the dispatch, and the gradient of the plain attention behind it.
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = dot_product_attention(*leaves, bias, use_pallas=True)
    g = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
    grads = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pgrads = torch.autograd.grad(
        dot_product_attention(*plain, bias, use_pallas=False), plain, g)
    if fa.LAUNCHES != launches + 1:
        raise AssertionError("the dispatch did not launch K3")
    for name, a, b in zip("qkv", grads, pgrads):
        if not torch.equal(a, b):
            raise AssertionError(f"d{name} behind K3 is not the plain "
                                 "attention's gradient")
    log("[kernel K3] outside the gate the dispatch takes the plain attention "
        "and the wrapper raises; the gradient behind the kernel is the plain "
        "attention's")

    # Two launches on the same inputs give the same bits (no atomics, a
    # fixed order of keys).
    B, T, S, H, D = 8, 2048, 2048, 12, 64
    q, k, v, bias = inputs(B, T, S, H, D, True)
    if not torch.equal(fa._launch(q, k, v, bias), fa._launch(q, k, v, bias)):
        raise AssertionError("two K3 launches on the same inputs differ")
    log(f"[kernel K3] two launches at {(B, T, S, H, D)} are bit-equal")

    # Times at the long-source shape, cold L2, in turns (each arm once in
    # this order, then once in the reverse order): the kernel with the bias
    # and without, SDPA with the mask and without (the library yardstick,
    # never on the port's path), the plain version (tile by tile) and the
    # plain attention the dispatch otherwise runs.
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = bias.to(torch.bfloat16).contiguous()
    arms = {
        "kernel": (lambda: fa._launch(q, k, v, bias), 20),
        "kernel_nobias": (lambda: fa._launch(q, k, v, None), 20),
        "sdpa_mask": (lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 20),
        "sdpa": (lambda: F.scaled_dot_product_attention(qh, kh, vh), 20),
        "plain": (lambda: fa.flash_attention_reference(q, k, v, bias), 3),
        "attention": (lambda: dot_product_attention(q, k, v, bias), 5),
    }
    runs = {name: [] for name in arms}
    for order in (list(arms), list(reversed(arms))):
        for name in order:
            fn, iters = arms[name]
            runs[name].append(_time_ms(fn, iters=iters))
    ms = {name: sum(t) / len(t) for name, t in runs.items()}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    clock_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def report(label, B, T, S, H, D, kernel_ms):
        """TFLOP/s, the share of the bound, and beside the bound the time of
        the B H T S exponentials on the SFUs (16 a clock an SM, at the
        card's maximum SM clock): information, not part of the bound."""
        flops = 4.0 * B * H * T * S * D
        bnd = bound(2 * B * H * D * (2 * T + 2 * S) + B * S * 4, flops)
        exp_ms = 1e3 * B * H * T * S / (sms * 16 * clock_hz)
        log(f"[kernel K3] {label} B={B} T={T} S={S} H={H} D={D}: "
            f"{kernel_ms:.4f} ms, {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
            f"{bnd[0] / kernel_ms:.3f} of the bound {bnd[0]:.4f} ms by "
            f"{bnd[1]}; exponentials alone {exp_ms:.4f} ms ({sms} SMs x 16 "
            f"a clock at {clock_hz / 1e6:.0f} MHz)")
        return bnd

    log(f"[kernel K3] B={B} T={T} S={S} H={H} D={D} bf16, in turns: "
        + "; ".join(f"{name} {runs[name]} ms" for name in arms))
    bnd = report("padding bias", B, T, S, H, D, ms["kernel"])
    report("no bias", B, T, S, H, D, ms["kernel_nobias"])
    log(f"[kernel K3] kernel / SDPA with the mask "
        f"{ms['kernel'] / ms['sdpa_mask']:.3f}, without a bias / SDPA "
        f"without a mask {ms['kernel_nobias'] / ms['sdpa']:.3f}")
    entry = {"max_abs_err": worst, "ms": ms["kernel"],
             "plain_ms": ms["plain"], "bound_ms": bnd[0],
             "bound_by": bnd[1], "library_ms": ms["sdpa_mask"]}
    del q, k, v, bias, qh, kh, vh, mask
    # The other head widths at the same B, T, S and H D = 768.
    for D in (32, 128):
        H = 768 // D
        q, k, v, bias = inputs(B, T, S, H, D, True)
        report("padding bias", B, T, S, H, D,
               _time_ms(lambda: fa._launch(q, k, v, bias), iters=20))
    del q, k, v
    torch.cuda.empty_cache()
    return entry, checked


class FullVocab:
    """The tokenizer facade MTTrainer reads (special tokens, the two language
    tokens, pad / mask / separator ids), over a 32000-entry vocabulary whose
    ordinary tokens are their own ids: the trainer phases run at the
    model's full vocabulary without training a 32000-entry BPE."""

    special_tokens = ["<pad>", "<s>", "<unk>", "<mask>", "</s>", "<aa>",
                      "<bb>"]
    languages = {"<aa>": 0, "<bb>": 1}

    def token_id(self, token: str) -> int:
        return self.special_tokens.index(token)

    def id2token(self, i: int):
        i = int(i)
        return self.special_tokens[i] if i < len(self.special_tokens) else None

    def pad_token_id(self) -> int:
        return 0

    def mask_token_id(self) -> int:
        return 3

    def sep_token_id(self) -> int:
        return 4

    def vocab_size(self) -> int:
        return 32000


class Recorder:
    """Records the shapes a run gives the K1 and K5 kernels (wrapping the
    modules' launch functions), to be held against the shapes the kernel
    phases checked."""

    def __init__(self):
        from imagetranslate_tpu_torch.ops import train_attention as ta
        from imagetranslate_tpu_torch.ops import xent

        self.ta, self.xent = ta, xent
        self.k1, self.k5 = set(), set()

    def __enter__(self):
        ta, xent = self.ta, self.xent
        self.saved = (ta._launch_fwd, ta._launch_bwd, xent._launch_fwd,
                      xent._launch_bwd)

        def k1(fn):
            def wrapped(q, k, v, bias, *rest):
                self.k1.add((*q.shape[:2], k.shape[1], *q.shape[2:],
                             bias.shape[2]))
                return fn(q, k, v, bias, *rest)
            return wrapped

        def k5(fn):
            def wrapped(logits, *rest):
                self.k5.add((*logits.shape, logits.dtype))
                return fn(logits, *rest)
            return wrapped

        ta._launch_fwd, ta._launch_bwd = k1(self.saved[0]), k1(self.saved[1])
        xent._launch_fwd = k5(self.saved[2])
        xent._launch_bwd = k5(self.saved[3])
        return self

    def __exit__(self, *exc):
        (self.ta._launch_fwd, self.ta._launch_bwd, self.xent._launch_fwd,
         self.xent._launch_bwd) = self.saved

    def require_checked(self, what: str, checked_k1, checked_k5,
                        want_k5: bool = True):
        for name, seen, checked in (("K1", self.k1, checked_k1),
                                    ("K5", self.k5, checked_k5)):
            if (not seen and (name == "K1" or want_k5)) or seen - checked:
                raise AssertionError(
                    f"{what} gave the {name} kernels shapes that were not "
                    f"held against the plain version: "
                    f"{sorted(map(str, seen - checked))} (seen "
                    f"{sorted(map(str, seen))})")
        log(f"[{what}] K1 shapes (B, T, S, H, D, bias rows) "
            f"{sorted(self.k1)} and K5 shapes "
            f"{sorted((n, v, str(d)[6:]) for n, v, d in self.k5)}: all "
            "checked by the kernel phases")


def train_batches(cfg, n: int, B: int, S: int, T: int, device, seed=SEED):
    """n staged batches of full rows over the whole vocabulary, ids drawn
    with a skew (id ~ V u^3) so that there is something to learn."""
    import numpy as np

    from imagetranslate_tpu_torch.data.loader import MTBatch
    from imagetranslate_tpu_torch.train.step import mt_batch_to_device

    rng = np.random.RandomState(seed)

    def ids(shape):
        return (5 + (cfg.vocab_size - 5) * rng.rand(*shape) ** 3).astype(
            np.int32)

    out = []
    for _ in range(n):
        src, dst = ids((B, S)), ids((B, T))
        ones = np.ones((B,), np.int32)
        out.append(mt_batch_to_device(MTBatch(
            src, src != cfg.pad_id, dst, dst != cfg.pad_id, 0 * ones, ones,
            S * ones, ones.astype(bool)), device))
    return out


def phase_train(card, profile: bool, checked, checked_xent):
    """Phase 7: MTTrainer steps at full width, then the paired reading of
    the step with the fused cross-entropy off and on. ``checked`` /
    ``checked_xent``: the shapes phases 6 and 9 held against the plain
    versions; every shape a step gives the kernels must be one of them."""
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                              attention_dropout=RATE)
    B, S, T, warm, timed = 256, 64, 64, 3, 9
    torch.cuda.reset_peak_memory_stats()
    trainer = MTTrainer(cfg, FullVocab(), lr=5e-4, warmup=8, seed=SEED,
                        device=device)
    masters = {p.dtype for p in trainer.model.parameters()}
    if masters != {torch.float32}:
        raise AssertionError(f"master parameters are {masters}, want fp32")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batches = train_batches(cfg, 4, B, S, T, device)
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    metrics = []

    def steps(n, tr=trainer, into=metrics):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            batch = batches[len(into) % len(batches)]
            tr.state, m = tr.mt_step(tr.state, batch, tr.rng)
            into.append(m)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # The warm-up steps also record the shapes the step gives each kernel.
    with Recorder() as rec:
        steps(warm)
    rec.require_checked("train", checked, checked_xent, want_k5=False)
    seconds = steps(timed)
    fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
    n_steps = warm + timed
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    if not (fwd == bwd == per_step * n_steps):
        raise AssertionError(f"{fwd} forward and {bwd} backward launches in "
                             f"{n_steps} steps, want {per_step} per step")
    losses = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"loss not finite: {losses}")
    first = sum(losses[:4]) / 4
    last = sum(losses[-4:]) / 4
    if not last < first - 0.1:
        raise AssertionError(f"loss did not fall: {losses}")
    after = trainer.model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    if changed < len(before) - 2 or trainer.state.step != n_steps:
        raise AssertionError(f"only {changed} of {len(before)} parameters "
                             f"changed in {trainer.state.step} steps")
    if not all(torch.isfinite(v).all() for v in after.values()):
        raise AssertionError("a parameter is not finite after training")
    tokens = sum(int(m["ntokens"].item()) for m in metrics[warm:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] BERT-base fp32 masters / bf16 compute, dropout {RATE}, "
        f"B={B} S=T={S}: {timed} steps, {tokens} target tokens in "
        f"{seconds:.3f} s = {tokens / seconds:.1f} tok/s "
        f"({1e3 * seconds / timed:.1f} ms/step); loss {first:.4f} -> "
        f"{last:.4f}; {fwd} forward + {bwd} backward K1 launches "
        f"({per_step} + {per_step} per step); {changed}/{len(before)} "
        f"parameters changed; peak memory {peak:.2f} GiB ({card})")
    if profile:
        walls = [steps(1) for _ in range(3)]
        log(f"[profile train] unprofiled walls {walls} s per step")
        _profile(lambda: (steps(3), "3 steps"), "train", card)
        _profile_shapes(lambda: (steps(3), "3 steps"), "train", "aten::copy_")
    del trainer, before, after
    torch.cuda.empty_cache()

    # The paired reading: the same step with the fused cross-entropy off and
    # on, two fresh trainers from one seed on the same batches.
    arms = {}
    for fused in (False, True):
        arm_cfg = dataclasses.replace(cfg, use_pallas_xent=fused)
        arms[fused] = (MTTrainer(arm_cfg, FullVocab(), lr=5e-4, warmup=8,
                                 seed=SEED, device=device), [])
    xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
    with Recorder() as rec:
        for fused in (False, True):
            steps(2, *arms[fused])                      # warm-up
    rec.require_checked("train, fused xent", checked, checked_xent)
    first = {fused: [(m["sum_loss"] / m["ntokens"]).item() for m in ms]
             for fused, (_, ms) in arms.items()}
    if abs(first[True][0] - first[False][0]) > 1e-4 * abs(first[False][0]):
        raise AssertionError(f"the first step's loss with the fused "
                             f"cross-entropy {first[True]} differs from the "
                             f"plain one's {first[False]}")
    block, ms, peaks = 4, {False: [], True: []}, {}
    for fused in (False, True, True, False):
        torch.cuda.reset_peak_memory_stats()
        ms[fused].append(1e3 * steps(block, *arms[fused]) / block)
        peaks[fused] = torch.cuda.max_memory_allocated() / 2 ** 30
    n_on = len(arms[True][1])
    if not (xent.FWD_LAUNCHES == xent.BWD_LAUNCHES == n_on):
        raise AssertionError(f"{xent.FWD_LAUNCHES} forward and "
                             f"{xent.BWD_LAUNCHES} backward K5 launches in "
                             f"{n_on} steps of the fused arm")
    log(f"[train] paired, same batches, blocks of {block} steps in the order "
        f"off, on, on, off: plain loss {ms[False]} ms/step (mean "
        f"{sum(ms[False]) / 2:.2f}), fused cross-entropy {ms[True]} ms/step "
        f"(mean {sum(ms[True]) / 2:.2f}); peak memory with both trainers "
        f"resident {peaks[False]:.2f} GiB (plain) and {peaks[True]:.2f} GiB "
        f"(fused); first losses {first[False][0]:.5f} and "
        f"{first[True][0]:.5f}; {n_on} + {n_on} K5 launches ({card})")
    if profile:
        _profile(lambda: (steps(3, *arms[True]), "3 steps, fused xent"),
                 "train fused", card)
    return fwd, bwd


def mass_batches(cfg, n: int, B: int, S: int, seed=SEED):
    """n numpy MassBatches over the whole vocabulary: rows of 32..S tokens,
    ``<lang> ids... </s>``, ids drawn with a skew (id ~ V u^3), half the rows
    in each language."""
    import numpy as np

    from imagetranslate_tpu_torch.data.loader import MassBatch

    vocab = FullVocab()
    first = len(vocab.special_tokens)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = (first + (cfg.vocab_size - first)
               * rng.rand(B, S) ** 3).astype(np.int32)
        lengths = rng.randint(32, S + 1, B).astype(np.int32)
        langs = (np.arange(B) % 2).astype(np.int32)
        src[:, 0] = np.where(langs == 0, vocab.token_id("<aa>"),
                             vocab.token_id("<bb>"))
        src[np.arange(B), lengths - 1] = vocab.sep_token_id()
        src = np.where(np.arange(S)[None, :] < lengths[:, None], src,
                       cfg.pad_id).astype(np.int32)
        out.append(MassBatch(src, src != cfg.pad_id, langs, src[:, 0].copy(),
                             lengths, np.ones((B,), bool)))
    return out


@contextlib.contextmanager
def counting_decode_steps():
    """Counts the calls of ``Seq2Seq.decode_step`` made inside the block, in
    the one-element list it yields."""
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq

    count = [0]
    step = Seq2Seq.decode_step

    def counted(self, *a, **kw):
        count[0] += 1
        return step(self, *a, **kw)

    Seq2Seq.decode_step = counted
    try:
        yield count
    finally:
        Seq2Seq.decode_step = step


def phase_umt_train(card, checked, checked_xent):
    """Phase 10: MASS steps, then back-translation steps, through MTTrainer
    with the fused cross-entropy at full width."""
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.step import mass_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                              attention_dropout=RATE, use_pallas_xent=True)
    B, S, n_mass, n_bt = 256, 64, 10, 3
    vocab = FullVocab()
    trainer = MTTrainer(cfg, vocab, lr=5e-4, warmup=4, seed=SEED,
                        bt_beam_width=1, max_len_a=1.1, max_len_b=5,
                        device=device)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    staged = [mass_batch_to_device(b, device)
              for b in mass_batches(cfg, 4, B, S)]
    bt = mass_batches(cfg, n_bt, B // 2, S, seed=SEED + 1)
    dirs = MTTrainer.lang_directions(["aa", "bb"], vocab)
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = tkp.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec, counting_decode_steps() as decode_steps:
        mass_m = []
        for i in range(n_mass):
            trainer.state, m = trainer.mass_step(
                trainer.state, staged[i % len(staged)], trainer.rng)
            mass_m.append(m)
        torch.cuda.synchronize()
        t_mass = time.perf_counter() - t0
        trainer.reset_for_finetune()
        bt_m = [trainer._bt_step(b, dirs, trainer.rng) for b in bt]
        torch.cuda.synchronize()
        t_bt = time.perf_counter() - t0 - t_mass
    counts = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
              xent.BWD_LAUNCHES, tkp.LAUNCHES)
    rec.require_checked("umt train", checked, checked_xent)
    n_steps = n_mass + n_bt
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    want = (per_step * n_steps, per_step * n_steps, n_steps, n_steps,
            decode_steps[0])
    if counts != want or decode_steps[0] == 0:
        raise AssertionError(
            f"umt train: (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2) launches "
            f"{counts} in {n_mass} MASS + {n_bt} BT steps with "
            f"{decode_steps[0]} decode steps, want {want}")
    mass_l = [(m["sum_loss"] / m["ntokens"]).item() for m in mass_m]
    bt_l = [(m["sum_loss"] / m["ntokens"]).item() for m in bt_m]
    if not all(x == x and abs(x) != float("inf") for x in mass_l + bt_l):
        raise AssertionError(f"loss not finite: {mass_l} {bt_l}")
    first, last = sum(mass_l[:3]) / 3, sum(mass_l[-3:]) / 3
    if not last < first - 0.05:
        raise AssertionError(f"the MASS loss did not fall: {mass_l}")
    after = trainer.model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    if (changed < len(before) - 2 or trainer.state.step != n_steps
            or trainer.state.opt_state.schedule_count != n_bt
            or not all(torch.isfinite(v).all() for v in after.values())):
        raise AssertionError(
            f"umt train: {changed} of {len(before)} parameters changed in "
            f"{trainer.state.step} steps, schedule count "
            f"{trainer.state.opt_state.schedule_count}")
    mass_tokens = sum(int(m["ntokens"].item()) for m in mass_m)
    log(f"[umt train] BERT-base, fused cross-entropy, dropout {RATE}: "
        f"{n_mass} MASS steps (B={B} S={S}, {mass_tokens} span tokens) in "
        f"{t_mass:.3f} s, first included, loss {first:.4f} -> {last:.4f}; "
        f"{n_bt} back-translation steps (B={B // 2}, greedy decode of "
        f"{decode_steps[0]} steps in all + MT step) in {t_bt:.3f} s, losses "
        f"{bt_l}; launches K1 {counts[0]} + {counts[1]}, K5 {counts[2]} + "
        f"{counts[3]}, K2 {counts[4]}; {changed}/{len(before)} parameters "
        f"changed ({card})")
    return counts[2], counts[3]


def phase_train_cli():
    """Phase 8: corpus -> cli.train_tokenizer -> cli.create_mt_batches ->
    cli.train_mt -> the checkpoint it wrote through cli.translate,
    load_checkpoint and cli.score_pairs."""
    import marshal

    import numpy as np

    from imagetranslate_tpu_torch.cli import create_mt_batches, score_pairs
    from imagetranslate_tpu_torch.cli import train_tokenizer
    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.data.binarize import load_mt
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint

    steps = 6
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        rng = np.random.RandomState(SEED)
        lines = [" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 12))) for _ in range(600)]
        src, dst = (os.path.join(workdir, n) for n in ("src.txt", "dst.txt"))
        with open(src, "w") as f:
            f.write("\n".join(lines) + "\n")
        dst_lines = [" ".join(reversed(ln.split())) for ln in lines]
        with open(dst, "w") as f:                       # the reversed line
            f.write("\n".join(dst_lines) + "\n")
        tagged = os.path.join(workdir, "tagged.txt")
        with open(tagged, "w") as f:
            f.write("\n".join(f"<en> {ln} </s>" for ln in lines) + "\n")
            f.write("<fa> " + lines[0] + " </s>\n")
        tok = os.path.join(workdir, "tok")
        train_tokenizer.main(["--data", tagged, "--vocab_size", "300",
                              "--model", tok])
        tp = TextProcessor(tok)
        mt = os.path.join(workdir, "train.mt")
        create_mt_batches.main(["--tok", tok, "--src", src, "--src-lang",
                                "en", "--dst", dst, "--dst-lang", "fa",
                                "--output", mt])
        n = len(load_mt(mt))
        model = os.path.join(workdir, "model")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        train_main(["--tok", tok, "--model", model, "--train_mt", mt,
                    "--dec", "3", "--step", str(steps), "--lr", "0.001",
                    "--warmup", "10", "--device", "cuda"])
        fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        if not (fwd == bwd == 12 * steps):
            raise AssertionError(f"train_mt: {fwd} forward and {bwd} backward "
                                 f"launches in {steps} steps")
        latest = model + ".latest"
        params, opt_tree, meta = load_checkpoint(latest, with_opt_state=True)
        word = params["params"]["embeddings"]["word"]["embedding"]
        if (meta["step"] != steps or int(opt_tree["1"]["count"]) != steps
                or tuple(word.shape) != (tp.vocab_size(), 768)
                or str(word.dtype) != "torch.float32"):
            raise AssertionError(f"checkpoint: meta {meta}, word embedding "
                                 f"{tuple(word.shape)} {word.dtype}")
        inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
        with open(inp, "w") as f:
            f.write("\n".join(lines[:40]) + "\n")
        tkp.LAUNCHES = 0
        translate_main(["--tok", tok, "--model", latest, "--input", inp,
                        "--output", out, "--src", "en", "--target", "fa",
                        "--device", "cuda"])
        with open(out) as f:
            hyps = f.read().splitlines()
        if len(hyps) != 40 or tkp.LAUNCHES == 0:
            raise AssertionError(f"translate wrote {len(hyps)} lines with "
                                 f"{tkp.LAUNCHES} kernel launches")
        # Forced scores: each of 8 sources against 4 candidates (its
        # reference among them), the shard window of items 2..7.
        sens, cands = {}, {}
        for i in range(8):
            sens[i] = f"<en> {lines[i]} </s>"
            cands[i] = [100 + 4 * i + j for j in range(4)]
            for j, c in enumerate(cands[i]):
                ref = dst_lines[i] if j == 0 else dst_lines[50 + 4 * i + j]
                sens[c] = f"<fa> {ref} </s>"
        pair_files = [os.path.join(workdir, n) for n in ("s.m", "c.m",
                                                         "best.tsv")]
        for path, obj in zip(pair_files, (sens, cands)):
            with open(path, "wb") as f:
                marshal.dump(obj, f)
        score_pairs.main(["--tok", tok, "--model", latest, "--sens",
                          pair_files[0], "--data", pair_files[1], "--output",
                          pair_files[2], "--resume", "1", "--end", "8",
                          "--device", "cuda"])
        with open(pair_files[2]) as f:
            best = [ln.split("\t") for ln in f.read().splitlines()]
        if (len(best) != 6 or best[0][0] != sens[1]
                or not all(-1e4 < float(r[2]) <= 0.0 for r in best)):
            raise AssertionError(f"score_pairs wrote {best}")
        seconds = time.perf_counter() - t0
    log(f"[train cli] cli.train_tokenizer -> cli.create_mt_batches: {n} "
        f"pairs, vocab {tp.vocab_size()}; width 768, 6+3 layers: {steps} "
        f"steps with {fwd} + {bwd} K1 launches, checkpoint with optimizer "
        f"state re-loaded (step {meta['step']}), translated 40 lines with "
        f"{tkp.LAUNCHES} project_topk launches, cli.score_pairs wrote "
        f"{len(best)} best pairs (items 2..7, mean log-probs "
        f"{[round(float(r[2]), 3) for r in best]}) in {seconds:.1f} s, e.g. "
        f"{hyps[0]!r}")

UMT_CLI_BATCH = 8192   # --batch of phase 11: 128 rows of 32 tokens a batch


def umt_cli_shapes(vocab_size: int):
    """The shapes phase 11's MASS and back-translation steps give K1 and K5,
    from its flags and the port's own batch arithmetic: ((B, T, S, H, D)
    list, (N, V) list). Every line of its corpus fits the shortest bucket."""
    from imagetranslate_tpu_torch.data.loader import _batch_rows, bucket_len
    from imagetranslate_tpu_torch.decoding.beam import max_len_for

    s, H, D = bucket_len(1), 12, 64
    rows = _batch_rows(1, s, s, UMT_CLI_BATCH, 600)
    bt_rows = _batch_rows(1, s, s, UMT_CLI_BATCH // 2, 300)
    span = s // 2                                # the MASS decoder's length
    L = -(-max_len_for(s, 1.3, 5, 512) // 16) * 16
    k1 = [(rows, s, s), (rows, span, span), (rows, span, s),
          (bt_rows, L + 1, L + 1), (bt_rows, s - 1, s - 1),
          (bt_rows, s - 1, L + 1)]
    return ([(*shape, H, D) for shape in k1],
            [(rows * span, vocab_size), (bt_rows * (s - 1), vocab_size)])


def prepare_umt_corpus(workdir):
    """Two monolingual corpora (the second language is the first one's lines
    reversed), a two-language tokenizer and the monolingual shards. Returns
    (tokenizer dir, shard prefix, the first corpus' lines, TextProcessor)."""
    import numpy as np

    from imagetranslate_tpu_torch.data.binarize import write_mt
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    rng = np.random.RandomState(SEED + 2)
    lines = [" ".join(WORDS[j] for j in rng.randint(
        0, len(WORDS), rng.randint(2, 12))) for _ in range(600)]
    texts = {"en": lines,
             "fa": [" ".join(reversed(ln.split())) for ln in lines]}
    for lang, rows in texts.items():
        with open(os.path.join(workdir, f"{lang}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    tok = os.path.join(workdir, "tok")
    TextProcessor().train_tokenizer([os.path.join(workdir, "en.txt")], 300,
                                    tok, {"<en>": 0, "<fa>": 1})
    tp = TextProcessor(tok)
    prefix = os.path.join(workdir, "mono.")
    for lang in texts:
        n = write_mt(tp, prefix + lang, os.path.join(workdir, f"{lang}.txt"),
                     tp.token_id(f"<{lang}>"), shard_size=250)
        if n != len(lines):
            raise AssertionError(f"write_mt kept {n} of {len(lines)} lines")
    return tok, prefix, lines, tp


def phase_umt_cli(workdir, corpus, checked, checked_xent):
    """Phase 11: monolingual shards -> cli.train_mt (MASS, then
    back-translation, fused cross-entropy through --pretrained's config) ->
    cli.translate on the checkpoint it wrote."""
    import dataclasses

    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_config,
        save_params,
    )
    from imagetranslate_tpu_torch.train.weights import random_params

    tok, prefix, lines, tp = corpus
    n_mass, n_bt = 4, 3
    t0 = time.perf_counter()
    cfg = dataclasses.replace(bert_base(tp.vocab_size()), dropout=RATE,
                              attention_dropout=RATE, use_pallas_xent=True)
    init = os.path.join(workdir, "init")
    save_params(init, cfg, random_params(cfg, SEED))
    model = os.path.join(workdir, "model")
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = tkp.LAUNCHES = 0
    with Recorder() as rec, counting_decode_steps() as decode_steps:
        train_main(["--tok", tok, "--model", model, "--pretrained", init,
                    "--mass_train", prefix, "--batch", str(UMT_CLI_BATCH),
                    "--step", str(n_mass), "--fstep", str(n_bt),
                    "--langs", "en,fa", "--lr", "0.001", "--warmup", "10",
                    "--device", "cuda"])
    counts = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
              xent.BWD_LAUNCHES, tkp.LAUNCHES)
    rec.require_checked("umt cli", checked, checked_xent)
    n_steps = n_mass + n_bt
    want = (12 * n_steps, 12 * n_steps, n_steps, n_steps, decode_steps[0])
    if counts != want or decode_steps[0] == 0:
        raise AssertionError(
            f"umt cli: (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2) launches "
            f"{counts} in {n_mass} MASS + {n_bt} BT steps with "
            f"{decode_steps[0]} decode steps, want {want}")
    latest = model + ".latest"
    _, opt_tree, meta = load_checkpoint(latest, with_opt_state=True)
    if (meta["step"] != n_steps or int(opt_tree["1"]["count"]) != n_steps
            or int(opt_tree["2"]["count"]) != n_bt
            or not load_config(latest).use_pallas_xent):
        raise AssertionError(
            f"umt cli checkpoint: meta {meta}, Adam count "
            f"{int(opt_tree['1']['count'])}, schedule count "
            f"{int(opt_tree['2']['count'])}")
    inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
    with open(inp, "w") as f:
        f.write("\n".join(lines[:40]) + "\n")
    tkp.LAUNCHES = 0
    translate_main(["--tok", tok, "--model", latest, "--input", inp,
                    "--output", out, "--src", "en", "--target", "fa",
                    "--device", "cuda"])
    with open(out) as f:
        hyps = f.read().splitlines()
    if len(hyps) != 40 or tkp.LAUNCHES == 0:
        raise AssertionError(f"translate wrote {len(hyps)} lines with "
                             f"{tkp.LAUNCHES} kernel launches")
    log(f"[umt cli] 2 x {len(lines)} monolingual lines, vocab "
        f"{tp.vocab_size()}, width 768, 6+3 layers, fused cross-entropy: "
        f"{n_mass} MASS + {n_bt} back-translation steps with launches K1 "
        f"{counts[0]} + {counts[1]}, K5 {counts[2]} + {counts[3]}, K2 "
        f"{counts[4]} (= the decodes' steps); checkpoint at step "
        f"{meta['step']} with the schedule restarted; translated 40 lines "
        f"with {tkp.LAUNCHES} project_topk launches in "
        f"{time.perf_counter() - t0:.1f} s, e.g. {hyps[0]!r}")


@contextlib.contextmanager
def recording_flash():
    """Records the shapes (B, T, S, H, D, has a bias) a run gives the K3
    kernel, in the set it yields (wrapping the module's launch function)."""
    from imagetranslate_tpu_torch.ops import flash_attention as fa

    seen = set()
    launch = fa._launch

    def wrapped(q, k, v, bias):
        seen.add((*q.shape[:2], k.shape[1], *q.shape[2:], bias is not None))
        return launch(q, k, v, bias)

    fa._launch = wrapped
    try:
        yield seen
    finally:
        fa._launch = launch


def require_flash(what: str, seen, checked, launches: int, want: int):
    """K3 was launched ``want`` times, each at a shape that phase 12 held
    against the plain version."""
    if launches != want or not seen or seen - checked:
        raise AssertionError(
            f"{what}: {launches} K3 launches, want {want}, at shapes "
            f"{sorted(seen)}, not checked by the kernel phase: "
            f"{sorted(seen - checked)}")


def long_config(vocab_size: int):
    """BERT-base with 2048 positions: the long-source serving config. (A
    source longer than the position table is an error here.)"""
    import dataclasses

    return dataclasses.replace(bert_base(vocab_size),
                               max_position_embeddings=2048)


LONG_B, LONG_S = 8, 2048
LONG_CLI_LINES, LONG_CLI_S = 6, 1040   # source lines of 1025..1040 tokens
LONG_ENC_TOL = 2.0 ** -4   # six bf16 layers after attention outputs that
                           # agree to a bf16 ulp or two
LM_DEV_RTOL = 5e-4         # dev loss with K3 on vs off, bf16 compute


def long_cli_shape():
    """The shape phase 13's translate_batches gives K3, from the port's own
    batch arithmetic: 3 rows fit the 4000-token budget at S=1040, and a batch
    pads up to 8 rows."""
    from imagetranslate_tpu_torch.data.loader import _batch_rows

    rows = _batch_rows(3, LONG_CLI_S, 32, 4000, 600)
    rows = max(8, 1 << (rows - 1).bit_length())
    return (rows, LONG_CLI_S, LONG_CLI_S, 12, 64, True)


def phase_long_source(card, profile: bool, checked_flash):
    """Phase 13: a long source (S >= 1024) through the serving path at full
    width. Returns the K3 launches of its counted runs."""
    import dataclasses

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import translate
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.ops import flash_attention as fa
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import save_params
    from imagetranslate_tpu_torch.train.weights import random_params

    device = torch.device("cuda")
    cfg = long_config(32000)
    model = build_model(cfg, device)
    B, S, K = LONG_B, LONG_S, 4
    fa.LAUNCHES = tkp.LAUNCHES = 0
    with recording_flash() as seen:
        _, lengths, steps, seconds = run_decode(model, B, S, K, device)
    launches = fa.LAUNCHES
    require_flash("long-source decode", seen, checked_flash, launches,
                  cfg.enc_layers)
    if tkp.LAUNCHES != steps or steps == 0:
        raise AssertionError(f"project_topk launched {tkp.LAUNCHES} times in "
                             f"{steps} decode steps")
    tokens = int(lengths.sum())
    log(f"[long source] BERT-base bf16, 2048 positions, B={B} S={S} beam={K} "
        f"L={lengths.max().item()}: encode launched K3 {launches} times (one "
        f"per encoder layer), the decode none; {steps} decode steps = "
        f"{tkp.LAUNCHES} K2 launches, {tokens} tokens in {seconds:.3f} s = "
        f"{tokens / seconds:.1f} tok/s, first call included ({card})")

    # The encode alone with K3 on and off: two models over the same weights.
    plain = Seq2Seq(dataclasses.replace(cfg, use_pallas_attention=False),
                    device=device)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    rng = np.random.RandomState(SEED)
    src = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, S))).to(device)
    lens = torch.as_tensor(rng.randint(S // 2, S + 1, (B,))).to(device)
    mask = torch.arange(S, device=device)[None, :] < lens[:, None]
    langs = torch.zeros((B,), dtype=torch.int32, device=device)

    def encodes(m, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n):
                enc = m.encode(src, mask, langs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n, enc

    _, enc_on = encodes(model, 1)
    _, enc_off = encodes(plain, 1)
    if enc_on.shape != (B, S, cfg.hidden_size) or not (
            torch.isfinite(enc_on).all() and torch.isfinite(enc_off).all()):
        raise AssertionError(f"long encode: {tuple(enc_on.shape)}, finite "
                             f"{torch.isfinite(enc_on).all().item()}")
    keep = mask[:, :, None]
    diff = ((enc_on.float() - enc_off.float()).abs() * keep).max().item()
    scale = (enc_off.float().abs() * keep).max().item()
    if diff > LONG_ENC_TOL * scale:
        raise AssertionError(f"long encode with K3 differs from the plain "
                             f"attention's by {diff:.3g} (limit "
                             f"{LONG_ENC_TOL * scale:.3g})")
    n, secs = 5, {True: [], False: []}
    for on in (True, False, False, True):
        secs[on].append(encodes(model if on else plain, n)[0])
    tps = {on: B * S / (sum(v) / 2) for on, v in secs.items()}
    log(f"[long source] encode B={B} S={S} (rows of {S // 2}..{S} tokens), "
        f"blocks of {n} in the order on, off, off, on: with K3 "
        f"{[1e3 * s for s in secs[True]]} ms = {tps[True]:.1f} tok/s, plain "
        f"attention {[1e3 * s for s in secs[False]]} ms = {tps[False]:.1f} "
        f"tok/s; outputs differ by {diff:.3g} at most ({diff / scale:.2e} of "
        f"the largest value, limit {LONG_ENC_TOL:.2e}) ({card})")
    if profile:
        _profile(lambda: (n * encodes(model, n)[0], f"{n} encodes with K3"),
                 "long encode", card)
        _profile(lambda: (n * encodes(plain, n)[0],
                          f"{n} encodes, plain attention"),
                 "long encode plain", card)
    del model, plain, enc_on, enc_off
    torch.cuda.empty_cache()

    # The translate CLI's own functions on sources of more than 1024 tokens.
    with tempfile.TemporaryDirectory() as workdir:
        corpus = os.path.join(workdir, "corpus.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
                0, len(WORDS), rng.randint(2, 9))) for _ in range(400)))
        tok = os.path.join(workdir, "tok")
        TextProcessor().train_tokenizer([corpus], 300, tok,
                                        {"<en>": 0, "<fa>": 1})
        tp = TextProcessor(tok)
        ccfg = long_config(tp.vocab_size())
        ckpt = os.path.join(workdir, "model")
        save_params(ckpt, ccfg, random_params(ccfg, SEED))
        lines, examples = [], []
        for i in range(LONG_CLI_LINES):
            want = LONG_CLI_S - 15 + 3 * i           # 1025..1040 tokens
            words = [WORDS[j] for j in rng.randint(0, len(WORDS), want)]
            ids = tp.tokenize_one_line("<en> " + " ".join(words) + " </s>")
            while len(ids) > want:                   # whole words come off
                words.pop()
                ids = tp.tokenize_one_line("<en> " + " ".join(words) + " </s>")
            if not 1024 < len(ids) <= LONG_CLI_S:
                raise AssertionError(f"a source line of {len(ids)} tokens")
            lines.append(" ".join(words))
            examples.append((ids, [tp.token_id("<fa>")], 0, 1))
        inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
        with open(inp, "w") as f:
            f.write("\n".join(lines) + "\n")
        argv = ["--tok", tok, "--model", ckpt, "--input", inp, "--output",
                out, "--src", "en", "--target", "fa", "--max_len_a", "0.1",
                "--device", "cuda"]
        options = translate.get_parser().parse_args(argv)
        # From a file the tokenizer cuts a line at 512 tokens (in both
        # packages), so cli.translate.main gives the encoder S = 512 and the
        # dispatch takes the plain attention.
        fa.LAUNCHES = tkp.LAUNCHES = 0
        translate.main(argv)
        with open(out) as f:
            n_main = len(f.read().splitlines())
        if n_main != LONG_CLI_LINES or fa.LAUNCHES != 0 or tkp.LAUNCHES == 0:
            raise AssertionError(
                f"cli.translate from a file: {n_main} lines, {fa.LAUNCHES} "
                f"K3 and {tkp.LAUNCHES} K2 launches")
        # Whole, the same lines go through the CLI's model loader and its
        # decode loop (translate_batches), as a caller with its own batcher
        # runs them.
        t0 = time.perf_counter()
        cli_model, _, _ = translate.build_model(options)
        batcher = MTBatcher(examples, pad_id=tp.pad_token_id(),
                            max_batch=options.batch,
                            capacity_mb=options.total_capacity,
                            max_seq_len=10000, bucket_step=options.bucket_step)
        fa.LAUNCHES = tkp.LAUNCHES = 0
        with recording_flash() as seen, open(out, "w") as writer:
            translate.translate_batches(cli_model, ccfg, tp, batcher, options,
                                        writer)
        cli_launches = fa.LAUNCHES
        require_flash("long-source translate_batches", seen, checked_flash,
                      cli_launches, ccfg.enc_layers * len(batcher))
        with open(out) as f:
            hyps = f.read().splitlines()
        if len(hyps) != LONG_CLI_LINES or tkp.LAUNCHES == 0:
            raise AssertionError(f"translate_batches wrote {len(hyps)} lines "
                                 f"with {tkp.LAUNCHES} K2 launches")
        log(f"[long source] cli.translate from a file of {LONG_CLI_LINES} "
            f"lines of 1025..{LONG_CLI_S} tokens: the tokenizer cuts each at "
            f"512, 0 K3 launches; the same lines whole through build_model + "
            f"translate_batches: {len(batcher)} batches at {sorted(seen)}, "
            f"{cli_launches} K3 launches ({ccfg.enc_layers} per batch), "
            f"{tkp.LAUNCHES} K2 launches, {len(hyps)} lines in "
            f"{time.perf_counter() - t0:.1f} s")
    return launches + cli_launches


def write_blocks(cache_dir: str, rows: int, T: int, vocab_size: int,
                 block_rows: int, seed: int):
    """Document blocks as ``data.binarize.write_doc_blocks`` lays them out
    (``N.pkl`` marshal dicts {row number: (ids, language type)} and
    ``info.txt``), holding full rows over the whole vocabulary, ids drawn
    with a skew (id ~ V u^3), alternating between two languages."""
    import marshal

    import numpy as np

    vocab = FullVocab()
    first = len(vocab.special_tokens)
    rng = np.random.RandomState(seed)
    os.makedirs(cache_dir, exist_ok=True)
    ids = (first + (vocab_size - first)
           * rng.rand(rows, T) ** 3).astype(np.int32)
    ids[:, 0] = np.where(np.arange(rows) % 2 == 0, vocab.token_id("<aa>"),
                         vocab.token_id("<bb>"))
    ids[:, -1] = vocab.sep_token_id()
    n_blocks = 0
    for start in range(0, rows, block_rows):
        block = {i: (ids[i].tolist(), i % 2)
                 for i in range(start, min(rows, start + block_rows))}
        with open(os.path.join(cache_dir, f"{n_blocks}.pkl"), "wb") as f:
            marshal.dump(block, f)
        n_blocks += 1
    with open(os.path.join(cache_dir, "info.txt"), "w") as f:
        f.write(f"{block_rows}\t{rows}\t{n_blocks}")


def _lm_epoch(trainer, workdir, name, B, T, n_steps, n_timed, card):
    """``train_epoch`` over generated blocks (with a dev set: one validation
    and both checkpoint slots), then ``n_timed`` more steps timed alone.
    Returns the per-step losses."""
    import torch

    from imagetranslate_tpu_torch.data.loader import DocBlockDataset
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint
    from imagetranslate_tpu_torch.train.step import lm_batch_to_device

    V = trainer.cfg.vocab_size
    train_dir, dev_dir = (os.path.join(workdir, f"{name}_{n}")
                          for n in ("train", "dev"))
    write_blocks(train_dir, B * n_steps, T, V, 2 * B, SEED)
    write_blocks(dev_dir, B, T, V, B, SEED + 1)
    train, dev = DocBlockDataset(train_dir), DocBlockDataset(dev_dir,
                                                             load_all=True)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    metrics, inner = [], trainer.step_fn

    def collecting(state, batch, rng):
        state, m = inner(state, batch, rng)
        metrics.append(m)
        return state, m

    trainer.step_fn = collecting
    slot = os.path.join(workdir, f"{name}_model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = trainer.train_epoch(0, slot, train, dev, B, n_steps,
                               eval_every=10 ** 9)
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    for path in (slot, slot + ".latest"):
        _, opt_tree, meta = load_checkpoint(path, with_opt_state=True)
        if meta["step"] != n_steps or int(opt_tree["1"]["count"]) != n_steps:
            raise AssertionError(f"{name}: checkpoint {path} at {meta}")
    staged = [lm_batch_to_device(b, trainer.device)
              for b in itertools.islice(train.batches(B, pad_id=0), 4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_timed):
        trainer.state, _ = trainer.step_fn(trainer.state,
                                           staged[i % len(staged)],
                                           trainer.rng)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n_timed
    trainer.step_fn = inner
    losses = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
    after = trainer.model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    if (step != n_steps or trainer.state.step != n_steps + n_timed
            or not all(x == x and abs(x) != float("inf") for x in losses)
            or changed != len(before)
            or not all(torch.isfinite(v).all() for v in after.values())
            or not trainer.best_dev_loss < float("inf")):
        raise AssertionError(
            f"{name}: {step} epoch steps, state at {trainer.state.step}, "
            f"losses {losses}, {changed} of {len(before)} parameters "
            f"changed, dev loss {trainer.best_dev_loss}")
    masked = sum(int(m["ntokens"].item()) for m in metrics[-n_timed:])
    log(f"[{name}] B={B} T={T}: train_epoch of {n_steps} steps + one "
        f"validation + both checkpoint slots in {t_epoch:.2f} s; then "
        f"{n_timed} steps at {ms:.1f} ms/step = {1e3 * B * T / ms:.1f} "
        f"positions/s ({masked / n_timed:.0f} masked targets a step); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; dev loss "
        f"{trainer.best_dev_loss:.4f}; {changed}/{len(before)} parameters "
        f"changed ({card})")
    return losses


def phase_lm(card, profile: bool, checked_flash, checked_k1):
    """Phase 14: the MLM trainer at the CLI's default width (K1 in every
    encoder layer) and the paired reading of its step with the fused dropout
    attention off and on, dev evaluation at 2048 positions through K3, and
    the long-document trainer at preset 3. ``checked_k1``: the shapes phase 6
    held against the plain version. Returns the K3 launches of the dev
    evaluation and the K1 forward and backward launches of the MLM run."""
    import argparse
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.data.loader import DocBlockDataset
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
    from imagetranslate_tpu_torch.ops import flash_attention as fa
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.checkpoint import load_config
    from imagetranslate_tpu_torch.train.step import lm_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer
    from imagetranslate_tpu_torch.train.trainer_longdoc import LongDocTrainer

    device = torch.device("cuda")
    vocab = FullVocab()
    # What cli.train_lm builds from its defaults, at the full vocabulary.
    cfg = Seq2SeqConfig(vocab_size=32000, num_languages=2, hidden_size=768,
                        intermediate_size=3072, enc_layers=6, dropout=RATE,
                        attention_dropout=RATE, dtype="bfloat16")
    with tempfile.TemporaryDirectory() as workdir:
        # B * T = 8192: the masked-budget projection.
        B, T = 16, 512
        counters = ((fa, "LAUNCHES"), (ta, "FWD_LAUNCHES"),
                    (ta, "BWD_LAUNCHES"), (xent, "FWD_LAUNCHES"),
                    (xent, "BWD_LAUNCHES"))
        for mod, name in counters:
            setattr(mod, name, 0)
        trainer = LMTrainer(cfg, vocab, lr=5e-4, warmup=8, seed=SEED,
                            device=device)
        masters = {p.dtype for p in trainer.model.parameters()}
        if masters != {torch.float32}:
            raise AssertionError(f"master parameters are {masters}")
        torch.cuda.reset_peak_memory_stats()
        n_epoch, n_timed = 10, 8
        with Recorder() as rec:
            losses = _lm_epoch(trainer, workdir, "lm", B, T, n_epoch, n_timed,
                               card)
        counts = [getattr(mod, name) for mod, name in counters]
        if not sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 - 0.05:
            raise AssertionError(f"the MLM loss did not fall: {losses}")
        want = cfg.enc_layers * (n_epoch + n_timed)
        if counts != [0, want, want, 0, 0]:
            raise AssertionError(
                f"MLM steps at T=512: K3, K1 forward, K1 backward, K5 "
                f"forward, K5 backward launches {counts}, want "
                f"[0, {want}, {want}, 0, 0]")
        rec.require_checked("lm", checked_k1, set(), want_k5=False)
        k1_fwd, k1_bwd = counts[1], counts[2]
        log(f"[lm] BERT-base LM (768/12/3072, 6 layers, 512 positions, "
            f"V=32000, fp32 masters / bf16 compute, dropout {RATE}), budget "
            f"projection; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"{k1_fwd} + {k1_bwd} K1 launches in {n_epoch + n_timed} steps "
            f"({cfg.enc_layers} + {cfg.enc_layers} a step), no K3 or K5")
        staged = [lm_batch_to_device(b, device)
                  for b in itertools.islice(DocBlockDataset(os.path.join(
                      workdir, "lm_train")).batches(B, pad_id=0), 4)]

        def steps(tr, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                tr.state, m = tr.step_fn(tr.state, staged[i % len(staged)],
                                         tr.rng)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, m

        if profile:
            _profile(lambda: (steps(trainer, 3)[0], "3 MLM steps"),
                     "lm train", card)
        del trainer
        torch.cuda.empty_cache()

        # The paired reading: the MLM step with the fused dropout attention
        # off and on, two fresh trainers from one seed on the same batches,
        # blocks of steps in the order off, on, on, off (three times).
        arms = {on: LMTrainer(dataclasses.replace(cfg, fused_attn_dropout=on),
                              vocab, lr=5e-4, warmup=8, seed=SEED,
                              device=device) for on in (False, True)}
        for on in (False, True):
            steps(arms[on], 2)                           # warm-up
        block, ms = 4, {False: [], True: []}
        for on in (False, True, True, False) * 3:
            ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
            seconds, m = steps(arms[on], block)
            got = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES)
            if got != ((cfg.enc_layers * block,) * 2 if on else (0, 0)):
                raise AssertionError(f"a block of {block} MLM steps with the "
                                     f"fused attention {on} launched K1 "
                                     f"{got}")
            loss = (m["sum_loss"] / m["ntokens"]).item()
            if not loss == loss:
                raise AssertionError(f"MLM loss {loss} with K1 {on}")
            ms[on].append(1e3 * seconds / block)
        stats = {}
        for on in (False, True):
            xs = sorted(ms[on])
            med = (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2
            stats[on] = (med, xs[0], xs[-1])
        log(f"[lm] paired MLM step, B={B} T={T}, blocks of {block} steps in "
            f"the order off, on, on, off (x3): plain dropout attention "
            f"{ms[False]} ms/step (median {stats[False][0]:.2f}, spread "
            f"{stats[False][1]:.2f}..{stats[False][2]:.2f}; "
            f"{1e3 * B * T / stats[False][0]:.1f} positions/s), K1 "
            f"{ms[True]} ms/step (median {stats[True][0]:.2f}, spread "
            f"{stats[True][1]:.2f}..{stats[True][2]:.2f}; "
            f"{1e3 * B * T / stats[True][0]:.1f} positions/s); median "
            f"ratio {stats[True][0] / stats[False][0]:.3f} ({card})")
        del arms
        torch.cuda.empty_cache()

        # Dev evaluation of a 2048-position LM of the same width: K3.
        B, T = LONG_B, LONG_S
        long_cfg = dataclasses.replace(cfg, max_position_embeddings=T)
        dev_dir = os.path.join(workdir, "dev2048")
        write_blocks(dev_dir, 2 * B, T, cfg.vocab_size, B, SEED + 2)
        dev = DocBlockDataset(dev_dir, load_all=True)
        trainer = LMTrainer(long_cfg, vocab, seed=SEED, device=device)
        slot = os.path.join(workdir, "lm2048")
        fa.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_flash() as seen:
            loss_on = trainer.validate_and_save(slot, dev, B)
        t_on = time.perf_counter() - t0
        dev_launches = fa.LAUNCHES
        require_flash("lm dev evaluation", seen, checked_flash, dev_launches,
                      long_cfg.enc_layers * 2)
        if load_config(slot).max_position_embeddings != T:
            raise AssertionError("the best slot was not written")
        plain = LMTrainer(
            dataclasses.replace(long_cfg, use_pallas_attention=False), vocab,
            seed=SEED, device=device, params=trainer.params_tree())
        plain.best_dev_loss = -1.0                      # nothing is saved
        t0 = time.perf_counter()
        loss_off = plain.validate_and_save(slot, dev, B)
        t_off = time.perf_counter() - t0
        if (fa.LAUNCHES != dev_launches or not loss_on == loss_on
                or abs(loss_on - loss_off) > LM_DEV_RTOL * abs(loss_off)):
            raise AssertionError(
                f"lm dev loss with K3 {loss_on} and with the plain attention "
                f"{loss_off} (rtol {LM_DEV_RTOL}); {fa.LAUNCHES} launches")
        log(f"[lm] dev evaluation at 2048 positions, 2 batches of B={B} "
            f"T={T}: {dev_launches} K3 launches ({long_cfg.enc_layers} per "
            f"batch); dev loss {loss_on:.5f} with K3 (validate_and_save with "
            f"the checkpoint written: {t_on:.2f} s), {loss_off:.5f} with the "
            f"plain attention ({t_off:.2f} s, nothing saved); relative "
            f"difference {abs(loss_on - loss_off) / abs(loss_off):.2e}, "
            f"limit {LM_DEV_RTOL:.0e} ({card})")
        del trainer, plain
        torch.cuda.empty_cache()

        # The long-document LM as cli.train_lm --reformer --size 3 builds it.
        options = argparse.Namespace(
            model_size=3, dropout=RATE, dtype="bfloat16", learning_rate=5e-4,
            warmup=8, clip=1.0, mask_prob=0.15)
        trainer = LongDocTrainer.from_options(options, vocab, device=device)
        lcfg = trainer.cfg
        if (lcfg.hidden_size, lcfg.enc_layers, lcfg.max_position_embeddings,
                lcfg.vocab_size) != (256, 6, 4096, 32000):
            raise AssertionError(f"longdoc preset 3 built {lcfg}")
        torch.cuda.reset_peak_memory_stats()
        _lm_epoch(trainer, workdir, "longdoc", 8, 4096, 6, 6, card)
        log(f"[longdoc] preset 3 (256/2 heads/512, 6 layers, 4096 positions, "
            f"V=32000), local block attention in plain tensor code (no "
            f"kernel of its own in either package); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del trainer
        torch.cuda.empty_cache()
    return dev_launches, k1_fwd, k1_bwd


def phase_lm_cli(workdir, corpus):
    """Phase 15: documents -> cli.create_batches -> cli.train_lm ->
    cli.train_lm --reformer -> cli.train_mt --lm -> cli.translate, through
    files, on the card at the CLIs' default width."""
    from imagetranslate_tpu_torch.cli.create_batches import (
        main as create_batches_main,
    )
    from imagetranslate_tpu_torch.cli.train_lm import main as train_lm_main
    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.data.binarize import write_mt
    from imagetranslate_tpu_torch.data.loader import DocBlockDataset
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_config,
        load_params,
    )

    tok, _, lines, tp = corpus
    t0 = time.perf_counter()
    docs = os.path.join(workdir, "docs.txt")
    with open(docs, "w") as f:                     # 12 sentences a document
        for i in range(0, len(lines), 12):
            lang = "en" if (i // 12) % 2 == 0 else "fa"
            f.write(f"<{lang}> " + " </s> ".join(lines[i:i + 12])
                    + " </s>\n")
    blocks = os.path.join(workdir, "blocks")
    create_batches_main(["--data", docs, "--cache", blocks, "--tok", tok,
                         "--seq_len", "128", "--block", "16"])
    data = DocBlockDataset(blocks)
    if len(data) < 16 or data.file_count < 2 or len(data[0]) != 128:
        raise AssertionError(f"create_batches wrote {len(data)} rows in "
                             f"{data.file_count} blocks")
    lm, longdoc = (os.path.join(workdir, n) for n in ("lm", "longdoc"))
    steps = 4
    common = ["--tok", tok, "--train", blocks, "--dev", blocks, "--step",
              str(steps), "--batch", "8", "--lr", "0.001", "--warmup", "10",
              "--device", "cuda"]
    train_lm_main(["--model", lm, *common])
    train_lm_main(["--model", longdoc, "--reformer", "--size", "1", *common])
    for path, want in ((lm, (768, 6, 512)), (longdoc, (64, 4, 4096))):
        cfg = load_config(path)
        _, opt_tree, meta = load_checkpoint(path, with_opt_state=True)
        got = (cfg.hidden_size, cfg.enc_layers, cfg.max_position_embeddings)
        if (got != want or meta["step"] != steps
                or int(opt_tree["1"]["count"]) != steps
                or not meta["best_metric"] < float("inf")):
            raise AssertionError(f"train_lm checkpoint {path}: {got}, {meta}")
    mt = os.path.join(workdir, "lm_train.mt")
    write_mt(tp, mt, os.path.join(workdir, "en.txt"), tp.token_id("<en>"),
             os.path.join(workdir, "fa.txt"), tp.token_id("<fa>"))
    model = os.path.join(workdir, "lm_mt_model")
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    train_main(["--tok", tok, "--model", model, "--train_mt", mt, "--lm", lm,
                "--dec", "3", "--step", str(steps), "--lr", "0.0001",
                "--warmup", "10", "--device", "cuda"])
    fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
    if not (fwd == bwd == 12 * steps):
        raise AssertionError(f"train_mt --lm: {fwd} forward and {bwd} "
                             f"backward K1 launches in {steps} steps")
    latest = model + ".latest"
    got = load_params(latest)["params"]
    start = load_params(lm)["params"]
    moved = {}
    for name, a, b in (
            ("word table", got["embeddings"]["word"]["embedding"],
             start["embeddings"]["word"]["embedding"]),
            ("encoder layer 5 FFN",
             got["encoder"]["layers_5"]["ffn"]["output"]["kernel"],
             start["encoder"]["layers_5"]["ffn"]["output"]["kernel"]),
            ("output kernel", got["output_layers_0"]["proj"]["kernel"],
             start["embeddings"]["word"]["embedding"].T),
            ("output bias", got["output_layers_0"]["proj"]["bias"],
             start["out_bias"])):
        moved[name] = (a.float() - b.float()).abs().max().item()
    # Four steps at lr 1e-4 move a weight by 4e-4 at most; a fresh init
    # (std 0.02) would lie ~0.1 from the LM's tables.
    if max(moved.values()) > 2e-3:
        raise AssertionError(f"train_mt --lm did not start from the LM: "
                             f"{moved}")
    inp, out = (os.path.join(workdir, n) for n in ("lm_in.txt", "lm_out.txt"))
    with open(inp, "w") as f:
        f.write("\n".join(lines[:40]) + "\n")
    tkp.LAUNCHES = 0
    translate_main(["--tok", tok, "--model", latest, "--input", inp,
                    "--output", out, "--src", "en", "--target", "fa",
                    "--device", "cuda"])
    with open(out) as f:
        hyps = f.read().splitlines()
    if len(hyps) != 40 or tkp.LAUNCHES == 0:
        raise AssertionError(f"translate wrote {len(hyps)} lines with "
                             f"{tkp.LAUNCHES} kernel launches")
    log(f"[lm cli] {len(data)} rows of 128 tokens in {data.file_count} "
        f"blocks; cli.train_lm ({steps} steps, 768 wide, 6 layers) and "
        f"--reformer --size 1 ({steps} steps) wrote checkpoints with "
        f"optimizer state and a dev loss; cli.train_mt --lm started from the "
        f"LM (largest distance after {steps} steps {max(moved.values()):.2e}) "
        f"with {fwd} + {bwd} K1 launches; translated 40 lines with "
        f"{tkp.LAUNCHES} project_topk launches in "
        f"{time.perf_counter() - t0:.1f} s, e.g. {hyps[0]!r}")


K4_TOL = 2.0 ** -7    # bf16 outputs: two bf16 ulps of the largest value (both
                      # sides round p to bf16; the fp32 sums differ in order)
MT_DECODE = (64, 64, 4, 88)        # B, S, beam, L of phases 4 and 17
CAPTION_B, CAPTION_K, CAPTION_L = 192, 4, 32
CAPTION_TAIL = 5                   # real rows of caption_batches' tail batch
CAPTION_JPEGS = 20                 # files of the CLI's folder
DECODE_SCORE_RTOL = 2e-2          # sequence log-probability, fused vs plain
CAPTION_GRID_TOL = 2.0 ** -4       # bf16 ResNet grid vs the fp32 one


def decode_path_shapes():
    """The (R, H, D, live positions) that the decode paths of phases 17,
    18, 19, 21, 22 and 30 give K4: a decode of L positions launches at
    1 .. L-1 live ones."""
    rows = {MT_DECODE[0] * MT_DECODE[2]: MT_DECODE[3],
            CAPTION_B * CAPTION_K: CAPTION_L,
            -(-CAPTION_TAIL // 8) * 8 * CAPTION_K: CAPTION_L,
            -(-CAPTION_JPEGS // 8) * 8 * CAPTION_K: CAPTION_L,
            CAPTION_EVAL[0] * CAPTION_EVAL[1]: CAPTION_EVAL[2]}
    for R, L in module11_decode_rows().items():
        rows[R] = max(L, rows.get(R, 0))
    # Phase 23's cli.caption --obj: a full batch and the tail's rows.
    det_tail = DET_CAPTION_JPEGS % CAPTION_B
    for R in (CAPTION_B * CAPTION_K, -(-det_tail // 8) * 8 * CAPTION_K):
        rows[R] = max(DET_CAPTION_L, rows.get(R, 0))
    shapes = [(R, 12, 64, n) for R, L in rows.items() for n in range(1, L)]
    # Phase 30's expert-parallel decode at 1x2: the heads split, 6 a rank.
    R, L = MT_DECODE[0] * MT_DECODE[2], max_len_for_decode(MT_DECODE[1])
    return shapes + [(R, 6, 64, n) for n in range(1, L)]


@contextlib.contextmanager
def recording_decode_attention():
    """Records (R, H, D, prefix positions, live window slots, row maps) of
    every K4 launch of a run, in the set it yields."""
    from imagetranslate_tpu_torch.ops import decode_attention as da

    seen = set()
    launch = da._launch

    def wrapped(q, mk, mv, wk, wv, rowsel, wanc, t0, wlive, K):
        seen.add((*q.shape, t0, wlive,
                  rowsel is not None or wanc is not None))
        return launch(q, mk, mv, wk, wv, rowsel, wanc, t0, wlive, K)

    da._launch = wrapped
    try:
        yield seen
    finally:
        da._launch = launch


def require_decode_attention(what: str, seen, checked, launches: int,
                             want: int):
    if launches != want or not seen or seen - checked:
        raise AssertionError(
            f"{what}: {launches} K4 launches, want {want}; shapes not held "
            f"against the plain version: {sorted(seen - checked)[:8]}")


def phase_kernel_decode_attention(path_shapes):
    """Phase 16: the beam decode attention kernel against its plain version,
    and its times. ``path_shapes``: (R, H, D, n) of the later phases' gather
    form calls. Returns the kernel entry and the set of shapes checked."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    checked = set()

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def hold(what, q, mk, mv, wk, wv, rowsel, wanc, j):
        nonlocal worst
        with recording_decode_attention() as seen:
            out = da.decode_attention(q, mk, mv, wk, wv, rowsel, wanc, j)
        torch.cuda.synchronize()
        want = da.decode_attention_reference(q, mk, mv, wk, wv, rowsel, wanc,
                                             j)
        if out.shape != q.shape or out.dtype != torch.bfloat16 or not (
                torch.isfinite(out).all()):
            raise AssertionError(f"K4 output {out.shape} {out.dtype} at "
                                 f"{what}")
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if err > K4_TOL * scale:
            raise AssertionError(f"K4 at {what}: err {err:.3g}, limit "
                                 f"{K4_TOL * scale:.3g}")
        worst = max(worst, err)
        checked.update(seen)
        return err, scale

    # The gather form at every shape of the paths: a slice [:, :n] of a
    # longer cache, read in place, as the decode step passes it.
    caches = {}
    errs = []
    for R, H, D, n in path_shapes:
        if (R, H, D) not in caches:
            L = max(m for r, h, d, m in path_shapes if (r, h, d) == (R, H, D))
            caches[R, H, D] = (rand(R, H, D), rand(R, L + 1, H, D),
                               rand(R, L + 1, H, D))
        q, k, v = caches[R, H, D]
        errs.append(hold((R, H, D, n), q, k[:, :n], v[:, :n], None, None,
                         None, None, None)[0])
    log(f"[kernel K4] gather form at the {len(path_shapes)} shapes of the "
        f"decode paths (R in {sorted({s[0] for s in path_shapes})}, 1 .. L-1 "
        f"live positions of a longer cache): max abs err {max(errs):.3g}")
    del caches

    # Edge shapes of the gather form: one position, odd counts, a long row
    # (more than 48 KB of scores), every head width, odd row counts.
    for R, H, D, n in [(8, 12, 64, 1), (7, 12, 64, 7), (256, 12, 64, 88),
                       (5, 12, 64, 512), (3, 2, 64, 20000), (9, 4, 32, 33),
                       (9, 4, 128, 33), (6, 3, 24, 19), (2, 1, 8, 3)]:
        err, scale = hold((R, H, D, n), rand(R, H, D), rand(R, n, H, D),
                          rand(R, n, H, D), None, None, None, None, None)
        log(f"[kernel K4] R={R} H={H} D={D} n={n}, no row maps: max abs err "
            f"{err:.3g} ({err / scale:.2e} of max)")

    # With row maps, on the JAX kernel's own inputs: a prefix selected by
    # rowsel, window slots selected by wanc, slots 0 .. j live.
    for B, K, W, H, D, t0, j in [(64, 4, 44, 12, 64, 0, 43),
                                 (64, 4, 44, 12, 64, 44, 0),
                                 (64, 4, 44, 12, 64, 44, 17),
                                 (192, 4, 26, 12, 64, 0, 25),
                                 (3, 5, 7, 4, 32, 11, 6),
                                 (2, 3, 4, 2, 128, 5, 2)]:
        R = B * K
        rowsel = torch.randint(0, K, (B, K), generator=gen, device="cuda",
                               dtype=torch.int32)
        wanc = torch.randint(0, K, (B, K, W), generator=gen, device="cuda",
                             dtype=torch.int32)
        mk, mv = (rand(R, t0, H, D), rand(R, t0, H, D)) if t0 else (None,
                                                                    None)
        err, scale = hold((B, K, W, H, D, t0, j), rand(R, H, D), mk, mv,
                          rand(R, W, H, D), rand(R, W, H, D), rowsel, wanc, j)
        log(f"[kernel K4] B={B} K={K} W={W} H={H} D={D} t0={t0} j={j}, "
            f"random rowsel/wanc: max abs err {err:.3g} ({err / scale:.2e} "
            "of max)")
    # A map on one part only.
    B, K, W, H, D, t0, j = 8, 4, 6, 12, 64, 9, 3
    R = B * K
    args = (rand(R, H, D), rand(R, t0, H, D), rand(R, t0, H, D),
            rand(R, W, H, D), rand(R, W, H, D))
    rowsel = torch.randint(0, K, (B, K), generator=gen, device="cuda",
                           dtype=torch.int32)
    hold("rowsel only", *args, rowsel, None, j)

    # Few or long rows, where the plan splits a row's positions across a
    # cluster of blocks, and rows whose scores outgrow shared memory (an
    # fp32 scratch): the gather form, then both row maps.
    for R, H, D, n in [(32, 12, 64, 2048), (3, 2, 64, 20000),
                       (2, 12, 64, 40000), (1, 3, 128, 57344)]:
        err, scale = hold((R, H, D, n), rand(R, H, D), rand(R, n, H, D),
                          rand(R, n, H, D), None, None, None, None, None)
        log(f"[kernel K4] R={R} H={H} D={D} n={n}, no row maps"
            f"{plan_note(R, H, D, n, 0)}: max abs err {err:.3g} "
            f"({err / scale:.2e} of max)")
    for B, K, W, H, D, t0, j in [(8, 4, 300, 12, 64, 1800, 250),
                                 (1, 2, 12000, 12, 64, 30000, 9999)]:
        R = B * K
        rowsel = torch.randint(0, K, (B, K), generator=gen, device="cuda",
                               dtype=torch.int32)
        wanc = torch.randint(0, K, (B, K, W), generator=gen, device="cuda",
                             dtype=torch.int32)
        err, scale = hold((B, K, W, H, D, t0, j), rand(R, H, D),
                          rand(R, t0, H, D), rand(R, t0, H, D),
                          rand(R, W, H, D), rand(R, W, H, D), rowsel, wanc, j)
        log(f"[kernel K4] B={B} K={K} W={W} H={H} D={D} t0={t0} j={j}, "
            f"random rowsel/wanc{plan_note(R, H, D, t0, j + 1)}: max abs "
            f"err {err:.3g} ({err / scale:.2e} of max)")
    torch.cuda.empty_cache()

    # Two launches on the same inputs give the same bits.
    for R, n in ((256, 88), (768, 32)):
        q, k, v = rand(R, 12, 64), rand(R, n, 12, 64), rand(R, n, 12, 64)
        first = da.decode_attention(q, k, v)
        if not torch.equal(first, da.decode_attention(q, k, v)):
            raise AssertionError(f"K4 at R={R}, n={n}: two launches differ")
    log("[kernel K4] two launches bit-equal at R=256, n=88 and R=768, n=32")

    # Outside the gate or the kernel's layout the wrapper raises before a
    # launch, and counts nothing.
    launches = da.LAUNCHES
    q, k, v = rand(8, 12, 64), rand(8, 5, 12, 64), rand(8, 5, 12, 64)
    for bad in ((q.float(), k, v), (q, k.float(), v.float()),
                (q, k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)),
                (q, k.transpose(1, 2).contiguous().transpose(1, 2), v),
                (q.transpose(0, 1).contiguous().transpose(0, 1), k, v),
                (rand(8, 12, 60), rand(8, 5, 12, 60), rand(8, 5, 12, 60)),
                (q, k, v, None, None,
                 torch.zeros((2, 4), dtype=torch.int64, device="cuda"))):
        try:
            da.decode_attention(*bad)
        except (ValueError, TypeError):
            continue
        raise AssertionError("a call the kernel cannot take was launched")
    if da.LAUNCHES != launches:
        raise AssertionError("a refused call counted as a launch")
    log("[kernel K4] fp32 q, an fp32 or fp8 cache, strides the kernel cannot "
        "read, D % 8 != 0 and int64 maps raise before a launch")

    # Times, cold L2, at the last steps of the two decodes.
    entries = {}
    for name, R, n in (("MT decode", 256, 88), ("caption decode", 768, 32)):
        H, D = 12, 64
        q, k, v = rand(R, H, D), rand(R, n, H, D), rand(R, n, H, D)
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        runs = {"plain": [], "kernel": []}
        for arm in ("plain", "kernel", "kernel", "plain"):
            fn = (da.decode_attention_reference if arm == "plain"
                  else da.decode_attention)
            runs[arm].append(_time_ms(lambda: fn(q, k, v)))
        # The library yardstick: one fused PyTorch call on the same prefix,
        # never on the port's path.
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
        nbytes = (2 * R * n * H * D + 2 * R * H * D) * 2
        bnd = bound(nbytes, 4.0 * R * n * H * D)
        ms = sum(runs["kernel"]) / 2
        log(f"[kernel K4] {name}: R={R} n={n} H={H} D={D} bf16: kernel "
            f"{runs['kernel']} ms ({nbytes / ms / 1e6:.1f} GB/s), plain "
            f"version {runs['plain']} ms, SDPA {lib_ms:.4f} ms; bound "
            f"{bnd[0]:.4f} ms by {bnd[1]}")
        entries[name] = {"max_abs_err": worst, "ms": ms,
                         "plain_ms": sum(runs["plain"]) / 2,
                         "bound_ms": bnd[0], "bound_by": bnd[1],
                         "library_ms": lib_ms}
    time_decode_attention()
    torch.cuda.empty_cache()
    # The kernels line carries this slice's shape, the caption decode's.
    return entries["caption decode"], checked


def plan_note(R: int, H: int, D: int, t0: int, wlive: int) -> str:
    """The kernel's work plan at a shape, for the log."""
    from imagetranslate_tpu_torch.ops import decode_attention as da

    return f" ({da.work_plan(R, H, D, t0, wlive)})"


def k4_bound(R: int, H: int, D: int, n: int):
    """K4's bound at one shape: each live K and V line read once, q read and
    ctx written once, bf16; 4 operations a (position, channel)."""
    return bound((2 * R * n * H * D + 2 * R * H * D) * 2, 4.0 * R * n * H * D)


# Live positions phase 16 times K4 at, per decode: a decode of L positions
# launches at 1 .. L-1 of them, three layers a step.
K4_SWEEP = {"MT decode": (256, MT_DECODE[3], (1, 8, 22, 44, 88)),
            "caption decode": (CAPTION_B * CAPTION_K, CAPTION_L,
                               (1, 8, 16, 32))}
# (R, H, n): few rows, long rows; the last keeps its scores in the scratch.
K4_LONG = ((32, 12, 2048), (3, 2, 20000), (2, 12, 40000))


def time_decode_attention():
    """K4 where it runs: kernel and SDPA (a yardstick, never on the path),
    cold L2 after a write (the other kernels' method) and after a read, at
    the live positions the two decodes sweep, and at few or long rows; the
    sums over one decode's launches (3 layers x each step's n), the kernel's
    times interpolated linearly between the swept n."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    H, D = 12, 64

    def timed(R, H, n):
        q = torch.randn(R, H, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(R, n, H, D, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        sdpa = lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2))
        kernel = [_time_ms(lambda: da.decode_attention(q, k, v))
                  for _ in range(2)]
        lib = _time_ms(sdpa)
        clean = _time_ms(lambda: da.decode_attention(q, k, v), clean=True)
        lib_clean = _time_ms(sdpa, clean=True)
        bnd = k4_bound(R, H, D, n)
        ms = sum(kernel) / 2
        log(f"[kernel K4] sweep R={R} H={H} D={D} n={n}: kernel {kernel} ms "
            f"({bnd[0] / ms:.3f} of the bound {bnd[0]:.4f} ms by {bnd[1]}), "
            f"SDPA {lib:.4f} ms; after a read flush: kernel {clean:.4f} ms "
            f"({bnd[0] / clean:.3f} of the bound), SDPA {lib_clean:.4f} ms")
        return ms, clean

    for name, (R, L, ns) in K4_SWEEP.items():
        times = [timed(R, H, n) for n in ns]
        sums = [0.0, 0.0]
        bound_sum = 0.0
        for n in range(1, L):
            i = max(i for i, m in enumerate(ns) if m <= n)
            for arm in (0, 1):
                t = times[i][arm]
                if ns[i] != n and i + 1 < len(ns):
                    f = (n - ns[i]) / (ns[i + 1] - ns[i])
                    t += f * (times[i + 1][arm] - t)
                sums[arm] += 3 * t
            bound_sum += 3 * k4_bound(R, H, D, n)[0]
        log(f"[kernel K4] one {name} (R={R}, n=1..{L - 1}, 3 layers: "
            f"{3 * (L - 1)} launches): kernel {sums[0]:.3f} ms (after a read "
            f"flush {sums[1]:.3f} ms; interpolated linearly between n in "
            f"{list(ns)}), bound {bound_sum:.3f} ms, {bound_sum / sums[0]:.3f} "
            "of it")
    for R, h, n in K4_LONG:
        timed(R, h, n)


def sequence_scores(model, src, best):
    """Log-probability of each decoded row ``best`` [B, L] given ``src``
    under ``model`` (teacher-forced, fp32 log-softmax of its logits)."""
    import torch

    B, S = src.shape
    dev = src.device
    with torch.no_grad():
        logits = model(src, torch.ones((B, S), dtype=torch.bool, device=dev),
                       best, torch.ones_like(best, dtype=torch.bool),
                       torch.zeros((B,), dtype=torch.int32, device=dev),
                       torch.ones((B,), dtype=torch.int32, device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1)
        return logp.gather(2, best[:, 1:, None])[..., 0].sum(dim=1)


def phase_decode_fused(card, checked_k4):
    """Phase 17: phase 4's decode with every step's self-attention through
    K4 (``decode_attention_impl="fused"``), beside the same decode with the
    plain attention over the masked buffer (``"onehot"``), on one set of
    weights. Returns the K4 launches of the counted run."""
    import dataclasses

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    device = torch.device("cuda")
    B, S, K, L = MT_DECODE
    cfg = bert_base(32000)
    plain = build_model(cfg, device)
    fused = Seq2Seq(dataclasses.replace(cfg, decode_attention_impl="fused"),
                    device=device)
    fused.load_state_dict(plain.state_dict())
    fused.eval()
    models = {"fused": fused, "onehot": plain}
    for m in models.values():
        run_decode(m, B, S, K, device)                # warm-up
    da.LAUNCHES = tkp.LAUNCHES = 0
    with recording_decode_attention() as seen:
        best_f, lengths, steps, _ = run_decode(fused, B, S, K, device)
    launches = da.LAUNCHES
    require_decode_attention("MT decode", seen, checked_k4, launches,
                             cfg.dec_layers * steps)
    if tkp.LAUNCHES != steps:
        raise AssertionError(f"project_topk launched {tkp.LAUNCHES} times in "
                             f"{steps} decode steps")
    da.LAUNCHES = 0
    best_o = run_decode(plain, B, S, K, device)[0]
    if da.LAUNCHES != 0:
        raise AssertionError('"onehot" launched K4')
    # bf16 decodes may part at a near-tie: compare what they found by its
    # score under one model, and report the share of equal tokens.
    src = torch.as_tensor(np.random.RandomState(SEED).randint(
        5, cfg.vocab_size, (B, S))).to(device)
    score_f = sequence_scores(plain, src, best_f)
    score_o = sequence_scores(plain, src, best_o)
    rel = ((score_f - score_o).abs() / score_o.abs()).max().item()
    same = (best_f == best_o).float().mean().item()
    if rel > DECODE_SCORE_RTOL:
        raise AssertionError(f"fused and onehot decodes differ in score by "
                             f"{rel:.3g} (limit {DECODE_SCORE_RTOL})")
    secs = {"fused": [], "onehot": []}
    tokens = int(lengths.sum())
    for arm in ("fused", "onehot", "onehot", "fused"):
        secs[arm].append(run_decode(models[arm], B, S, K, device)[3])
    tps = {arm: tokens / (sum(v) / 2) for arm, v in secs.items()}
    log(f"[decode K4] BERT-base bf16 B={B} S={S} beam={K} L={L}: {steps} "
        f"steps, {launches} K4 launches ({cfg.dec_layers} a step) at "
        f"{len(seen)} shapes, all held by phase 16; {same:.4f} of the tokens "
        f"equal the onehot decode's, sequence scores within {rel:.2e} "
        f"(limit {DECODE_SCORE_RTOL:.0e}); encode + beam search in the order "
        f"fused, onehot, onehot, fused: fused {secs['fused']} s = "
        f"{tps['fused']:.1f} tok/s, onehot {secs['onehot']} s = "
        f"{tps['onehot']:.1f} tok/s ({card})")
    del plain, fused
    torch.cuda.empty_cache()
    return launches


class CaptionVocab(FullVocab):
    """``FullVocab`` with the ``decode`` that ``caption_batches`` calls (a
    token is written as its id) and a separator outside the model's
    vocabulary, so every row decodes to its limit and the launches of a
    batch are known exactly."""

    def sep_token_id(self) -> int:
        return -1

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def caption_config(vocab_size: int):
    """BERT-base text stack with the ResNet-18 grid encoder at 224 pixels
    (49 grid slots) and the object stream, K4 in every decode step."""
    import dataclasses

    return dataclasses.replace(bert_base(vocab_size), resnet_depth=1,
                               img_size=224, use_obj=True,
                               decode_attention_impl="fused")


def phase_caption(card, profile: bool, checked_k4):
    """Phase 18: the captioning path at full width. Returns the (K4, K2)
    launches of its counted runs."""
    import dataclasses

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import caption as cli
    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        beam_search_dual,
    )
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
    from imagetranslate_tpu_torch.train.weights import CAPTION

    device = torch.device("cuda")
    cfg = caption_config(32000)
    B, K, L = CAPTION_B, CAPTION_K, CAPTION_L
    t0 = time.perf_counter()
    variables = CAPTION.random_params(cfg, SEED)
    model = ImageSeq2Seq(cfg, device=device)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg))
    model.eval()
    rng = np.random.RandomState(SEED)
    images_np = rng.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)
                            ).astype(np.uint8)
    images = torch.as_tensor(images_np).to(device)
    first = torch.full((B,), 6, dtype=torch.int32, device=device)
    langs = torch.ones((B,), dtype=torch.int32, device=device)
    text = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, 32))).to(device)
    text_mask = torch.ones((B, 32), dtype=torch.bool, device=device)
    feats = torch.as_tensor(rng.standard_normal((B, 16, 1031)).astype(
        np.float32)).to(device)
    labels_np = rng.randint(1, 91, (B, 16))
    labels_np[:, 10:] = 0                     # padded detections
    labels = torch.as_tensor(labels_np).to(device)
    log(f"[caption] ImageSeq2Seq BERT-base + ResNet-18 at 224 + object "
        f"stream, bf16, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}"
        f" M parameters from numpy seed {SEED}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # The grid on a small input against an fp32 model of the same weights.
    f32 = ImageSeq2Seq(dataclasses.replace(cfg, dtype="float32"),
                       device=device)
    f32.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg))
    f32.eval()
    with torch.no_grad():
        grid_ref = f32.encode_images(images[:4])
        grid_small = model.encode_images(images[:4])
    diff = (grid_small.float() - grid_ref).abs().max().item()
    scale = grid_ref.abs().max().item()
    if not torch.isfinite(grid_small).all() or diff > CAPTION_GRID_TOL * scale:
        raise AssertionError(f"bf16 grid differs from the fp32 one by "
                             f"{diff:.3g} (limit {CAPTION_GRID_TOL * scale:.3g})")
    log(f"[caption] encode_images on 4 images: bf16 grid within {diff:.3g} of "
        f"the fp32 model's ({diff / scale:.2e} of the largest value, limit "
        f"{CAPTION_GRID_TOL:.2e})")
    del f32, grid_ref
    torch.cuda.empty_cache()

    common = dict(beam_width=K, max_len=L, len_penalty_ratio=0.8,
                  pad_id=cfg.pad_id, eos_id=-1)   # EOS outside the vocabulary

    def single():
        grid = model.encode_images(images)
        mask = torch.ones(grid.shape[:2], dtype=torch.bool, device=device)
        return grid, beam_search(model, grid, mask, first, langs, **common)

    def dual():
        grid = model.encode_images(images)
        enc = model.encode(text, text_mask, torch.zeros_like(langs))
        return grid, beam_search_dual(model, enc, text_mask, grid, first,
                                      langs, **common)

    def obj_dual():
        grid = model.encode_images(images)
        mask = torch.ones(grid.shape[:2], dtype=torch.bool, device=device)
        states, keep = model.encode_objects(feats, labels)
        return grid, beam_search_dual(
            model, grid, mask, states, first, langs, grid_mask=keep,
            init_method=ImageSeq2Seq.init_obj_dual_cache,
            step_method=ImageSeq2Seq.decode_step_obj_dual, **common)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            grid, (best, lengths) = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if grid.shape != (B, 49, cfg.hidden_size) or not (
                torch.isfinite(grid).all()):
            raise AssertionError(f"grid {tuple(grid.shape)}, finite "
                                 f"{torch.isfinite(grid).all().item()}")
        if best.shape != (B, L) or not (best[:, 0] == 6).all() or not (
                (best >= 0) & (best < cfg.vocab_size)).all():
            raise AssertionError(f"caption decode gave {tuple(best.shape)}")
        if not (lengths == L).all():
            raise AssertionError(f"lengths {lengths.unique().tolist()}, want "
                                 f"every row at its limit {L}")
        return seconds, torch.cuda.max_memory_allocated() / 2 ** 30

    k4_total = k2_total = 0
    steps = L - 1
    for name, fn, streams in (("beam_search over the grid", single, 1),
                              ("beam_search_dual text + image", dual, 2),
                              ("beam_search_dual grid + objects", obj_dual,
                               2)):
        timed(fn)                                      # warm-up
        da.LAUNCHES = tkp.LAUNCHES = 0
        with recording_decode_attention() as seen:
            seconds, peak = timed(fn)
        k4, k2 = da.LAUNCHES, tkp.LAUNCHES
        require_decode_attention(name, seen, checked_k4, k4,
                                 streams * cfg.dec_layers * steps)
        if k2 != steps:
            raise AssertionError(f"{name}: {k2} K2 launches in {steps} steps")
        k4_total, k2_total = k4_total + k4, k2_total + k2
        log(f"[caption] {name}: B={B} beam={K} L={L}, {steps} steps, K4 "
            f"launches {k4} ({streams * cfg.dec_layers} a step), K2 launches "
            f"{k2}")
        log(f"[caption] {name}: {B / seconds:.1f} images/s "
            f"({B * (L - 1) / seconds:.1f} tok/s; encode + decode "
            f"{seconds:.3f} s), peak memory {peak:.2f} GiB ({card})")
    if profile:
        def run():
            return timed(single)[0], f"{steps} steps, B={B}"
        _profile(run, "caption", card)

        def run_dual():
            return timed(obj_dual)[0], f"{steps} steps, B={B}, grid + objects"
        _profile(run_dual, "caption obj dual", card)

    # caption_batches over a caller's batcher: the dicts ImageFolderBatcher
    # yields, built from arrays; the second carries detections.
    tp = CaptionVocab()

    def batch(n_real, with_objects):
        rows = -(-n_real // 8) * 8
        out = {"paths": [f"image{i:04d}.jpg" for i in range(n_real)],
               "images": images_np[:rows],
               "first_tokens": np.full((rows,), 6, np.int32),
               "tgt_langs": np.ones((rows,), np.int32)}
        if with_objects:
            out["box_features"] = feats[:rows].cpu().numpy()
            out["object_labels"] = labels_np[:rows]
        return out

    batches = [batch(B, False), batch(CAPTION_TAIL, False),
               batch(CAPTION_TAIL, True)]

    class Lines:
        def __init__(self):
            self.lines = []

        def write(self, text):
            self.lines.append(text)

    def run_batches():
        writer = Lines()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = cli.caption_batches(model, tp, batches, writer, beam_width=K,
                                max_len=L)
        torch.cuda.synchronize()
        return n, writer.lines, time.perf_counter() - t0

    run_batches()                                     # warm-up
    da.LAUNCHES = tkp.LAUNCHES = 0
    with recording_decode_attention() as seen:
        n, lines, seconds = run_batches()
    k4, k2 = da.LAUNCHES, tkp.LAUNCHES
    want_n = B + 2 * CAPTION_TAIL
    if n != want_n or len(lines) != want_n or not all(
            ln.startswith("image") and ln.endswith("\n")
            and len(ln.split("\t")[1].split()) == steps for ln in lines):
        raise AssertionError(f"caption_batches wrote {len(lines)} lines for "
                             f"{want_n} images, or a caption short of "
                             f"{steps} tokens")
    # Every batch decodes to its limit: one K2 launch a step, a K4 launch a
    # step, decoder layer and stream; two batches have one stream, the one
    # with detections two.
    want_k2 = 3 * steps
    want_k4 = cfg.dec_layers * steps * (1 + 1 + 2)
    if not seen or seen - checked_k4 or k2 != want_k2 or k4 != want_k4:
        raise AssertionError(
            f"caption_batches: {k4} K4 and {k2} K2 launches, want {want_k4} "
            f"and {want_k2}; unchecked shapes "
            f"{sorted(seen - checked_k4)[:8]}")
    k4_total, k2_total = k4_total + k4, k2_total + k2
    log(f"[caption] caption_batches over 3 batches from arrays ({B} images, "
        f"a tail of {CAPTION_TAIL} in 8 rows, the tail again with "
        f"detections): {n} lines, K4 launches {k4}, K2 launches {k2}, "
        f"{n / seconds:.1f} images/s, e.g. {lines[0]!r} ({card})")
    del model
    torch.cuda.empty_cache()

    # The CLI over a folder of JPEGs, where Pillow can write and read them.
    try:
        from PIL import Image
    except ImportError:
        log("[caption cli] Pillow is not installed on this machine: "
            "cli.caption.main over a folder of JPEGs was not run (no JPEG "
            "decoder; the array-driven caption_batches above is the same "
            "loop)")
        return k4_total, k2_total
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        corpus = os.path.join(workdir, "corpus.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
                0, len(WORDS), rng.randint(2, 9))) for _ in range(400)))
        tok = os.path.join(workdir, "tok")
        TextProcessor().train_tokenizer([corpus], 300, tok,
                                        {"<en>": 0, "<fa>": 1})
        ccfg = dataclasses.replace(
            caption_config(TextProcessor(tok).vocab_size()), use_obj=False)
        ckpt = os.path.join(workdir, "model")
        save_checkpoint(ckpt, ccfg, CAPTION.random_params(ccfg, SEED))
        folder = os.path.join(workdir, "images")
        os.makedirs(folder)
        for i in range(CAPTION_JPEGS):
            # Smooth pictures of several sizes (noise does not compress).
            w, h = 240 + 16 * i, 400 - 8 * i
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            arr = np.stack([127 + 120 * np.sin(xx / (9 + c + i) + yy / (
                13 + 2 * c)) for c in range(3)], axis=-1).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(folder, f"{i:03d}.jpg"))
        out = os.path.join(workdir, "captions.tsv")
        da.LAUNCHES = tkp.LAUNCHES = 0
        with recording_decode_attention() as seen:
            cli.main(["--tok", tok, "--model", ckpt, "--input", folder,
                      "--output", out, "--target", "fa", "--max_len",
                      str(CAPTION_L), "--device", "cuda"])
        with open(out) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        k4, k2 = da.LAUNCHES, tkp.LAUNCHES
        if len(rows) != CAPTION_JPEGS or not all(
                len(r) == 2 and r[0].endswith(".jpg") for r in rows):
            raise AssertionError(f"cli.caption wrote {len(rows)} lines for "
                                 f"{CAPTION_JPEGS} files")
        if not seen or seen - checked_k4 or k2 == 0 or k4 != 3 * k2:
            raise AssertionError(
                f"cli.caption: {k4} K4 and {k2} K2 launches, unchecked "
                f"shapes {sorted(seen - checked_k4)[:8]}")
        log(f"[caption cli] {CAPTION_JPEGS} JPEGs -> cli.caption.main (vocab "
            f"{ccfg.vocab_size}, width 768, 6+3 layers, ResNet-18 at 224): "
            f"{len(rows)} lines, K4 launches {k4}, K2 launches {k2}, in "
            f"{time.perf_counter() - t0:.1f} s, e.g. {rows[0]!r}")
    return k4_total + k4, k2_total + k2


# ---------------- phase 19: caption training ----------------

CAPTION_TRAIN = (32, 32)           # images a batch (--max-image), caption T
CAPTION_MT = (128, 64, 64)         # B, S, T of the MT stream's batches
CAPTION_OBJECTS = (16, 10)         # detection slots, live ones
CAPTION_EVAL = (16, 5, 32)         # dev images, beam (--beam), L
CAPTION_CLI_ROWS = 8               # --max-image of the CLI run


def caption_train_k1_shapes():
    """(B, T, S, H, D) the caption, object and MT-stream steps of phase 19
    give K1 (its CLI run included)."""
    B, T = CAPTION_TRAIN
    mb, ms, mt = CAPTION_MT
    t = T - 1
    return [(B, t, t, 12, 64), (B, t, 49, 12, 64),
            (B, t, CAPTION_OBJECTS[0], 12, 64),
            (mb, ms, ms, 12, 64), (mb, mt - 1, mt - 1, 12, 64),
            (mb, mt - 1, ms, 12, 64),
            (CAPTION_CLI_ROWS, t, t, 12, 64), (CAPTION_CLI_ROWS, t, 49, 12, 64)]


def caption_train_config(vocab_size: int, **kw):
    """The CLI's defaults: BERT-base text stack with 6 + 6 layers, ResNet-18
    at 224 pixels, dropout 0.1, fp32 masters and bf16 compute; K1 in every
    attention, K4 in the dev decode; ``use_pallas_xent`` on, which the
    caption steps must ignore."""
    import dataclasses

    return dataclasses.replace(bert_base(vocab_size), **{
        "dec_layers": 6, "dropout": RATE, "attention_dropout": RATE,
        "resnet_depth": 1, "img_size": 224, "fused_attn_dropout": True,
        "decode_attention_impl": "fused", "use_pallas_xent": True, **kw})


class ArrayBatcher:
    """A caption (or MT) batcher over batches made here: ``shuffled`` keeps
    their order."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def shuffled(self, seed):
        return iter(self.batches)


def caption_host_batches(cfg, n: int, seed=SEED):
    """n caption batches of B uint8 images from the seed (their ``images``
    return the arrays: no files, no Pillow) and captions over the whole
    vocabulary (ids drawn with a skew, rows padded to random lengths)."""
    import numpy as np

    from imagetranslate_tpu_torch.data.images import CaptionBatch

    class ArrayCaptionBatch(CaptionBatch):
        def images(self, root_dir="", size=224, raw=False):
            return self.arrays

    B, T = CAPTION_TRAIN
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        caps = (5 + (cfg.vocab_size - 5) * rng.rand(B, T) ** 3).astype(
            np.int32)
        caps[:, 0] = 6
        lengths = rng.randint(T // 2, T + 1, B).astype(np.int32)
        caps[np.arange(T)[None, :] >= lengths[:, None]] = cfg.pad_id
        b = ArrayCaptionBatch([f"img{i:03d}.jpg" for i in range(B)], caps,
                              caps != cfg.pad_id, np.zeros(B, np.int32),
                              lengths, np.ones(B, bool))
        b.arrays = rng.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)
                               ).astype(np.uint8)
        out.append(b)
    return out


def mt_host_batches(cfg, n: int, seed=SEED):
    """n MTBatches of the MT stream's shape, full rows."""
    import numpy as np

    from imagetranslate_tpu_torch.data.loader import MTBatch

    B, S, T = CAPTION_MT
    rng = np.random.RandomState(seed + 1)

    def ids(shape):
        return (5 + (cfg.vocab_size - 5) * rng.rand(*shape) ** 3).astype(
            np.int32)

    ones = np.ones((B,), np.int32)
    return [MTBatch(src, src != cfg.pad_id, dst, dst != cfg.pad_id,
                    0 * ones, ones, S * ones, ones.astype(bool))
            for src, dst in ((ids((B, S)), ids((B, T))) for _ in range(n))]


def set_config(model, cfg):
    """Hand every module of ``model`` that reads a config ``cfg`` (the
    config is frozen; the modules share one reference)."""
    for module in model.modules():
        if hasattr(module, "cfg"):
            module.cfg = cfg


@contextlib.contextmanager
def recording_topk():
    """Records (M, k) of every K2 launch of a run, in the set it yields."""
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    seen = set()
    launch = tkp._launch

    def wrapped(h, w, b, k):
        seen.add((h.shape[0], k))
        return launch(h, w, b, k)

    tkp._launch = wrapped
    try:
        yield seen
    finally:
        tkp._launch = launch


def phase_caption_train(card, profile: bool, checked_k1, checked_xent,
                        checked_k4):
    """Phase 19: caption training at the CLI's full width. Returns the K1
    forward and backward, K2 and K4 launches of its counted runs."""
    import dataclasses

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.step import caption_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_caption import CaptionTrainer

    device = torch.device("cuda")
    B, T = CAPTION_TRAIN
    V = 32000
    cfg = caption_train_config(V)
    warm, timed = 3, 9
    t0 = time.perf_counter()
    trainer = CaptionTrainer(cfg, CaptionVocab(), lr=5e-4, warmup=8,
                             beam_width=CAPTION_EVAL[1], seed=SEED,
                             device=device)
    masters = {p.dtype for p in trainer.model.parameters()}
    if masters != {torch.float32}:
        raise AssertionError(f"master parameters are {masters}, want fp32")
    host = caption_host_batches(cfg, 4)
    batches = [caption_batch_to_device(b, b.arrays, device) for b in host]
    log(f"[caption train] CaptionTrainer BERT-base 6+6 + ResNet-18 at 224, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M "
        f"fp32 master parameters, bf16 compute, dropout {RATE}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(tr, step_fn, staged, n, into):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tr.state, m = step_fn(tr.state, staged[len(into) % len(staged)],
                                  tr.rng)
            into.append(m)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def losses(metrics):
        out = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
        if not all(x == x and abs(x) != float("inf") for x in out):
            raise AssertionError(f"loss not finite: {out}")
        return out

    def require_k1(what, n_steps, per_step):
        fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        if not (fwd == bwd == per_step * n_steps):
            raise AssertionError(f"{what}: {fwd} forward and {bwd} backward "
                                 f"K1 launches in {n_steps} steps, want "
                                 f"{per_step} + {per_step} a step")
        if xent.FWD_LAUNCHES or xent.BWD_LAUNCHES:
            raise AssertionError(f"{what}: K5 launched ({xent.FWD_LAUNCHES} "
                                 f"+ {xent.BWD_LAUNCHES}); the caption "
                                 "steps' loss is smoothed_nll_loss")
        return fwd, bwd

    def reset():
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0

    # The caption step: 3 warm-up steps recording K1's shapes, 9 timed.
    stats0 = {k: v.clone() for k, v in trainer.model.named_buffers()}
    resnet0 = {k: v.clone() for k, v in trainer.model.named_parameters()
               if k.startswith("image_model.")}
    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = []
    with Recorder() as rec:
        run(trainer, trainer.cap_step, batches, warm, metrics)
    rec.require_checked("caption train", checked_k1, checked_xent,
                        want_k5=False)
    seconds = run(trainer, trainer.cap_step, batches, timed, metrics)
    per_cap = 2 * cfg.dec_layers
    fwd, bwd = require_k1("caption step", warm + timed, per_cap)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cap_losses = losses(metrics)
    first, last = sum(cap_losses[:3]) / 3, sum(cap_losses[-3:]) / 3
    if not last < first - 0.1:
        raise AssertionError(f"caption loss did not fall: {cap_losses}")
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in trainer.model.named_buffers())
    changed = sum(not torch.equal(v, resnet0[k]) for k, v in
                  trainer.model.named_parameters() if k in resnet0)
    if moved != len(stats0) or changed < len(resnet0) - 2:
        raise AssertionError(f"{moved}/{len(stats0)} BatchNorm statistics "
                             f"moved, {changed}/{len(resnet0)} ResNet "
                             "parameters changed")
    log(f"[caption train] caption step B={B} T={T}: {timed} steps in "
        f"{seconds:.3f} s = {1e3 * seconds / timed:.1f} ms/step, "
        f"{B * timed / seconds:.1f} images/s; loss {first:.4f} -> "
        f"{last:.4f}; K1 {fwd} + {bwd} ({per_cap} + {per_cap} a step), K5 "
        f"0; {moved}/{len(stats0)} BatchNorm statistics moved; peak memory "
        f"{peak:.2f} GiB ({card})")
    if profile:
        _profile(lambda: (run(trainer, trainer.cap_step, batches, 1, []),
                          f"1 caption step, B={B}"), "caption train", card)

    # A reading, not a claim: the same trainer's caption step with its
    # attention on the fused kernels and on the plain path (the model's
    # config switched between blocks), a warm-up step of the plain path,
    # then blocks of 3 steps in the order off, on, on, off. Its launches
    # are not counted.
    arms = {fused: dataclasses.replace(cfg, fused_attn_dropout=fused)
            for fused in (False, True)}
    set_config(trainer.model, arms[False])
    run(trainer, trainer.cap_step, batches, 1, [])
    block, ms = 3, {False: [], True: []}
    for fused in (False, True, True, False):
        set_config(trainer.model, arms[fused])
        ms[fused].append(1e3 * run(trainer, trainer.cap_step, batches, block,
                                   []) / block)
    set_config(trainer.model, cfg)
    log(f"[caption train] paired on one trainer, same batches, blocks of "
        f"{block} steps in the order off, on, on, off: fused_attn_dropout "
        f"off {ms[False]} ms/step, on {ms[True]} ms/step ({card})")

    # train_epoch: the caption stream and the MT stream interleaved, images
    # from arrays through the prefetch thread, the meter, a .latest save.
    n_ticks = 3
    reset()
    with Recorder() as rec, tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        step = trainer.train_epoch(
            0, os.path.join(workdir, "model"),
            ArrayBatcher(caption_host_batches(cfg, n_ticks, SEED + 7)),
            mt_batcher=ArrayBatcher(mt_host_batches(cfg, n_ticks + 1)),
            eval_every=10 ** 9, save_every=10 ** 9, log_every=2)
        epoch_s = time.perf_counter() - t0
        saved = os.path.exists(os.path.join(workdir, "model.latest",
                                            "opt_state.msgpack"))
    rec.require_checked("caption train_epoch", checked_k1, checked_xent,
                        want_k5=False)
    per_mt = cfg.enc_layers + 2 * cfg.dec_layers
    if step != 2 * n_ticks or not saved:
        raise AssertionError(f"train_epoch took {step} steps (want "
                             f"{2 * n_ticks}), .latest saved: {saved}")
    if not (ta.FWD_LAUNCHES == ta.BWD_LAUNCHES
            == n_ticks * (per_cap + per_mt)) or xent.FWD_LAUNCHES:
        raise AssertionError(f"train_epoch: {ta.FWD_LAUNCHES} + "
                             f"{ta.BWD_LAUNCHES} K1 launches in {n_ticks} "
                             f"caption and {n_ticks} MT steps, "
                             f"{xent.FWD_LAUNCHES} K5")
    fwd, bwd = fwd + ta.FWD_LAUNCHES, bwd + ta.BWD_LAUNCHES
    log(f"[caption train] train_epoch: {n_ticks} caption + {n_ticks} MT "
        f"(B={CAPTION_MT[0]}, S=T={CAPTION_MT[1]}) steps, K1 "
        f"{ta.FWD_LAUNCHES} + {ta.BWD_LAUNCHES} ({per_cap} a caption step, "
        f"{per_mt} an MT step), .latest written, in {epoch_s:.1f} s")

    # The dev decode: 16 images at beam 5 over the grid on the trained
    # masters (cast to bf16 where used): K2 and K4 every step.
    n_img, beam, L = CAPTION_EVAL
    rng = np.random.RandomState(SEED + 3)
    images = rng.randint(0, 256, (n_img, 224, 224, 3)).astype(np.uint8)
    first_tok = np.full((n_img,), 6, np.int32)
    langs = np.ones((n_img,), np.int32)
    trainer.caption_images(images, first_tok, langs, L)     # warm-up
    da.LAUNCHES = tkp.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_decode_attention() as seen4, recording_topk() as seen2:
        best, lengths = trainer.caption_images(images, first_tok, langs, L)
        torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    steps = L - 1
    k2, k4 = tkp.LAUNCHES, da.LAUNCHES
    require_decode_attention("caption dev decode", seen4, checked_k4, k4,
                             cfg.dec_layers * steps)
    k2_cases = {(M, k) for M, k, _ in k2_random_cases()}
    if k2 != steps or seen2 - k2_cases:
        raise AssertionError(f"dev decode: {k2} K2 launches in {steps} "
                             f"steps; (M, k) not held by phase 3: "
                             f"{sorted(seen2 - k2_cases)}")
    if best.shape != (n_img, L) or not (lengths == L).all() or not (
            (best >= 0) & (best < V)).all():
        raise AssertionError(f"dev decode gave {tuple(best.shape)}, "
                             f"lengths {lengths.unique().tolist()}")
    log(f"[caption train] dev decode (caption_images) of {n_img} images at "
        f"beam {beam}, L={L}: K2 {k2} launches at (M, k) {sorted(seen2)}, K4 "
        f"{k4} ({cfg.dec_layers} a step), {n_img / dec_s:.1f} images/s "
        f"({card})")
    del trainer, batches
    torch.cuda.empty_cache()

    # The object step: 16 detection slots, 10 live, one row with none; the
    # image tower frozen (--fimg).
    ocfg = caption_train_config(V, use_obj=True, freeze_image=True)
    otr = CaptionTrainer(ocfg, CaptionVocab(), lr=5e-4, warmup=8,
                         beam_width=CAPTION_EVAL[1], seed=SEED, device=device)
    n_obj, live = CAPTION_OBJECTS
    orng = np.random.RandomState(SEED + 5)
    labels = orng.randint(1, 91, (B, n_obj)).astype(np.int32)
    labels[:, live:] = 0
    labels[0] = 0
    obatches = [caption_batch_to_device(
        b, b.arrays, device,
        (orng.standard_normal((B, n_obj, 1031)).astype(np.float32), labels))
        for b in host]
    stats0 = {k: v.clone() for k, v in otr.model.named_buffers()}
    params0 = {k: v.clone() for k, v in otr.model.named_parameters()}
    reset()
    torch.cuda.reset_peak_memory_stats()
    ometrics = []
    with Recorder() as rec:
        run(otr, otr.cap_obj_step, obatches, 2, ometrics)
    rec.require_checked("caption object step", checked_k1, checked_xent,
                        want_k5=False)
    oseconds = run(otr, otr.cap_obj_step, obatches, 4, ometrics)
    per_obj = 4 * ocfg.dec_layers
    ofwd, obwd = require_k1("object step", 6, per_obj)
    losses(ometrics)
    frozen = [k for k in params0 if k.startswith("image_model.")]
    if any(not torch.equal(params0[k], dict(otr.model.named_parameters())[k])
           for k in frozen):
        raise AssertionError("--fimg: a ResNet parameter changed")
    if any(torch.equal(v, stats0[k]) for k, v in otr.model.named_buffers()):
        raise AssertionError("--fimg: a BatchNorm statistic did not move")
    trained = sum(not torch.equal(v, params0[k])
                  for k, v in otr.model.named_parameters()
                  if k.startswith(("obj_", "object_", "multistream")))
    log(f"[caption train] object step B={B}, {n_obj} detection slots "
        f"({live} live, one row with none), ResNet frozen: "
        f"{1e3 * oseconds / 4:.1f} ms/step, K1 {ofwd} + {obwd} ({per_obj} + "
        f"{per_obj} a step), K5 0; {len(frozen)} ResNet parameters "
        f"bit-equal, its statistics moved, {trained} object-stream "
        f"parameters trained; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    fwd, bwd = fwd + ofwd, bwd + obwd

    # The dev decode of --obj: grid + objects, both streams through K4.
    feats = orng.standard_normal((n_img, n_obj, 1031)).astype(np.float32)
    olabels = labels[:n_img]
    da.LAUNCHES = tkp.LAUNCHES = 0
    with recording_decode_attention() as seen4, recording_topk() as seen2:
        best, lengths = otr.caption_images(images, first_tok, langs, L,
                                           box_features=feats,
                                           object_labels=olabels)
    require_decode_attention("caption dev decode, grid + objects", seen4,
                             checked_k4, da.LAUNCHES,
                             2 * ocfg.dec_layers * steps)
    if tkp.LAUNCHES != steps or seen2 - k2_cases or not (lengths == L).all():
        raise AssertionError(f"dev decode, grid + objects: {tkp.LAUNCHES} K2 "
                             f"launches in {steps} steps at {sorted(seen2)}")
    log(f"[caption train] dev decode of {n_img} images, grid + objects, beam "
        f"{beam}: K2 {tkp.LAUNCHES}, K4 {da.LAUNCHES} "
        f"({2 * ocfg.dec_layers} a step)")
    k2, k4 = k2 + tkp.LAUNCHES, k4 + da.LAUNCHES
    del otr, obatches
    torch.cuda.empty_cache()

    # The multimodal image streams (mm_mode "mixed"): train_epoch over four
    # caption batches, each trained by multimodal MASS or the contrastive
    # step as the host draws of its step say; the loss is
    # smoothed_nll_loss, never K5.
    from imagetranslate_tpu_torch.train.trainer_caption import (
        image_batch_draws,
    )

    mtr = CaptionTrainer(cfg, CaptionVocab(), lr=5e-4, warmup=8,
                         mm_mode="mixed", seed=SEED, device=device)
    n_mm = 4
    modes = [image_batch_draws("mixed", mtr.mask_prob, k + 1)[0]
             for k in range(n_mm)]
    E, D = cfg.enc_layers, cfg.dec_layers
    want_mm = sum(E + 4 * D if m == "masked" else 2 * E for m in modes)
    reset()
    with Recorder() as rec, tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        step = mtr.train_epoch(
            0, os.path.join(workdir, "model"),
            ArrayCaptionBatcher(caption_host_batches(cfg, n_mm, SEED + 9)),
            eval_every=10 ** 9, save_every=10 ** 9, log_every=2)
        torch.cuda.synchronize()
        mm_s = time.perf_counter() - t0
    rec.require_checked("caption train mm_mode", checked_k1, checked_xent,
                        want_k5=False)
    if (step != n_mm or ta.FWD_LAUNCHES != want_mm
            or ta.BWD_LAUNCHES != want_mm or xent.FWD_LAUNCHES):
        raise AssertionError(f"mm_mode mixed: {step} steps, K1 "
                             f"{ta.FWD_LAUNCHES} + {ta.BWD_LAUNCHES} (want "
                             f"{want_mm} for {modes}), K5 "
                             f"{xent.FWD_LAUNCHES}")
    log(f"[caption train] mm_mode mixed: train_epoch of {n_mm} caption "
        f"batches as {modes} in {mm_s:.1f} s, K1 {ta.FWD_LAUNCHES} + "
        f"{ta.BWD_LAUNCHES} ({E + 4 * D} a multimodal MASS step, {2 * E} a "
        f"contrastive one), K5 0 ({card})")
    fwd, bwd = fwd + ta.FWD_LAUNCHES, bwd + ta.BWD_LAUNCHES
    del mtr
    torch.cuda.empty_cache()

    reset()
    k1_cli = phase_caption_train_cli(checked_k1, checked_xent)
    return fwd + k1_cli, bwd + k1_cli, k2, k4


def phase_caption_train_cli(checked_k1, checked_xent) -> int:
    """Where Pillow is installed: JPEGs -> cli.binarize_captions_from_list
    -> cli.train_captioning (3 steps at the CLI's defaults) -> cli.caption on
    the checkpoint it wrote. Returns its K1 forward launches."""
    try:
        from PIL import Image
    except ImportError:
        log("[caption train cli] Pillow is not installed on this machine: "
            "cli.binarize_captions_from_list -> cli.train_captioning -> "
            "cli.caption over JPEGs was not run (train_epoch above ran the "
            "same loop on arrays)")
        return 0
    import numpy as np

    from imagetranslate_tpu_torch.cli import binarize_captions_from_list
    from imagetranslate_tpu_torch.cli import caption as caption_cli
    from imagetranslate_tpu_torch.cli import train_captioning
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint

    steps, n_img = 3, 12
    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        folder = os.path.join(workdir, "images")
        os.makedirs(folder)
        lines = []
        for i in range(n_img):
            w, h = 260 + 12 * i, 300 - 6 * i
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            arr = np.stack([127 + 120 * np.sin(xx / (7 + c + i) + yy / (
                11 + 2 * c)) for c in range(3)], axis=-1).astype(np.uint8)
            path = os.path.join(folder, f"{i:03d}.jpg")
            Image.fromarray(arr).save(path)
            for _ in range(2):
                lines.append(path + "\t" + " ".join(
                    WORDS[j] for j in rng.randint(0, len(WORDS),
                                                  rng.randint(3, 10))))
        tsv = os.path.join(workdir, "captions.tsv")
        with open(tsv, "w") as f:
            f.write("\n".join(lines) + "\n")
        tok = os.path.join(workdir, "tok")
        TextProcessor().train_tokenizer([tsv], 300, tok,
                                        {"<en>": 0, "<fa>": 1})
        caps = os.path.join(workdir, "captions.bin")
        binarize_captions_from_list.main(["--file", tsv, "--output", caps,
                                          "--tok", tok, "--lang", "en"])
        model = os.path.join(workdir, "model")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        with Recorder() as rec:
            train_captioning.main([
                "--tok", tok, "--model", model, "--train", caps,
                "--step", str(steps), "--max-image", str(CAPTION_CLI_ROWS),
                "--warmup", "2", "--device", "cuda"])
        rec.require_checked("caption train cli", checked_k1, checked_xent,
                            want_k5=False)
        fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        if not (fwd == bwd == 12 * steps) or xent.FWD_LAUNCHES:
            raise AssertionError(f"cli.train_captioning: {fwd} + {bwd} K1 "
                                 f"launches in {steps} steps (want 12 + 12 "
                                 f"a step), {xent.FWD_LAUNCHES} K5")
        latest = model + ".latest"
        _, opt_tree, meta = load_checkpoint(latest, with_opt_state=True)
        if meta["step"] != steps or opt_tree is None:
            raise AssertionError(f"cli.train_captioning wrote meta {meta}")
        out = os.path.join(workdir, "out.tsv")
        caption_cli.main(["--tok", tok, "--model", latest, "--input", folder,
                          "--output", out, "--target", "en", "--max_len",
                          "16", "--device", "cuda"])
        with open(out) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        if len(rows) != n_img or not all(len(r) == 2 for r in rows):
            raise AssertionError(f"cli.caption wrote {len(rows)} lines for "
                                 f"{n_img} images")
    log(f"[caption train cli] {n_img} JPEGs, {len(lines)} captions -> "
        f"cli.binarize_captions_from_list -> cli.train_captioning (768, 6+6, "
        f"ResNet-18 at 224): {steps} steps, K1 {fwd} + {bwd} -> cli.caption: "
        f"{len(rows)} lines in {time.perf_counter() - t0:.1f} s, e.g. "
        f"{rows[0]!r}")
    return fwd

# ---------------- phase 20: image MT training ----------------

IMAGE_MT_TEXT = (128, 64)      # B, S of the MASS, back-translation, MT batches
IMAGE_MT_CLI_CAPTIONS = 24     # captions of the CLI run: its negatives' count


def image_mt_shapes():
    """(K1 (B, T, S, H, D) list, K5 (N, V) list) of phase 20's steps and its
    CLI run (the CLI's MASS and back-translation shapes are phase 11's):
    multimodal MASS over T=32 captions (its decoder over T/2 span slots,
    against the caption's T and the 49 grid slots) at B=32 and at the CLI's
    8 rows; the contrastive encoder over the captions and the negatives; the
    text MASS, MT and back-translation steps at B=128, S=64."""
    from imagetranslate_tpu_torch.decoding.beam import max_len_for

    B, T = CAPTION_TRAIN
    b, s = IMAGE_MT_TEXT
    w, span = T // 2, s // 2
    L = -(-max_len_for(s, 1.1, 5, 512) // 16) * 16
    k1 = [(IMAGE_MT_CLI_CAPTIONS, T, T)]
    for rows in (B, CAPTION_CLI_ROWS):
        k1 += [(rows, T, T), (rows, w, w), (rows, w, T), (rows, w, 49)]
    k1 += [(b, s, s), (b, span, span), (b, span, s), (b, s - 1, s - 1),
           (b, s - 1, s), (b, L + 1, L + 1), (b, s - 1, L + 1)]
    return [(*x, 12, 64) for x in k1], [(b * span, 32000)]


class ArrayCaptionBatcher(ArrayBatcher):
    """An ``ArrayBatcher`` of caption batches with ``CaptionBatcher``'s
    negatives over their captions."""

    pad_id = 0

    def __init__(self, batches):
        super().__init__(batches)
        self.all_captions = [list(row[:n]) for b in batches
                             for row, n in zip(b.captions, b.lengths)]

    def sample_negatives(self, batch_size: int, seed: int):
        from imagetranslate_tpu_torch.data.images import CaptionBatcher

        return CaptionBatcher.sample_negatives(self, batch_size, seed)


def image_mt_config(vocab_size: int):
    """cli.train_mt's defaults with the image stream: BERT-base text stack
    with 6 + 6 layers, ResNet-18 at 224, dropout 0.1, fp32 masters and bf16
    compute, K1 in every attention; ``use_pallas_xent`` on (K5 in the text
    MASS steps)."""
    import dataclasses

    return dataclasses.replace(bert_base(vocab_size), **{
        "dec_layers": 6, "dropout": RATE, "attention_dropout": RATE,
        "resnet_depth": 1, "img_size": 224, "fused_attn_dropout": True,
        "use_pallas_xent": True})


def phase_image_mt(card, profile: bool, checked_k1, checked_xent, corpus):
    """Phase 20: ImageMTTrainer at cli.train_mt's full width. Returns its K1
    forward, K1 backward, K5 forward, K5 backward and K2 launches."""
    import torch

    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.step import (
        mass_batch_to_device,
        mt_batch_to_device,
    )
    from imagetranslate_tpu_torch.train.trainer_caption import (
        image_batch_draws,
    )
    from imagetranslate_tpu_torch.train.trainer_image_mt import (
        ImageMTTrainer,
    )

    device = torch.device("cuda")
    B, T = CAPTION_TRAIN
    b, s = IMAGE_MT_TEXT
    V = 32000
    cfg = image_mt_config(V)
    E, D = cfg.enc_layers, cfg.dec_layers
    per = {"masked": E + 4 * D, "contrastive": 2 * E, "mass": E + 2 * D,
           "mt": E + 2 * D, "bt": E + 2 * D}
    t0 = time.perf_counter()
    vocab = FullVocab()
    trainer = ImageMTTrainer(cfg, vocab, lr=5e-4, warmup=8, mm_mode="mixed",
                             seed=SEED, bt_beam_width=1, max_len_a=1.1,
                             max_len_b=5, device=device)
    imgs = ArrayCaptionBatcher(caption_host_batches(cfg, 4, SEED + 11))
    mass = mass_batches(cfg, 4, b, s, SEED + 12)
    mts = mt_host_batches(cfg, 4, SEED + 13)
    staged_imgs = [trainer._stage_img(x, "") for x in imgs.batches]
    staged_mass = [mass_batch_to_device(x, device) for x in mass]
    staged_mt = [mt_batch_to_device(x, device) for x in mts]
    trainer._cur_img_batcher = imgs
    log(f"[image mt] ImageMTTrainer BERT-base 6+6 + ResNet-18 at 224, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M "
        f"fp32 master parameters, bf16 compute, dropout {RATE}, "
        f"use_pallas_xent on, built in {time.perf_counter() - t0:.1f} s")

    def mode(host_step):
        """The image mode the trainer draws at this host step."""
        return image_batch_draws("mixed", trainer.mask_prob,
                                 host_step + 1)[0]

    # The first host steps whose timed ticks draw both image modes.
    warm, timed = 3, 6
    n = warm + timed
    start = next(h for h in range(warm + 1, 1000) if {
        mode(h + i) for i in range(timed)} == {"masked", "contrastive"})
    modes = [mode(h) for h in range(start - warm, start + timed)]

    def reset():
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = tkp.LAUNCHES = 0

    def counts():
        return (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
                xent.BWD_LAUNCHES, tkp.LAUNCHES)

    def finite(metrics):
        out = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
        if not all(x == x and abs(x) != float("inf") for x in out):
            raise AssertionError(f"image mt: loss not finite: {out}")
        return out

    # Ticks of img, mass, mt steps in mixed mode; each step timed alone.
    ms = {"masked": [], "contrastive": [], "mass": [], "mt": []}
    metrics = {k: [] for k in ms}
    stats = {k: v.clone() for k, v in trainer.model.named_buffers()}
    stats_mass_ok = True
    reset()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        for i in range(n):
            trainer._host_step = start - warm + i
            for kind in ("img", "mass", "mt"):
                before = ({k: v.clone() for k, v in
                           trainer.model.named_buffers()}
                          if kind == "mass" and i == 0 else None)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if kind == "img":
                    m = trainer._img_step(imgs.batches[i % 4], "", trainer.rng,
                                          images=staged_imgs[i % 4])
                    kind = modes[i]
                elif kind == "mass":
                    trainer.state, m = trainer.mass_step(
                        trainer.state, staged_mass[i % 4], trainer.rng)
                else:
                    trainer.state, m = trainer.mt_step(
                        trainer.state, staged_mt[i % 4], trainer.rng)
                torch.cuda.synchronize()
                if i >= warm:
                    ms[kind].append(1e3 * (time.perf_counter() - t1))
                metrics[kind].append(m)
                if before is not None:
                    stats_mass_ok = all(torch.equal(v, before[k]) for k, v in
                                        trainer.model.named_buffers())
    rec.require_checked("image mt", checked_k1, checked_xent)
    n_img = {k: modes.count(k) for k in ("masked", "contrastive")}
    want_k1 = (per["masked"] * n_img["masked"]
               + per["contrastive"] * n_img["contrastive"]
               + (per["mass"] + per["mt"]) * n)
    want = (want_k1, want_k1, n, n, 0)
    got = counts()
    if got != want:
        raise AssertionError(
            f"image mt: (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2) launches {got} "
            f"in {n} ticks ({n_img} image steps), want {want}")
    if len(metrics["masked"]) != n_img["masked"] or not all(
            n_img[k] >= 1 for k in n_img):
        raise AssertionError(f"image mt: modes {modes}, steps "
                             f"{ {k: len(v) for k, v in metrics.items()} }")
    moved = sum(not torch.equal(v, stats[k])
                for k, v in trainer.model.named_buffers())
    if moved != len(stats) or not stats_mass_ok:
        raise AssertionError(f"image mt: {moved}/{len(stats)} statistics "
                             "moved by the image steps; a text MASS step "
                             f"left them alone: {stats_mass_ok}")
    losses = {k: finite(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = counts()
    for kind, v in ms.items():
        shape = (f"B={B} T={T}" if kind in ("masked", "contrastive")
                 else f"B={b} S={s}" + (" T=64" if kind == "mt" else ""))
        log(f"[image mt] {kind} step {shape}: {len(v)} timed steps, "
            f"{sum(v) / max(len(v), 1):.1f} ms/step (each step synchronised "
            f"alone: {[round(x, 1) for x in v]}), K1 {per[kind]} + "
            f"{per[kind]} a step; losses {[round(x, 4) for x in losses[kind]]}"
            f" ({card})")
    log(f"[image mt] {n} ticks ({warm} warm-up), modes {modes}: K1 "
        f"{total[0]} + {total[1]}, K5 {total[2]} + {total[3]} (the text MASS "
        f"steps), K2 0; {moved}/{len(stats)} BatchNorm statistics moved, "
        f"none by a text MASS step; peak memory {peak:.2f} GiB ({card})")
    if profile:
        def one_tick():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer._host_step = start
            trainer._img_step(imgs.batches[0], "", trainer.rng,
                              images=staged_imgs[0])
            trainer.state, _ = trainer.mass_step(trainer.state,
                                                 staged_mass[0], trainer.rng)
            trainer.state, _ = trainer.mt_step(trainer.state, staged_mt[0],
                                               trainer.rng)
            torch.cuda.synchronize()
            return (time.perf_counter() - t1,
                    f"1 image MT tick ({modes[warm]}, text MASS, MT steps)")
        _profile(one_tick, "image mt", card)

    # The fine-tune phase through train_epoch: the mass stream
    # back-translated (a greedy decode through K2, then an MT step) while
    # image batches keep flowing, then the MT stream; two ticks.
    n_ticks = 2
    trainer.reset_for_finetune()
    dirs = trainer.lang_directions(["aa", "bb"], vocab)
    img_steps = []
    for name in ("mm_mass_step", "contrastive_step"):
        step_fn = getattr(trainer, name)

        def counted(state, batch, rng, _f=step_fn, _n=name):
            img_steps.append(_n)
            return _f(state, batch, rng)
        setattr(trainer, name, counted)
    reset()
    step0 = trainer.state.step
    with Recorder() as rec, counting_decode_steps() as decode_steps, \
            recording_topk() as seen2, tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        step = trainer.train_epoch(
            100, os.path.join(workdir, "model"),
            mt_batcher=ArrayBatcher(mts[:n_ticks]),
            mass_batcher=ArrayBatcher(mass_batches(cfg, n_ticks, b, s,
                                                   SEED + 14)),
            img_batcher=imgs, fine_tune=True, lang_directions=dirs,
            eval_every=10 ** 9, save_every=10 ** 9, log_every=3)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t1
        saved = os.path.exists(os.path.join(workdir, "model.latest",
                                            "opt_state.msgpack"))
    rec.require_checked("image mt fine-tune", checked_k1, checked_xent,
                        want_k5=False)
    want_modes = [mode(100 + 3 * t + 1) for t in range(n_ticks)]
    k2_cases = {(M, k) for M, k, _ in k2_random_cases()}
    got_modes = ["masked" if x == "mm_mass_step" else "contrastive"
                 for x in img_steps]
    ft = counts()
    want_k1 = sum(per[m] for m in want_modes) + n_ticks * (per["bt"]
                                                           + per["mt"])
    want = (want_k1, want_k1, 0, 0, decode_steps[0])
    if (step != 100 + 3 * n_ticks or trainer.state.step != step0 + 3 * n_ticks
            or not saved or got_modes != want_modes or ft != want
            or decode_steps[0] == 0 or seen2 - k2_cases):
        raise AssertionError(
            f"image mt fine-tune: step {step}, modes {got_modes} (want "
            f"{want_modes}), launches {ft} with {decode_steps[0]} decode "
            f"steps, want {want}; .latest saved: {saved}; K2 (M, k) "
            f"{sorted(seen2)}, those phase 3 held: {sorted(k2_cases)}")
    log(f"[image mt] fine-tune train_epoch: {n_ticks} ticks of an image "
        f"step ({got_modes}), a back-translation step (B={b}, greedy decode "
        f"of {decode_steps[0]} steps in all through K2 at (M, k) "
        f"{sorted(seen2)}, then an MT step) and "
        f"an MT step, in {epoch_s:.1f} s: K1 {ft[0]} + {ft[1]}, K5 0, K2 "
        f"{ft[4]}; .latest written ({card})")
    fwd, bwd = total[0] + ft[0], total[1] + ft[1]
    k5 = (total[2], total[3])
    k2 = ft[4]
    del trainer, staged_imgs, staged_mass, staged_mt
    torch.cuda.empty_cache()

    cli = phase_image_mt_cli(corpus, checked_k1, checked_xent)
    return (fwd + cli[0], bwd + cli[1], k5[0] + cli[2], k5[1] + cli[3],
            k2 + cli[4])


def phase_image_mt_cli(corpus, checked_k1, checked_xent):
    """Where Pillow is installed: JPEGs and captions ->
    cli.binarize_captions_from_list; phase 11's monolingual shards;
    cli.train_mt --train --image --mass_train --fstep --langs from a text
    checkpoint (grafted into the text core) -> cli.translate on its
    checkpoint; then mmid_sim over folders of JPEGs. Returns its launches:
    K1 forward, K1 backward, K5 forward, K5 backward, K2."""
    try:
        from PIL import Image
    except ImportError:
        log("[image mt cli] Pillow is not installed on this machine: "
            "cli.train_mt --train -> cli.translate and mmid_sim over JPEGs "
            "were not run (the phase above ran the same trainer on arrays)")
        return 0, 0, 0, 0, 0
    import numpy as np

    from imagetranslate_tpu_torch.cli import binarize_captions_from_list
    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.mmid import mmid_sim
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_variables,
        save_params,
    )
    from imagetranslate_tpu_torch.train.trainer_caption import (
        image_batch_draws,
    )
    from imagetranslate_tpu_torch.train.weights import random_params

    tok, prefix, lines, tp = corpus
    n_step, n_fstep = 2, 2
    rng = np.random.RandomState(SEED + 4)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        folder = os.path.join(workdir, "images")
        os.makedirs(folder)
        rows = []
        for i in range(IMAGE_MT_CLI_CAPTIONS // 2):
            w, h = 250 + 10 * i, 280 - 5 * i
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            arr = np.stack([127 + 120 * np.cos(xx / (6 + c + i) + yy / (
                13 + c)) for c in range(3)], axis=-1).astype(np.uint8)
            path = os.path.join(folder, f"{i:03d}.jpg")
            Image.fromarray(arr).save(path)
            for _ in range(2):
                rows.append(path + "\t" + " ".join(
                    WORDS[j] for j in rng.randint(0, len(WORDS),
                                                  rng.randint(3, 10))))
        tsv = os.path.join(workdir, "captions.tsv")
        with open(tsv, "w") as f:
            f.write("\n".join(rows) + "\n")
        caps = os.path.join(workdir, "captions.bin")
        binarize_captions_from_list.main(["--file", tsv, "--output", caps,
                                          "--tok", tok, "--lang", "en"])
        cfg = image_mt_config(tp.vocab_size())
        init = os.path.join(workdir, "init")
        text = random_params(cfg, SEED + 6)
        save_params(init, cfg, text)
        model = os.path.join(workdir, "model")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = tkp.LAUNCHES = 0
        with Recorder() as rec, counting_decode_steps() as decode_steps:
            train_main(["--tok", tok, "--model", model, "--pretrained", init,
                        "--train", caps, "--image", "", "--max-image",
                        str(CAPTION_CLI_ROWS), "--mass_train", prefix,
                        "--batch", str(UMT_CLI_BATCH), "--step", str(n_step),
                        "--fstep", str(n_fstep), "--langs", "en,fa",
                        "--lr", "0.001", "--warmup", "10", "--device",
                        "cuda"])
        rec.require_checked("image mt cli", checked_k1, checked_xent)
        got = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
               xent.BWD_LAUNCHES, tkp.LAUNCHES)
        E, D = cfg.enc_layers, cfg.dec_layers
        per = {"masked": E + 4 * D, "contrastive": 2 * E}
        # Ticks of an image step (host step k + 1 draws with key k + 2) and
        # a MASS step; in the fine-tune phase a back-translation step.
        modes = [image_batch_draws("mixed", 0.5, k + 2)[0] for k in (0, 2)]
        k1 = sum(per[m] for m in modes) + 2 * (E + 2 * D)
        want = (k1, k1, 1, 1, decode_steps[0])
        if got != want or decode_steps[0] == 0:
            raise AssertionError(
                f"image mt cli: (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2) "
                f"launches {got}, want {want} (image steps {modes}, one "
                "MASS and one back-translation step)")
        latest = model + ".latest"
        _, opt_tree, meta = load_checkpoint(latest, with_opt_state=True)
        saved = load_variables(latest)
        if (meta["step"] != n_step + n_fstep or opt_tree is None
                or "image_model" not in saved["params"]
                or "batch_stats" not in saved):
            raise AssertionError(f"image mt cli checkpoint: meta {meta}, "
                                 f"{sorted(saved)}")
        inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
        with open(inp, "w") as f:
            f.write("\n".join(lines[:20]) + "\n")
        tkp.LAUNCHES = 0
        translate_main(["--tok", tok, "--model", latest, "--input", inp,
                        "--output", out, "--src", "en", "--target", "fa",
                        "--device", "cuda"])
        with open(out) as f:
            hyps = f.read().splitlines()
        if len(hyps) != 20 or tkp.LAUNCHES == 0:
            raise AssertionError(f"translate wrote {len(hyps)} lines with "
                                 f"{tkp.LAUNCHES} K2 launches")
        cli_s = time.perf_counter() - t0
        log(f"[image mt cli] {len(rows)} captions of "
            f"{IMAGE_MT_CLI_CAPTIONS // 2} JPEGs + 2 x {len(lines)} "
            f"monolingual lines -> cli.train_mt --train --mass_train "
            f"--pretrained (a text checkpoint grafted into the core; 768, "
            f"6+6, ResNet-18 at 224): image steps {modes}, 1 MASS and 1 "
            f"back-translation step, K1 {got[0]} + {got[1]}, K5 {got[2]} + "
            f"{got[3]}, K2 {got[4]} -> cli.translate: 20 lines with "
            f"{tkp.LAUNCHES} K2 launches, in {cli_s:.1f} s, e.g. {hyps[0]!r}")

        # mmid_sim: two foreign word folders against an English letter
        # folder of two word folders.
        t1 = time.perf_counter()
        names = {"foreign": ("gato", "perro"), "en/c": ("cat", "dog")}
        for root, words in names.items():
            for k, word in enumerate(words):
                d = os.path.join(workdir, "mmid", root, word)
                os.makedirs(d)
                for j in range(3):
                    arr = rng.randint(0, 256, (180 + 20 * j, 240, 3)).astype(
                        np.uint8)
                    Image.fromarray(arr).save(os.path.join(d, f"{j}.jpg"))
        sims = os.path.join(workdir, "sims.tsv")
        mmid_sim.main(["--foreign", os.path.join(workdir, "mmid", "foreign"),
                       "--en", os.path.join(workdir, "mmid", "en"),
                       "--output", sims, "--device", "cuda"])
        with open(sims) as f:
            pairs = [ln.split("\t") for ln in f.read().splitlines()]
        if len(pairs) != 4 or not all(-1.0 <= float(p[2]) <= 1.0
                                      for p in pairs):
            raise AssertionError(f"mmid_sim wrote {pairs}")
        log(f"[image mt cli] mmid_sim over 2 foreign and 2 English folders "
            f"of 3 JPEGs (ResNet-18 at 224, 512 wide): {len(pairs)} pairs, "
            f"avg-max cosines {[round(float(p[2]), 4) for p in pairs]}, in "
            f"{time.perf_counter() - t1:.1f} s")
    return got


SENSIM_STEP = (128, 64, 128)       # pairs a batch, tokens a row, pool rows
C2I_STEP = (32, 32)                # captions (--max-image), caption tokens
TRANSLATE_IMG = (64, 64, 4)        # rows, source tokens, beam of phase 21
M11_CLI = dict(batch=2000, max_image=8, lines=8)   # the CLIs' small runs
M11_CLI_WIDTH = []                 # extra width flags of the training CLIs
MOE = dict(moe_experts=8, moe_top_k=2)   # the JAX defaults for the rest
MOE_STEP = (256, 64, 64)           # B, S, T: phase 7's shape


def module11_decode_rows():
    """{beam rows R: decode length L} of phase 21's decodes: its own at
    B=64, and the CLI's one batch of 8 lines (each line fits the first
    bucket, 32 tokens). translate_img sizes all three rounds of a batch by
    its source width."""
    from imagetranslate_tpu_torch.decoding.beam import max_len_for

    B, S, K = TRANSLATE_IMG
    return {B * K: max_len_for(S, 1.3, 5, 512),
            M11_CLI["lines"] * K: max_len_for(32, 1.3, 5, 512)}


def prepare_module11_corpus(workdir, corpus):
    """Phase 21's CLI inputs from phase 11's corpus: parallel .mt files
    (train and dev), JPEGs with a caption binary (where Pillow is
    installed), the lines to translate, and a full-width captioner
    checkpoint (decode_attention_impl="fused"). Returns a dict of paths,
    with "caps" None without Pillow."""
    import dataclasses

    import numpy as np

    from imagetranslate_tpu_torch.data.binarize import write_mt
    from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
    from imagetranslate_tpu_torch.train.weights import CAPTION

    tok, _, lines, tp = corpus
    d = os.path.join(workdir, "m11")
    os.makedirs(d)
    out = {"tok": tok, "neg": (corpus[1] + "en", corpus[1] + "fa")}
    for name, rows in (("train", lines[:64]), ("dev", lines[64:80])):
        for lang, text in (("en", rows),
                           ("fa", [" ".join(reversed(r.split()))
                                   for r in rows])):
            with open(os.path.join(d, f"{name}.{lang}"), "w") as f:
                f.write("\n".join(text) + "\n")
        out[name] = os.path.join(d, f"{name}.mt")
        write_mt(tp, out[name], os.path.join(d, f"{name}.en"),
                 tp.token_id("<en>"), os.path.join(d, f"{name}.fa"),
                 tp.token_id("<fa>"))
    out["input"] = os.path.join(d, "input.en")
    with open(out["input"], "w") as f:
        f.write("\n".join(lines[80:80 + M11_CLI["lines"]]) + "\n")
    cfg = dataclasses.replace(caption_config(tp.vocab_size()), use_obj=False)
    out["captioner"] = os.path.join(d, "captioner")
    save_checkpoint(out["captioner"], cfg, CAPTION.random_params(cfg, SEED))
    out["caps"] = None
    try:
        from PIL import Image
    except ImportError:
        return out
    from imagetranslate_tpu_torch.data.binarize_captions import (
        write_from_list,
    )

    out["images"] = os.path.join(d, "images")
    os.makedirs(out["images"])
    rng = np.random.RandomState(SEED + 21)
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (240, 256 + 16 * i, 3)).astype(
            np.uint8)).save(os.path.join(out["images"], f"{i}.jpg"))
    with open(os.path.join(d, "caps.tsv"), "w") as f:
        f.write("\n".join(f"{i % 4}.jpg\t{lines[100 + i]}"
                          for i in range(16)) + "\n")
    out["caps"] = os.path.join(d, "caps.bin")
    write_from_list(tp, out["caps"], os.path.join(d, "caps.tsv"), lang="en")
    return out


def module11_shapes(m11):
    """The (B, T, S, H, D) that phase 21's steps and CLI runs give K1: the
    SenSim step's encodes of pairs and pools, the Caption2Image step's
    encode, and every batch shape the two training CLIs' batchers build
    from their flags (the port's own batch arithmetic)."""
    from imagetranslate_tpu_torch.data.binarize import load_mass, load_mt
    from imagetranslate_tpu_torch.data.images import CaptionBatcher
    from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    B, S, P = SENSIM_STEP
    widths = {(B, S), (P, S), C2I_STEP}
    batch = M11_CLI["batch"]
    for b in MTBatcher(load_mt(m11["train"]), pad_id=0,
                       max_batch=batch // 2, capacity_mb=300):
        widths |= {b.src.shape, b.dst.shape}
    for prefix in m11["neg"]:
        widths |= {b.src.shape for b in MassBatcher(
            load_mass(prefix), pad_id=0, max_batch=batch * 5,
            capacity_mb=3000, max_seq_len=175)}
    if m11["caps"] is not None:
        widths |= {b.captions.shape for b in CaptionBatcher(
            m11["caps"], TextProcessor(m11["tok"]),
            max_img_per_batch=M11_CLI["max_image"])}
    return [(rows, t, t, 12, 64) for rows, t in sorted(widths)]


def sensim_config(vocab_size: int):
    """cli.train_sensim's defaults: 768/12/3072, 6 layers, dropout 0.1,
    bf16 compute (the trainer holds fp32 masters); cli.train_txt2image's
    are the same."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    return Seq2SeqConfig(vocab_size=vocab_size, num_languages=2,
                         dropout=RATE, attention_dropout=RATE)


def phase_module11(card, checked_k1, checked_xent, checked_k4, m11):
    """Phase 21: SenSim and Caption2Image steps at their CLIs' defaults,
    translate_img's three decode rounds at B=64, and the four CLIs. Returns
    its (K1 fwd, K1 bwd, K2, K4) launches."""
    import dataclasses

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import translate_img as ti
    from imagetranslate_tpu_torch.data.loader import MassBatch, MTBatch
    from imagetranslate_tpu_torch.models.caption2image import Caption2Image
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.train.trainer_sensim import SenSimTrainer
    from imagetranslate_tpu_torch.train.trainer_txt2image import (
        Caption2ImageTrainer,
    )
    from imagetranslate_tpu_torch.train.weights import (
        CAPTION,
        CAPTION2IMAGE,
    )

    device = torch.device("cuda")
    V = 32000
    cfg = sensim_config(V)
    layers = cfg.enc_layers
    rng = np.random.RandomState(SEED + 20)
    total = [0, 0, 0, 0]

    def ids(shape):
        return (5 + (V - 5) * rng.rand(*shape) ** 3).astype(np.int32)

    def finite(values, what):
        if not all(x == x and abs(x) != float("inf") for x in values):
            raise AssertionError(f"{what}: loss not finite: {values}")

    def timed_steps(trainer, batches, warm, timed, what):
        """warm + timed steps; returns (ms/step of the timed ones, losses,
        K1 launches)."""
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        metrics = []
        with Recorder() as rec:
            for i in range(warm):
                trainer.state, m = trainer.step_fn(
                    trainer.state, batches[i % len(batches)], trainer.rng)
                metrics.append(m)
        rec.require_checked(what, checked_k1, checked_xent, want_k5=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed):
            trainer.state, m = trainer.step_fn(
                trainer.state, batches[(warm + i) % len(batches)],
                trainer.rng)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / timed
        losses = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
        finite(losses, what)
        return ms, losses, (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES)

    # SenSim steps: B=128 pairs at S=64 with negative pools of 128 rows.
    B, S, P = SENSIM_STEP
    t0 = time.perf_counter()
    sensim = SenSimTrainer(cfg, FullVocab(), lr=5e-4, warmup=8, seed=SEED,
                           device=device)
    ones = np.ones((B,), np.int32)
    batches = []
    for _ in range(3):
        src = ids((B, S))
        pair = MTBatch(src, src != 0, src.copy(), src != 0, 0 * ones, ones,
                       S * ones, ones.astype(bool))
        pools = [MassBatch(x, x != 0, np.full(P, lang, np.int32), x[:, 0],
                           np.full(P, S, np.int32), np.ones(P, bool))
                 for lang, x in ((0, ids((P, S))), (1, ids((P, S))))]
        batches.append(sensim.stage(pair, *pools))
    build_s = time.perf_counter() - t0
    warm, timed = 3, 6
    ms, losses, k1 = timed_steps(sensim, batches, warm, timed, "sensim")
    per = 4 * layers
    if k1 != (per * (warm + timed),) * 2:
        raise AssertionError(f"sensim: K1 launches {k1}, want {per} + {per} "
                             "a step")
    total[0] += k1[0]
    total[1] += k1[1]
    log(f"[sensim] SenSimTrainer at cli.train_sensim's defaults "
        f"({cfg.hidden_size}/{cfg.num_heads}/{cfg.intermediate_size}, "
        f"{layers} layers, V={V}, fp32 masters, bf16 compute, dropout "
        f"{cfg.dropout}; "
        f"built in {build_s:.1f} s): B={B} pairs at S={S} with negative "
        f"pools of {P}, {timed} timed steps at {ms:.1f} ms/step "
        f"({B / ms * 1e3:.0f} pairs/s), K1 {per} + {per} a step (4 encodes); "
        f"losses {[round(x, 4) for x in losses]} ({card})")
    del sensim, batches
    torch.cuda.empty_cache()

    # Caption2Image steps: B=32 captions of T=32 against the grid of a
    # frozen ResNet-18 captioner at 224, the target encode timed apart.
    n, T = C2I_STEP
    cap_cfg = dataclasses.replace(caption_config(V), use_obj=False)
    captioner = ImageSeq2Seq(cap_cfg, device=device)
    captioner.load_state_dict(CAPTION.state_dict_from_flax(
        CAPTION.random_params(cap_cfg, SEED), cap_cfg))
    c2i = Caption2ImageTrainer(cfg, FullVocab(), captioner, lr=5e-4,
                               warmup=8, seed=SEED, device=device)
    host = caption_host_batches(cap_cfg, 3, SEED + 22)
    c2i._batch(host[0], "")                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [c2i._batch(b, "") for b in host]
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0) / len(host)
    grid = batches[0]["target_grid"]
    if grid.shape != (n, 49, cfg.hidden_size) or grid.requires_grad:
        raise AssertionError(f"c2i target grid {tuple(grid.shape)}, "
                             f"requires_grad {grid.requires_grad}")
    ms, losses, k1 = timed_steps(c2i, batches, warm, timed, "caption2image")
    if k1 != (layers * (warm + timed),) * 2:
        raise AssertionError(f"caption2image: K1 launches {k1}, want "
                             f"{layers} + {layers} a step")
    total[0] += k1[0]
    total[1] += k1[1]
    log(f"[caption2image] Caption2ImageTrainer at cli.train_txt2image's "
        f"defaults against a frozen BERT-base captioner with ResNet-18 at "
        f"224 (bf16): B={n} captions of T={T}, target grid (staging and "
        f"encode_images) {encode_ms:.1f} ms a batch, {timed} timed steps at "
        f"{ms:.1f} ms/step, K1 {layers} + {layers} a step; losses "
        f"{[round(x, 2) for x in losses]} ({card})")
    del c2i, batches

    # translate_img's three rounds at B=64, beam 4, through a "fused"
    # captioner: every row runs to its limit (EOS outside the vocabulary).
    B, S, K = TRANSLATE_IMG
    c2i_model = Caption2Image(cfg, device=device)
    c2i_model.load_state_dict(CAPTION2IMAGE.state_dict_from_flax(
        CAPTION2IMAGE.random_params(cfg, SEED), cfg))
    c2i_model.eval()
    captioner.eval()
    src = ids((B, S))
    src[:, 0] = 5
    ones = np.ones((B,), np.int32)
    b = MTBatch(src, src != 0, np.full((B, 1), 6, np.int32),
                np.ones((B, 1), bool), 0 * ones, ones, S * ones,
                ones.astype(bool))
    opts = ti.get_parser().parse_args(
        ["--input", "-", "--src", "en", "--target", "fa", "--output", "-",
         "--tok", "-", "--model", "-", "--caption-model", "-"])
    ti.translate_rounds(c2i_model, captioner, b, opts, 0, -1)    # warm-up
    da.LAUNCHES = tkp.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_decode_attention() as seen4, recording_topk() as seen2:
        rounds = ti.translate_rounds(c2i_model, captioner, b, opts, 0, -1)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    L = module11_decode_rows()[B * K]
    steps = 3 * (L - 1)
    k2_cases = {(M, k) for M, k, _ in k2_random_cases()}
    require_decode_attention("translate_img", seen4, checked_k4, da.LAUNCHES,
                             cap_cfg.dec_layers * steps)
    if (tkp.LAUNCHES != steps or seen2 - k2_cases
            or {len(row) for r in rounds for row in r} != {L}):
        raise AssertionError(
            f"translate_img: K2 {tkp.LAUNCHES} launches in {steps} steps at "
            f"{sorted(seen2)}; output lengths "
            f"{sorted({len(row) for r in rounds for row in r})}, want {L}")
    total[2] += tkp.LAUNCHES
    total[3] += da.LAUNCHES
    log(f"[translate_img] Caption2Image -> grid -> beam search of a fused "
        f"BERT-base captioner (bf16), B={B} S={S} beam {K}, three rounds of "
        f"L={L}: {steps} steps, K2 {tkp.LAUNCHES} at (M, k) "
        f"{sorted(seen2)}, K4 {da.LAUNCHES} ({cap_cfg.dec_layers} a step), "
        f"{secs:.2f} s = {B / secs:.1f} sentences/s for the three rounds "
        f"({card})")
    del c2i_model, captioner
    torch.cuda.empty_cache()

    cli = phase_module11_cli(checked_k1, checked_xent, checked_k4, m11)
    return tuple(a + b for a, b in zip(total, cli))


def phase_module11_cli(checked_k1, checked_xent, checked_k4, m11):
    """cli.train_sensim -> cli.get_sen_sim, and (where Pillow is installed)
    cli.train_txt2image from a captioner checkpoint -> cli.translate_img
    with that captioner ("fused") on 8 lines. Returns (K1 fwd, K1 bwd, K2,
    K4) launches."""
    import torch

    from imagetranslate_tpu_torch.cli import (
        get_sen_sim,
        train_sensim,
        train_txt2image,
        translate_img,
    )
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_config,
    )

    d = os.path.dirname(m11["train"])
    tok = ["--tok", m11["tok"]]
    out = [0, 0, 0, 0]
    t0 = time.perf_counter()
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    model = os.path.join(d, "sensim")
    with Recorder() as rec:
        train_sensim.main(tok + [
            "--model", model, "--train_mt", m11["train"], "--dev_mt",
            m11["dev"], "--src-neg", m11["neg"][0], "--dst-neg",
            m11["neg"][1], "--step", "2", "--batch", str(M11_CLI["batch"]),
            "--warmup", "2", "--device", "cuda", *M11_CLI_WIDTH])
    rec.require_checked("train_sensim cli", checked_k1, checked_xent,
                        want_k5=False)
    per = 4 * load_config(model + ".latest").enc_layers
    if (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES) != (2 * per, 2 * per):
        raise AssertionError(f"train_sensim cli: K1 {ta.FWD_LAUNCHES} + "
                             f"{ta.BWD_LAUNCHES}, want {2 * per} each")
    out[0] += ta.FWD_LAUNCHES
    out[1] += ta.BWD_LAUNCHES
    if load_checkpoint(model + ".latest")[2]["step"] != 2:
        raise AssertionError("train_sensim cli: .latest is not at step 2")
    sims = os.path.join(d, "sims.tsv")
    get_sen_sim.main(tok + ["--model", model, "--dev_mt", m11["dev"],
                            "--output", sims, "--device", "cuda"])
    with open(sims) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    if len(rows) != 16 or not all(len(r) == 3 and -1.001 <= float(r[2])
                                  <= 1.001 for r in rows):
        raise AssertionError(f"get_sen_sim wrote {len(rows)} rows: "
                             f"{rows[:2]}")
    log(f"[module 11 cli] cli.train_sensim (2 steps, "
        f"{load_config(model).hidden_size} wide, pools from the MASS shards, "
        f"a dev set) -> cli.get_sen_sim: {len(rows)} pairs, "
        f"e.g. {rows[0]}, K1 {out[0]} + {out[1]}, in "
        f"{time.perf_counter() - t0:.1f} s")
    if m11["caps"] is None:
        log("[module 11 cli] Pillow is not installed on this machine: "
            "cli.train_txt2image and cli.translate_img are not run")
        return out
    t0 = time.perf_counter()
    c2i = os.path.join(d, "c2i")
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    with Recorder() as rec:
        train_txt2image.main(tok + [
            "--model", c2i, "--pretrained", m11["captioner"], "--train",
            m11["caps"], "--image", m11["images"], "--step", "2",
            "--max-image", str(M11_CLI["max_image"]), "--warmup", "2",
            "--device", "cuda", *M11_CLI_WIDTH])
    rec.require_checked("train_txt2image cli", checked_k1, checked_xent,
                        want_k5=False)
    per = 2 * load_config(c2i + ".latest").enc_layers
    if (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES) != (per, per):
        raise AssertionError(f"train_txt2image cli: K1 {ta.FWD_LAUNCHES} + "
                             f"{ta.BWD_LAUNCHES}, want {per} each")
    out[0] += ta.FWD_LAUNCHES
    out[1] += ta.BWD_LAUNCHES
    da.LAUNCHES = tkp.LAUNCHES = 0
    result = os.path.join(d, "translated.txt")
    with recording_decode_attention() as seen4, recording_topk() as seen2:
        translate_img.main(tok + [
            "--model", c2i + ".latest", "--caption-model", m11["captioner"],
            "--input", m11["input"], "--output", result, "--src", "en",
            "--target", "fa", "--verbose", "--device", "cuda"])
    torch.cuda.synchronize()
    with open(result) as f:
        lines = f.read().splitlines()
    k2_cases = {(M, k) for M, k, _ in k2_random_cases()}
    require_decode_attention(
        "translate_img cli", seen4, checked_k4, da.LAUNCHES,
        load_config(m11["captioner"]).dec_layers * tkp.LAUNCHES)
    if (len(lines) != M11_CLI["lines"] or tkp.LAUNCHES == 0
            or seen2 - k2_cases
            or not all(ln.count(" ||| ") == 3 for ln in lines)):
        raise AssertionError(f"translate_img cli: {len(lines)} lines, K2 "
                             f"{tkp.LAUNCHES} at {sorted(seen2)}")
    out[2] += tkp.LAUNCHES
    out[3] += da.LAUNCHES
    log(f"[module 11 cli] cli.train_txt2image (2 steps from a BERT-base "
        f"captioner checkpoint, 16 captions of 4 JPEGs) -> "
        f"cli.translate_img (fused captioner, beam 4) on {len(lines)} lines:"
        f" K1 {per} + {per}, K2 {tkp.LAUNCHES} at {sorted(seen2)}, K4 "
        f"{da.LAUNCHES}, in {time.perf_counter() - t0:.1f} s, e.g. "
        f"{lines[0][:120]!r}")
    return out


def phase_moe(card, checked_k1, checked_xent, checked_k4):
    """Phase 22: MTTrainer steps with an MoE FFN (8 experts, top-2) at phase
    7's shape with the fused cross-entropy, paired with the dense step, the
    routing checked on one forward; then phase 4's beam decode on the MoE
    model through K2 and K4. Returns (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2,
    K4) launches."""
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.models import moe
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    dense_cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                                    attention_dropout=RATE,
                                    use_pallas_xent=True)
    cfg = dataclasses.replace(dense_cfg, **MOE)
    B, S, T = MOE_STEP
    t0 = time.perf_counter()
    arms = {name: (MTTrainer(c, FullVocab(), lr=5e-4, warmup=8, seed=SEED,
                             device=device), [])
            for name, c in (("dense", dense_cfg), ("moe", cfg))}
    trainer = arms["moe"][0]
    build_s = time.perf_counter() - t0
    n_params = {k: sum(p.numel() for p in tr.model.parameters()) / 1e6
                for k, (tr, _) in arms.items()}
    batches = train_batches(cfg, 4, B, S, T, device)

    def steps(n, tr, into):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            tr.state, m = tr.mt_step(tr.state, batches[len(into) % 4], tr.rng)
            into.append(m)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
    with Recorder() as rec:
        for name in arms:
            steps(2, *arms[name])                       # warm-up
    rec.require_checked("moe train", checked_k1, checked_xent)
    block, ms = 3, {"dense": [], "moe": []}
    for name in ("dense", "moe", "moe", "dense"):
        ms[name].append(1e3 * steps(block, *arms[name]) / block)
    n_steps = sum(len(v) for _, v in arms.values())
    per = cfg.enc_layers + 2 * cfg.dec_layers
    got = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
           xent.BWD_LAUNCHES)
    if got != (per * n_steps, per * n_steps, n_steps, n_steps):
        raise AssertionError(f"moe train: (K1 fwd, K1 bwd, K5 fwd, K5 bwd) "
                             f"{got} in {n_steps} steps, want {per} + {per} "
                             "and 1 + 1 a step")
    losses = {k: [(m["sum_loss"] / m["ntokens"]).item() for m in v]
              for k, (_, v) in arms.items()}
    for k, v in losses.items():
        if not all(x == x and abs(x) != float("inf") for x in v):
            raise AssertionError(f"moe train: {k} loss not finite: {v}")
    tokens = float(arms["moe"][1][-1]["ntokens"])
    tps = {k: tokens / (sum(v) / len(v) / 1e3) for k, v in ms.items()}

    # The routing of one training-mode forward: every bank's aux loss
    # finite and positive, its first-choice fractions summing to 1, and the
    # share of choices past their expert's capacity.
    inputs = []
    hooks = [b.register_forward_pre_hook(lambda mod, a: inputs.append(
        (mod, a[0].detach()))) for b in trainer.model.modules()
        if isinstance(b, moe.MoEFeedForward)]
    batch = batches[0]
    with torch.no_grad(), moe.collect_aux(trainer.model) as sink:
        trainer.model(batch["src"], batch["src_mask"], batch["dst"],
                      batch["dst_mask"], batch["src_langs"],
                      batch["dst_langs"], deterministic=False,
                      rng=trainer.rng)
    for h in hooks:
        h.remove()
    aux = torch.stack(sink).float()
    fractions, dropped = [], []
    with torch.no_grad():
        for bank, x in inputs:
            tok = x.reshape(-1, x.shape[-1])
            g = moe._group_size(tok.shape[0], cfg.moe_group_size)
            _, _, _, slots, first = bank.route(
                tok.reshape(-1, g, tok.shape[-1]))
            fractions.append(first.mean(dim=(0, 1)))
            C = moe._capacity(g, cfg)
            dropped.append(sum(float((s >= C).float().mean()) for s in slots)
                           / len(slots))
    sums = torch.stack(fractions).sum(dim=1)
    if (len(sink) != cfg.enc_layers + cfg.dec_layers
            or not torch.isfinite(aux).all()
            or not (aux > 0).all()
            or (sums - 1).abs().max() > 1e-5):
        raise AssertionError(f"moe routing: {len(sink)} aux values {aux}, "
                             f"first-choice fractions sum to {sums}")
    log(f"[moe] MTTrainer {cfg.hidden_size} wide, {cfg.enc_layers}+"
        f"{cfg.dec_layers} layers, with an MoE FFN of "
        f"{cfg.moe_experts} experts, top-{cfg.moe_top_k}, capacity "
        f"{cfg.moe_capacity_factor}, groups of {cfg.moe_group_size}, aux "
        f"weight {cfg.moe_aux_weight} ({n_params['moe']:.1f} M fp32 master "
        f"parameters against {n_params['dense']:.1f} M dense; both built in "
        f"{build_s:.1f} s), B={B} S=T={S}, use_pallas_xent on, blocks of {block} steps in "
        f"the order dense, moe, moe, dense: moe "
        f"{[round(x, 1) for x in ms['moe']]} ms/step = {tps['moe']:.0f} tok/s, dense "
        f"{[round(x, 1) for x in ms['dense']]} ms/step = {tps['dense']:.0f} "
        f"tok/s; K1 {got[0]} + {got[1]}, K5 {got[2]} + {got[3]} over both "
        f"arms; aux losses of the {len(sink)} banks "
        f"{[round(x, 4) for x in aux.tolist()]}, first-choice fractions "
        f"sum to 1 within {float((sums - 1).abs().max()):.1e}, choices past "
        f"capacity {[round(x, 4) for x in dropped]}; moe losses "
        f"{[round(x, 3) for x in losses['moe']]} ({card})")
    state = trainer.model.state_dict()
    del arms, trainer, batches, inputs
    torch.cuda.empty_cache()

    # Phase 4's beam decode (B=64, S=64, beam 4, L=88) on the MoE model,
    # bf16, the self-attention of every step through K4.
    serve = Seq2Seq(dataclasses.replace(cfg, dropout=0.0,
                                        attention_dropout=0.0,
                                        decode_attention_impl="fused"),
                    device=device)
    serve.load_state_dict(state)
    serve.eval()
    Bd, Sd, K, L = MT_DECODE
    run_decode(serve, Bd, Sd, K, device)                # warm-up
    da.LAUNCHES = tkp.LAUNCHES = 0
    with recording_decode_attention() as seen4:
        _, lengths, dsteps, secs = run_decode(serve, Bd, Sd, K, device)
    require_decode_attention("moe decode", seen4, checked_k4, da.LAUNCHES,
                             cfg.dec_layers * dsteps)
    if tkp.LAUNCHES != dsteps:
        raise AssertionError(f"moe decode: K2 {tkp.LAUNCHES} launches in "
                             f"{dsteps} steps")
    dec_tokens = int(lengths.sum())
    log(f"[moe] beam decode on the MoE model (bf16, fused): B={Bd} S={Sd} "
        f"beam {K} L={L}, {dsteps} steps (each routes the B*K={Bd * K} step "
        f"tokens as one group), K2 {tkp.LAUNCHES}, K4 {da.LAUNCHES}: "
        f"{dec_tokens} tokens in {secs:.3f} s = {dec_tokens / secs:.1f} tok/s "
        f"({card})")
    out = (got[0], got[1], got[2], got[3], tkp.LAUNCHES, da.LAUNCHES)
    del serve, state
    torch.cuda.empty_cache()
    return out


# ---------------- phase 23: the detector ----------------

DET_B = 8                 # images a detector batch (build_object_extractor's)
DET_SIZE = 800            # the detector's input side
DET_TIMED = 5             # timed forwards of the batch
DET_JPEGS = 20            # cli.extract_objects' folder: 8 + 8 + a tail of 4
DET_CAPTION_JPEGS = 200   # cli.caption --obj at its default --batch 192
DET_CAPTION_L = 32        # that run's --max_len
# Card against CPU, fp32 (tests/test_detector_e2e.py's tolerances):
DET_TOL = {"scores": (2e-3, 1e-4), "boxes": (2e-3, 5e-2),
           "features": (1e-2, 1e-2)}


def detector_images(n: int, seed=SEED):
    """n smooth uint8 pictures at 800 x 800, each with a constant band (the
    padding a letterbox leaves) and a bright square."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:DET_SIZE, 0:DET_SIZE].astype(np.float32)
    out = np.empty((n, DET_SIZE, DET_SIZE, 3), np.uint8)
    for i in range(n):
        f = rng.uniform(20, 90, 6)
        out[i] = np.stack([127 + 110 * np.sin(xx / f[c] + yy / f[c + 3])
                           for c in range(3)], -1).astype(np.uint8)
        out[i, :rng.randint(40, 160)] = 114
        y, x, s = rng.randint(100, 600, 3)
        out[i, y:y + s // 3, x:x + s // 3] = 250
    return out


def write_jpegs(folder: str, n: int, seed=SEED):
    """n JPEG files of several sizes under ``folder`` (Pillow)."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i in range(n):
        w, h = int(rng.randint(320, 960)), int(rng.randint(320, 960))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = rng.uniform(15, 80, 6)
        arr = np.stack([127 + 120 * np.sin(xx / f[c] + yy / f[c + 3])
                        for c in range(3)], -1).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"{i:04d}.jpg"),
                                  quality=85)


def detector_flops(model, images) -> float:
    """The operations of one forward on ``images``: 2 x multiply-adds of
    every convolution and linear layer, counted from the shapes this run
    gave them (RoIAlign, NMS and the elementwise work are left out)."""
    import torch
    from torch import nn

    total = [0.0]

    def conv(m, args, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        total[0] += 2.0 * out.numel() * k

    def linear(m, args, out):
        total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_detector(card, profile: bool, checked_k4, corpus):
    """Phase 23: the Faster R-CNN at full width (ResNet-50 FPN, 800 pixels,
    the JAX defaults, fp32) from a random torchvision state_dict saved as
    .pth: ms a batch, images/s, its operation bound, peak memory, the NMS
    loop's launches; one image against the same module on the CPU; then
    cli.extract_objects over a folder of JPEGs read back through
    ObjectStore, and cli.caption --obj --fcnn over 200 JPEGs. Returns its
    (K2, K4) launches."""
    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import caption as ccli
    from imagetranslate_tpu_torch.cli import extract_objects
    from imagetranslate_tpu_torch.data.images import ObjectStore
    from imagetranslate_tpu_torch.models.detector import FasterRCNN
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import detection as dops
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
    from imagetranslate_tpu_torch.train.weights import (
        CAPTION,
        load_torchvision_frcnn,
        random_frcnn_state_dict,
    )

    device = torch.device("cuda")
    workdir = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        pth = os.path.join(workdir, "frcnn.pth")
        torch.save(random_frcnn_state_dict(SEED), pth)
        sd = load_torchvision_frcnn(torch.load(pth, map_location="cpu"))
        model = FasterRCNN(device=device)
        model.load_state_dict(sd)
        model.eval()
        images_np = detector_images(DET_B)
        images = torch.as_tensor(images_np).to(device)
        log(f"[detector] FasterRCNN ResNet-50 FPN, fp32, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
            f"parameters from a random torchvision state_dict (numpy seed "
            f"{SEED}, BatchNorm calibrated) through a .pth, built in "
            f"{time.perf_counter() - t0:.1f} s")

        flops = detector_flops(model, images)

        def forward():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                det = model(images)
            torch.cuda.synchronize()
            return det, time.perf_counter() - t

        forward()                                         # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(DET_TIMED):
            det, wall = forward()
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = 1e3 * sum(walls) / len(walls)
        bound_ms = 1e3 * flops / FP32_FLOPS_PER_S
        n_valid = det.valid.sum(1).tolist()
        if not all(torch.isfinite(t).all() for t in det) or min(n_valid) < 1:
            raise AssertionError(f"detections not finite, or an image with "
                                 f"none: valid per image {n_valid}")
        log(f"[detector] B={DET_B} at {DET_SIZE} (uint8, normalised on the "
            f"card), {DET_TIMED} timed forwards: {ms:.1f} ms a batch "
            f"(spread {1e3 * min(walls):.1f}-{1e3 * max(walls):.1f}), "
            f"{DET_B / (ms / 1e3):.1f} images/s; {flops / 1e9 / DET_B:.1f} "
            f"GFLOP an image in convolutions and linear layers, bound "
            f"{bound_ms:.2f} ms a batch at 67 TFLOP/s fp32 ({bound_ms / ms:.3f}"
            f" of it); peak memory {peak:.2f} GiB; valid detections per image "
            f"{n_valid} ({card})")

        # Where a batch's time goes, by stage (host clock around a sync).
        from imagetranslate_tpu_torch.data.images import normalize_uint8

        stages = {}
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            x = normalize_uint8(images).permute(0, 3, 1, 2)
            pyramid = model.backbone["fpn"](model.backbone["body"](x))
            torch.cuda.synchronize()
            stages["backbone + FPN"] = time.perf_counter() - t
            t = time.perf_counter()
            rpn = model.rpn["head"](pyramid)
            torch.cuda.synchronize()
            stages["RPN head"] = time.perf_counter() - t
            t = time.perf_counter()
            model._proposals(rpn, DET_SIZE, DET_SIZE)
            torch.cuda.synchronize()
            stages["proposals (top-k, decode, NMS of 4507 -> 256)"] = (
                time.perf_counter() - t)
        log("[detector] stages of one batch: " + ", ".join(
            f"{k} {1e3 * v:.1f} ms" for k, v in stages.items()))

        # The NMS loop's launches: one RPN-stage call under the profiler.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        n_cand = 4 * 1000 + 507
        xy = torch.rand(DET_B, n_cand, 2, generator=gen, device=device) * 700
        wh = torch.rand(DET_B, n_cand, 2, generator=gen, device=device) * 200
        boxes = torch.cat([xy, xy + wh + 1], -1)
        scores = torch.rand(DET_B, n_cand, generator=gen, device=device)
        dops.nms(boxes, scores, 0.7, 256)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dops.nms(boxes, scores, 0.7, 256)
        torch.cuda.synchronize()
        nms_ms = 1e3 * (time.perf_counter() - t)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            dops.nms(boxes, scores, 0.7, 256)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        log(f"[detector] nms over B={DET_B} x {n_cand} boxes, 256 slots: "
            f"{len(kernels)} kernel launches ({len(kernels) / 256:.1f} an "
            f"iteration), {nms_ms:.1f} ms wall, {dev_ms:.2f} ms of device "
            f"time ({card})")

        # One image against the same module on the CPU.
        cpu = FasterRCNN(device="cpu")
        cpu.load_state_dict(sd)
        cpu.eval()
        with torch.no_grad():
            want = cpu(torch.as_tensor(images_np[:1]))
        errs = {}
        for name in ("valid", "labels"):
            got = getattr(det, name)[:1].cpu()
            if not torch.equal(got, getattr(want, name)):
                raise AssertionError(f"detector {name} on the card "
                                     f"{got.tolist()} != the CPU's "
                                     f"{getattr(want, name).tolist()}")
        for name, (rtol, atol) in DET_TOL.items():
            got, ref = getattr(det, name)[:1].cpu(), getattr(want, name)
            err = (got - ref).abs()
            if (err > atol + rtol * ref.abs()).any():
                raise AssertionError(f"detector {name}: card vs CPU differ "
                                     f"by {err.max().item():.3g} (rtol "
                                     f"{rtol}, atol {atol})")
            errs[name] = err.max().item()
        log(f"[detector] image 0 on the card vs the same module on the CPU: "
            f"labels and valid equal ({int(want.valid.sum())} detections), "
            f"max abs err " + ", ".join(f"{k} {v:.3g}"
                                        for k, v in errs.items()))
        if profile:
            def run():
                return forward()[1], f"B={DET_B} at {DET_SIZE}"
            _profile(run, "detector", card)
        del model, cpu, images, det, pyramid, rpn, boxes, scores
        torch.cuda.empty_cache()

        try:
            import PIL  # noqa: F401
        except ImportError:
            log("[detector cli] Pillow is not installed on this machine: "
                "cli.extract_objects and cli.caption --obj over JPEGs were "
                "not run")
            return 0, 0

        folder = os.path.join(workdir, "det_images")
        write_jpegs(folder, DET_JPEGS)
        npz = os.path.join(workdir, "dets.npz")
        t = time.perf_counter()
        extract_objects.main(["--input", folder, "--fcnn", pth, "--output",
                              npz, "--batch", str(DET_B), "--device", "cuda"])
        wall = time.perf_counter() - t
        store = ObjectStore(npz)
        paths = [os.path.join(folder, f"{i:04d}.jpg")
                 for i in range(DET_JPEGS)]
        feats, labels = store.lookup(paths, DET_JPEGS)
        live = (labels > 0).sum(1)
        n_arrays = len(np.load(npz).files)
        if (n_arrays != 2 * DET_JPEGS or store.n_obj != 36
                or store.feat_dim != 1031 or not np.isfinite(feats).all()
                or live.min() < 1 or (feats[labels == 0] != 0).any()):
            raise AssertionError(
                f"extract_objects wrote {n_arrays} arrays, "
                f"[{store.n_obj}, {store.feat_dim}] features, live "
                f"detections per image {live.tolist()}")
        log(f"[detector cli] cli.extract_objects over {DET_JPEGS} JPEGs "
            f"(--batch {DET_B}: a tail of {DET_JPEGS % DET_B}) -> ObjectStore:"
            f" [36, 1031] features and labels per image, {live.min()}-"
            f"{live.max()} live detections, {wall:.1f} s wall = "
            f"{DET_JPEGS / wall:.1f} images/s ({card})")

        tok, _, _, tp = corpus
        cfg = caption_config(tp.vocab_size())
        ckpt = os.path.join(workdir, "captioner")
        save_checkpoint(ckpt, cfg, CAPTION.random_params(cfg, SEED))
        folder = os.path.join(workdir, "caption_images")
        write_jpegs(folder, DET_CAPTION_JPEGS, seed=SEED + 1)
        out = os.path.join(workdir, "captions.tsv")
        da.LAUNCHES = tkp.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording_decode_attention() as seen:
            ccli.main(["--tok", tok, "--model", ckpt, "--input", folder,
                       "--output", out, "--target", "fa", "--max_len",
                       str(DET_CAPTION_L), "--obj", "--fcnn", pth,
                       "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k4, k2 = da.LAUNCHES, tkp.LAUNCHES
        with open(out) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        if len(rows) != DET_CAPTION_JPEGS or not all(
                len(r) == 2 and r[0].endswith(".jpg") for r in rows):
            raise AssertionError(f"cli.caption --obj wrote {len(rows)} lines "
                                 f"for {DET_CAPTION_JPEGS} files")
        # Grid + objects: two streams of the 3-layer decoder, a K4 launch
        # each a step, and one K2 launch a step.
        if not seen or seen - checked_k4 or k2 == 0 or k4 != 6 * k2:
            raise AssertionError(
                f"cli.caption --obj: {k4} K4 and {k2} K2 launches, "
                f"unchecked shapes {sorted(seen - checked_k4)[:8]}")
        log(f"[detector cli] cli.caption --obj --fcnn over "
            f"{DET_CAPTION_JPEGS} JPEGs (--batch 192: 192 + 8, beam 4, "
            f"max_len {DET_CAPTION_L}; BERT-base 6+3, ResNet-18 at 224, the "
            f"object stream, fused): {len(rows)} lines in {wall:.1f} s = "
            f"{DET_CAPTION_JPEGS / wall:.1f} images/s (decode at 224 and 800, "
            f"detector, grid, dual beam search), K2 launches {k2}, K4 "
            f"launches {k4}, e.g. {rows[0]!r} ({card})")
        return k2, k4
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)


# ---------------- phase 24: packed MT steps ----------------

PACK = (64, 256)          # rows a packed batch, tokens a row (the JAX defaults)
PACK_EXAMPLES = 6000      # pairs of 6-60 tokens: ~12 packed batches
PACK_BLOCK = 6            # steps a timed block
CLI_BATCH = 20000         # cli.train_mt's --batch and --capacity defaults:
CLI_CAPACITY = 600        # its mt stream takes half of each


def pack_examples(vocab_size: int, n: int, seed=SEED):
    """n (src, dst, 0, 1) pairs of 6-60 tokens each, language token first
    and separator last, word ids skewed as ``train_batches`` draws them,
    sorted by target length as the binarizer writes them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ls, ld = rng.randint(4, 59, 2)
        s = (7 + (vocab_size - 7) * rng.rand(ls) ** 3).astype(int).tolist()
        d = (7 + (vocab_size - 7) * rng.rand(ld) ** 3).astype(int).tolist()
        out.append(([5] + s + [4], [6] + d + [4], 0, 1))
    out.sort(key=lambda e: len(e[1]))
    return out


def pack_shapes():
    """Phase 24's batches and the shapes they give K1 and K5: (packed
    batches, the bucketed batches of the same pairs that cli.train_mt
    builds without --pack, K1 (B, T, S, H, D) list, K5 (N, V) list).
    Computed before phase 6 so that it holds every one of them."""
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.data.packing import PackedMTBatcher

    examples = pack_examples(32000, PACK_EXAMPLES)
    packed = PackedMTBatcher(examples, rows_per_batch=PACK[0],
                             src_budget=PACK[1], dst_budget=PACK[1]).batches
    plain = list(MTBatcher(examples, pad_id=0, max_batch=CLI_BATCH // 2,
                           capacity_mb=CLI_CAPACITY // 2).shuffled(SEED))
    plain = plain[:len(packed)]
    k1, k5 = set(), set()
    for b in packed + plain:
        B, S = b.src.shape
        T = b.dst.shape[1] - 1                 # the decoder reads dst[:, :-1]
        k1 |= {(B, S, S, 12, 64), (B, T, T, 12, 64), (B, T, S, 12, 64)}
        k5.add((B * T, 32000))
    return packed, plain, sorted(k1), sorted(k5)


def phase_pack(card, profile: bool, checked, checked_xent, pack, corpus):
    """Phase 24: phase 7's model (BERT-base, fp32 masters, bf16 compute,
    dropout 0.1, the fused cross-entropy) on packed 64 x 256 batches beside
    the bucketed batches of the same pairs, in blocks; then
    cli.train_mt --pack --profile for 16 steps, its trace written. Returns
    (K1 fwd, K1 bwd, K5 fwd, K5 bwd) launches."""
    import dataclasses
    import marshal

    import torch

    from imagetranslate_tpu_torch.cli import train_mt
    from imagetranslate_tpu_torch.data.packing import (
        PackedMTBatcher,
        packing_efficiency,
    )
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.step import (
        mt_batch_to_device,
        packed_mt_batch_to_device,
    )
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    packed, plain, _, _ = pack
    cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                              attention_dropout=RATE, use_pallas_xent=True)
    trainer = MTTrainer(cfg, FullVocab(), lr=5e-4, warmup=8, seed=SEED,
                        device=device)
    arms = {"bucketed": [mt_batch_to_device(b, device) for b in plain],
            "packed": [packed_mt_batch_to_device(b, device) for b in packed]}
    slots = {"bucketed": sum(b.dst.shape[0] * (b.dst.shape[1] - 1)
                             for b in plain),
             "packed": sum(b.dst.shape[0] * (b.dst.shape[1] - 1)
                           for b in packed)}
    done = {"bucketed": 0, "packed": 0}
    metrics = []

    def block(arm, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = []
        for _ in range(n):
            batch = arms[arm][done[arm] % len(arms[arm])]
            done[arm] += 1
            trainer.state, m = trainer.mt_step(trainer.state, batch,
                                               trainer.rng)
            tokens.append(m["ntokens"])
            metrics.append(m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        real = sum(int(t.item()) for t in tokens)
        return 1e3 * secs / n, real / secs, real / n

    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
    with Recorder() as rec:
        block("bucketed", 2)                          # warm-up
        block("packed", 2)
        readings = {"bucketed": [], "packed": []}
        for arm in ("bucketed", "packed", "packed", "bucketed"):
            readings[arm].append(block(arm, PACK_BLOCK))
    rec.require_checked("pack", checked, checked_xent)
    n_steps = len(metrics)
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    got = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
           xent.BWD_LAUNCHES)
    if got != (per_step * n_steps,) * 2 + (n_steps,) * 2:
        raise AssertionError(f"pack: K1 / K5 launches {got} in {n_steps} "
                             f"steps, want {per_step} + {per_step} and 1 + 1 "
                             f"a step")
    losses = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"pack: loss not finite: {losses}")
    eff = packing_efficiency(packed)
    real = sum(int(b.dst_seg.astype(bool).sum()) for b in packed)
    share = {"packed": eff,
             "bucketed": sum(int(b.dst_mask[:, 1:].sum()) for b in plain)
             / slots["bucketed"]}
    shapes = sorted({b.dst.shape for b in plain})
    for arm, rs in readings.items():
        log(f"[pack] {arm}: ms/step {[round(r[0], 2) for r in rs]}, target "
            f"tok/s {[round(r[1], 1) for r in rs]}, real target tokens a "
            f"step {[round(r[2], 1) for r in rs]}; {len(arms[arm])} batches, "
            f"{slots[arm]} target slots, {share[arm]:.3f} of them real "
            f"({card})")
    log(f"[pack] BERT-base fp32 masters / bf16 compute, dropout {RATE}, fused "
        f"cross-entropy, {PACK_EXAMPLES} pairs of 6-60 tokens: packed into "
        f"{len(packed)} batches of {PACK[0]} x {PACK[1]} ({real} target "
        f"tokens, efficiency {eff:.3f}) against cli.train_mt's bucketed "
        f"batches {shapes[:4]}...; blocks of {PACK_BLOCK} steps in the order "
        f"bucketed, packed, packed, bucketed; K1 {got[0]} + {got[1]}, K5 "
        f"{got[2]} + {got[3]} launches in {n_steps} steps ({card})")
    if profile:
        _profile(lambda: (block("packed", 3)[0] * 3e-3, "3 packed steps"),
                 "pack", card)
    del trainer, arms
    torch.cuda.empty_cache()

    # cli.train_mt --pack --profile: 16 steps of the CLI's default model in
    # its first epoch, the trace of steps 10-15 written.
    tok, _, _, tp = corpus
    workdir = tempfile.mkdtemp()
    try:
        examples = pack_examples(tp.vocab_size(), PACK_EXAMPLES * 3 // 2,
                                 seed=SEED + 1)
        examples = [([tp.token_id("<en>")] + s[1:], [tp.token_id("<fa>")]
                     + d[1:-1] + [tp.sep_token_id()], 0, 1)
                    for s, d, _, _ in examples]
        n_batches = len(PackedMTBatcher(examples))
        if n_batches < 16:
            raise AssertionError(f"pack cli: {n_batches} packed batches, "
                                 f"want 16 in the first (profiled) epoch")
        data = os.path.join(workdir, "train.mt")
        with open(data, "wb") as f:
            marshal.dump(examples, f)
        prof_dir = os.path.join(workdir, "trace")
        fwd0, bwd0 = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        t0 = time.perf_counter()
        with Recorder() as rec:
            train_mt.main(["--tok", tok, "--model", os.path.join(workdir, "m"),
                           "--train_mt", data, "--step", "16", "--pack",
                           "--profile", prof_dir, "--device", "cuda"])
        wall = time.perf_counter() - t0
        rec.require_checked("pack cli", checked, checked_xent, want_k5=False)
        trace = os.path.join(prof_dir, "trace_steps_10_15.json")
        if not os.path.isfile(trace) or os.path.getsize(trace) == 0:
            raise AssertionError(f"cli.train_mt --profile wrote no trace: "
                                 f"{os.listdir(prof_dir) if os.path.isdir(prof_dir) else 'no directory'}")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        cli_fwd = ta.FWD_LAUNCHES - fwd0
        cli_bwd = ta.BWD_LAUNCHES - bwd0
        if not (cli_fwd == cli_bwd == 16 * 18):
            raise AssertionError(f"pack cli: {cli_fwd} + {cli_bwd} K1 "
                                 f"launches in 16 steps, want 18 + 18 a step")
        log(f"[pack cli] cli.train_mt --pack --profile: 16 steps of the "
            f"default model (768/12/3072, 6+6, bf16) on packed {PACK[0]} x "
            f"{PACK[1]} batches in {wall:.1f} s wall (build included); trace "
            f"{os.path.getsize(trace) / 2 ** 20:.1f} MiB with {len(events)} "
            f"events, {kernels} of them device kernels; K1 {cli_fwd} + "
            f"{cli_bwd} launches ({card})")
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return (got[0] + cli_fwd, got[1] + cli_bwd, got[2], got[3])


K2B = (256, 4, 4)      # M, k, shards of the timed K2b (BERT-base head)


def k2b_bound(M: int, k: int, n: int, E: int = 768, V: int = 32000):
    """One rank's K2b: K2 over V/n rows (h, its W and bias read once) and
    the merge of the gathered n triples (read once) into the output
    (written once); 2 M E V/n operations on the bf16 tensor cores. The
    all_gather between them is communication, not counted."""
    vs = V // n
    return bound(M * E * 2 + vs * E * 2 + vs * 4 + n * M * (8 * k + 4)
                 + M * (8 * k + 4), 2.0 * M * E * vs)


def merge_bound(M: int, k: int, n: int):
    return bound(n * M * (8 * k + 4) + M * (8 * k + 4), 0.0)


def phase_kernel_k2b():
    """Phase 25: K2b on the card, in one process. K2 over each of n column
    slices of a BERT-base head plus the merge kernel against K2 over the
    whole vocabulary (indices equal, values bit-equal: each logit is the
    same fp32 sum over E in either launch; lse within 1e-5), and the merge
    kernel against its plain version on the same gathered triples; ties
    across the shard boundaries, all-equal rows, ragged M, k = 1, 4, 16.
    Then the merge alone and one rank's K2b (K2 on its slice + the merge)
    timed at M=256, k=4, n=4, beside the plain version and the library
    chain. Returns the kernels-line entry."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import topk_project as tkp

    E, V = 768, 32000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)

    def head(M, ties=False, flat=False):
        h = torch.randn(M, E, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(V, E, generator=gen, device="cuda") * 0.05).bfloat16()
        b = torch.randn(V, generator=gen, device="cuda") * 0.1
        if ties:   # columns 77, 333, 900 and one in each further quarter
            cols = [77, 333, 900, 8077, 16333, 24900, 31999]
            w[cols] = w[77].clone()
            b[cols] = b[77] + 30.0         # the top of every row
        if flat:   # rows 0 and M - 1 all equal (zero h, zero bias)
            b.zero_()
            h[0] = 0.0
            h[-1] = 0.0
        return h, w, b

    def split(h, w, b, k, n):
        """K2 on each slice, indices shifted: the gathered [n, M, k],
        [n, M, k], [n, M] of n ranks."""
        parts = [tkp.project_topk(h, ws.contiguous(), bs.contiguous(), k)
                 for ws, bs in zip(w.chunk(n), b.chunk(n))]
        vs = V // n
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] + i * vs for i, p in enumerate(parts)]),
                torch.stack([p[2] for p in parts]))

    max_err = 0.0
    cases = [(M, k, n, t, f) for n in (2, 4) for M, k in
             ((256, 4), (100, 1), (100, 16), (1, 4), (1, 16), (256, 16))
             for t, f in ((False, False), (True, False), (False, True))]
    for M, k, n, ties, flat in cases:
        h, w, b = head(M, ties, flat)
        full = tkp.project_topk(h, w, b, k)
        vals, idxs, lses = split(h, w, b, k, n)
        got = tkp.merge_shard_topk(vals, idxs, lses, k)
        plain = tkp.merge_shard_topk_reference(vals, idxs, lses, k)
        torch.cuda.synchronize()
        lse_err = (got[2] - full[2]).abs().max().item()
        plain_err = (got[2] - plain[2]).abs().max().item()
        if not (torch.equal(got[1], full[1]) and torch.equal(got[0], full[0])
                and lse_err <= 1e-5):
            bad = int((got[1] != full[1]).sum())
            raise AssertionError(
                f"K2b at M={M} k={k} n={n} ties={ties} flat={flat}: {bad} "
                f"indices differ from K2 over V, values bit-equal "
                f"{torch.equal(got[0], full[0])}, lse err {lse_err:.3g}")
        if not (torch.equal(got[1], plain[1]) and torch.equal(got[0], plain[0])
                and plain_err <= 1e-5):
            raise AssertionError(f"merge kernel vs plain at M={M} k={k} "
                                 f"n={n}: lse err {plain_err:.3g}")
        tied = [77, 333, 900, 8077, 16333, 24900, 31999][:k]
        if ties and not (got[1][:, :len(tied)] == torch.tensor(
                tied, device="cuda")).all():
            raise AssertionError("cross-shard ties out of index order")
        if flat and not (got[1][0] == torch.arange(k, device="cuda")).all():
            raise AssertionError("an all-equal row out of index order")
        max_err = max(max_err, lse_err, plain_err)
    log(f"[kernel K2b] {len(cases)} cases (n = 2, 4; M = 256, 100, 1; k = 1, "
        f"4, 16; cross-shard ties, all-equal rows): K2 on V/n + "
        f"itt_topk_merge gives K2's indices over V=32000 and bit-equal "
        f"values, lse within {max_err:.3g}; the merge kernel equals its "
        "plain version")

    # Times at the main path's shape, in turns, with a cold L2.
    M, k, n = K2B
    h, w, b = head(M)
    ws, bs = w.chunk(n)[0].contiguous(), b.chunk(n)[0].contiguous()
    vals, idxs, lses = split(h, w, b, k, n)

    def rank_k2b():
        tkp.project_topk(h, ws, bs, k)
        return tkp.merge_shard_topk(vals, idxs, lses, k)

    def rank_plain():
        tkp.project_topk_reference(h, ws, bs, k)
        return tkp.merge_shard_topk_reference(vals, idxs, lses, k)

    def rank_chain():
        logits = F.linear(h, ws).float() + bs
        shard = torch.topk(logits, k), torch.logsumexp(logits, -1)
        cand = vals.permute(1, 0, 2).reshape(M, n * k)
        return shard, torch.topk(cand, k), torch.logsumexp(lses, 0)

    runs = {"kernel": [], "merge": [], "plain": [], "chain": []}
    fns = {"kernel": rank_k2b, "plain": rank_plain, "chain": rank_chain,
           "merge": lambda: tkp.merge_shard_topk(vals, idxs, lses, k)}
    for name in ("plain", "kernel", "merge", "chain", "chain", "merge",
                 "kernel", "plain"):
        runs[name].append(_time_ms(fns[name]))
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    bound_ms, bound_by = k2b_bound(M, k, n)
    mbound_ms, _ = merge_bound(M, k, n)
    log(f"[kernel K2b] one rank at M={M} E={E} V={V}/{n} k={k}: K2 on its "
        f"slice + merge {runs['kernel']} ms (bound {bound_ms:.4f} ms, "
        f"{bound_by}), the merge alone {runs['merge']} ms (bound "
        f"{mbound_ms:.5f} ms), plain {runs['plain']} ms, library chain "
        f"(F.linear + topk + logsumexp, topk of the candidates) "
        f"{runs['chain']} ms")
    # No single PyTorch call computes K2 + the merge; the chain of calls is
    # reported beside it.
    return {"max_abs_err": max_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "chain_ms": ms["chain"], "merge_ms": ms["merge"],
            "merge_bound_ms": mbound_ms}


TP_MESHES = ((1, 4), (2, 2))   # phase 26's decode meshes over four ranks


def tp_path_rank(rank, src, B, K, train_argv):
    """One of phase 26's four ranks, all on the one card over gloo: the
    beam decode of phase 4's model under each mesh of TP_MESHES (each data
    rank decodes its rows, every rank of a model group through K2b), then
    ``cli.train_mt`` under ``--mesh 2x2`` (the CLI finds the process group
    up and builds its mesh on it). Returns, per mesh, the gathered tokens,
    the decode steps, the K2 and merge launches and the vocab rows each K2
    launch saw; then the CLI's K1, K2 and merge launches and its output;
    and the backend and device of the rank."""
    import contextlib
    import io

    import torch

    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.decoding.beam import beam_search
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.parallel.comm import (
        all_gather_stack,
        all_reduce_sum,
    )
    from imagetranslate_tpu_torch.parallel.mesh import make_mesh, shard_params
    from imagetranslate_tpu_torch.train.weights import (
        random_params,
        state_dict_from_flax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bert_base(32000)
    full = state_dict_from_flax(random_params(cfg, SEED), cfg)
    rows_seen = []
    k2 = tkp.project_topk

    def recording(h, w, b, k):
        rows_seen.append(int(w.shape[0]))
        return k2(h, w, b, k)

    out = []
    backend = torch.distributed.get_backend()
    for n_data, n_model in TP_MESHES:
        mesh = make_mesh(n_data, n_model, device="cuda")
        dev = mesh.device
        # A group's first collective sets it up (NCCL's communicator): not
        # in the timed decode.
        for group in (mesh.model_group, mesh.data_group):
            all_reduce_sum(torch.zeros(1, device=dev), group)
        model = Seq2Seq(cfg, device=dev)
        model.load_state_dict(shard_params(full, mesh, model.shard_(mesh)))
        model.eval()
        rows = B // n_data
        mine = torch.as_tensor(src[mesh.d * rows:(mesh.d + 1) * rows]).to(dev)
        S = mine.shape[1]
        mask = torch.ones_like(mine, dtype=torch.bool)
        steps = 0
        step = model.decode_step

        def counted(*a, **kw):
            nonlocal steps
            steps += 1
            return step(*a, **kw)

        model.decode_step = counted
        tkp.project_topk = recording
        rows_seen.clear()
        tkp.LAUNCHES = tkp.MERGE_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                enc = model.encode(mine, mask, torch.zeros(
                    (rows,), dtype=torch.int32, device=dev))
                best, _ = beam_search(
                    model, enc, mask,
                    torch.full((rows,), 6, dtype=torch.int32, device=dev),
                    torch.ones((rows,), dtype=torch.int32, device=dev),
                    torch.full((rows,), S, dtype=torch.int32, device=dev),
                    beam_width=K, max_len=max_len_for_decode(S),
                    len_penalty_ratio=0.8, pad_id=cfg.pad_id, eos_id=-1,
                    data_group=mesh.data_group)
            torch.cuda.synchronize()
        finally:
            tkp.project_topk = k2
        seconds = time.perf_counter() - t0
        launches = (tkp.LAUNCHES, tkp.MERGE_LAUNCHES)
        best = all_gather_stack(best, mesh.data_group).flatten(0, 1)
        out.append((best.cpu().numpy(), steps, launches, sorted(
            set(rows_seen)), seconds))
        del model, enc
        torch.cuda.empty_cache()
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    tkp.LAUNCHES = tkp.MERGE_LAUNCHES = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_main(train_argv)
    cli = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, tkp.LAUNCHES,
           tkp.MERGE_LAUNCHES, text.getvalue())
    return out, cli, (backend, str(dev))


def max_len_for_decode(S: int) -> int:
    """L of run_decode: max_len_for(S, 1.3, 5, 512)."""
    return min(int(1.3 * S + 5), 512)


def phase_tp_path(card):
    """Phase 26: the tensor- and data-parallel path. Four spawned ranks (on
    the one card over gloo; one card each over NCCL where there are four)
    decode phase 4's model and batch (BERT-base
    bf16, B=64, S=64, beam 4, every row to its limit) under 1x4 and 2x2
    against the one-process decode (the sequence scores of both under the
    one-process model within DECODE_SCORE_RTOL: bf16 near-ties may part the
    tokens; every rank's merge launches and K2 launches equal its decode
    steps, and every K2 launch sees V/n rows); then, in the same ranks,
    cli.train_mt --mesh 2x2 for a few MT steps and a dev decode (loss
    finite, K1 and the merge launched); then cli.translate --dp 2 under
    torchrun on 50 lines of that checkpoint, byte for byte --dp 0's output.
    Returns the merge, K2, K1 forward and K1 backward launches of the
    path."""
    import importlib.util

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import create_mt_batches
    from imagetranslate_tpu_torch.cli import train_tokenizer
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.parallel.spawn import run_ranks

    device = torch.device("cuda")
    B, S, K, _ = MT_DECODE
    V = 32000
    one = build_model(bert_base(V), device)
    best_one, _, steps_one, _ = run_decode(one, B, S, K, device)
    src = np.random.RandomState(SEED).randint(5, V, (B, S))
    src_t = torch.as_tensor(src).to(device)
    score_one = sequence_scores(one, src_t, best_one)
    bleu = importlib.util.find_spec("sacrebleu") is not None
    with tempfile.TemporaryDirectory() as workdir:
        rng = np.random.RandomState(SEED + 26)
        lines = [" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 12))) for _ in range(200)]
        paths = {n: os.path.join(workdir, n) for n in (
            "src.txt", "dst.txt", "tagged.txt", "tok", "train.mt", "dev.src",
            "dev.dst", "dev.mt", "model", "in.txt", "dp0.txt", "dp2.txt",
            "store")}
        for name, rows in (("src.txt", lines), ("dev.src", lines[:8]),
                           ("dst.txt", [" ".join(reversed(ln.split()))
                                        for ln in lines]),
                           ("dev.dst", [" ".join(reversed(ln.split()))
                                        for ln in lines[:8]]),
                           ("in.txt", lines[:50])):
            with open(paths[name], "w") as f:
                f.write("\n".join(rows) + "\n")
        with open(paths["tagged.txt"], "w") as f:
            f.write("\n".join(f"<en> {ln} </s>" for ln in lines) + "\n")
            f.write("<fa> " + lines[0] + " </s>\n")
        train_tokenizer.main(["--data", paths["tagged.txt"], "--vocab_size",
                              "300", "--model", paths["tok"]])
        for src_f, dst_f, out_f in (("src.txt", "dst.txt", "train.mt"),
                                    ("dev.src", "dev.dst", "dev.mt")):
            create_mt_batches.main(["--tok", paths["tok"], "--src",
                                    paths[src_f], "--src-lang", "en", "--dst",
                                    paths[dst_f], "--dst-lang", "fa",
                                    "--output", paths[out_f]])
        cli_steps = 4
        train_argv = ["--mesh", "2x2", "--tok", paths["tok"], "--model",
                      paths["model"], "--train_mt", paths["train.mt"],
                      "--dec", "3", "--step", str(cli_steps), "--batch",
                      "2000", "--lr", "0.001", "--warmup", "10",
                      "--eval-every", "1000", "--device", "cuda"]
        train_argv += ["--dev_mt", paths["dev.mt"], "--beam", "4"]
        t0 = time.perf_counter()
        per_rank = run_ranks(tp_path_rank, 4, paths["store"],
                             (src, B, K, train_argv), device="cuda",
                             timeout=600)
        ranks_s = time.perf_counter() - t0
        merge_launches = k2_launches = k1_fwd = k1_bwd = 0
        where = (f"{per_rank[0][2][0]} on "
                 f"{sorted(set(r[2][1] for r in per_rank))}")
        for i, (n_data, n_model) in enumerate(TP_MESHES):
            for r, (decodes, _, _) in enumerate(per_rank):
                best, steps, (k2_n, merge_n), seen, secs = decodes[i]
                if not (steps == steps_one and k2_n == steps
                        and merge_n == steps and seen == [V // n_model]):
                    raise AssertionError(
                        f"{n_data}x{n_model} rank {r}: {steps} steps (one "
                        f"process: {steps_one}), {k2_n} K2 and {merge_n} "
                        f"merge launches, K2 saw vocab rows {seen}")
                merge_launches += merge_n
                k2_launches += k2_n
            best = torch.as_tensor(per_rank[0][0][i][0]).to(device)
            score = sequence_scores(one, src_t, best)
            rel = ((score - score_one).abs() / score_one.abs()).max().item()
            same = (best == best_one).float().mean().item()
            if rel > DECODE_SCORE_RTOL:
                raise AssertionError(
                    f"{n_data}x{n_model} decode: sequence scores differ from "
                    f"the one-process decode by {rel:.3g}")
            log(f"[tp path] {n_data}x{n_model} over {where}: B={B} "
                f"S={S} beam {K}, {steps_one} steps, each rank {steps_one} "
                f"K2 launches over {V // n_model} vocab rows and "
                f"{steps_one} merges; tokens {same:.4f} equal to the "
                f"one-process decode's, sequence scores within {rel:.2e} "
                f"(limit {DECODE_SCORE_RTOL:.0e}); rank 0 decoded in "
                f"{per_rank[0][0][i][4]:.2f} s ({card})")
        fwd, bwd, cli_k2, cli_merge, text = per_rank[0][1]
        losses = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                  if ln.startswith("Total loss in this epoch:")]
        if not losses or not all(np.isfinite(losses)) or fwd == 0 or bwd == 0:
            raise AssertionError(f"train_mt --mesh 2x2: losses {losses}, "
                                 f"K1 {fwd} + {bwd} launches")
        if cli_merge == 0:
            raise AssertionError("train_mt --mesh 2x2: the dev decode "
                                 "launched no merge")
        for _, (f, b, k2_n, merge_n, _), _ in per_rank:
            k1_fwd += f
            k1_bwd += b
            merge_launches += merge_n
            k2_launches += k2_n
        log(f"[tp path] cli.train_mt --mesh 2x2: {cli_steps} steps, epoch "
            f"losses {losses}, rank 0 {fwd} + {bwd} K1 launches, "
            f"a dev decode with {cli_merge} merges on rank 0 (BLEU "
            f"{'scored' if bleu else 'not scored: no sacrebleu here'}); "
            f"the four ranks in {ranks_s:.1f} s in all")
        # cli.translate --dp 2 under torchrun against --dp 0, one card.
        latest = paths["model"] + ".latest"
        args = ["--tok", paths["tok"], "--model", latest, "--input",
                paths["in.txt"], "--src", "en", "--target", "fa", "--device",
                "cuda"]
        tkp.LAUNCHES = 0
        translate_main(args + ["--output", paths["dp0.txt"]])
        k2_launches += tkp.LAUNCHES
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m",
             "imagetranslate_tpu_torch.cli.translate", "--dp", "2", *args,
             "--output", paths["dp2.txt"]],
            cwd=HERE, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=HERE + os.pathsep
                     + os.environ.get("PYTHONPATH", "")))
        if proc.returncode != 0:
            raise AssertionError("translate --dp 2 failed:\n"
                                 + proc.stdout[-3000:] + proc.stderr[-3000:])
        with open(paths["dp0.txt"], "rb") as f:
            want = f.read()
        with open(paths["dp2.txt"], "rb") as f:
            got = f.read()
        if got != want or len(want.splitlines()) != 50:
            raise AssertionError("translate --dp 2 wrote other bytes than "
                                 "--dp 0")
        log(f"[tp path] cli.translate --dp 2 (torchrun, two ranks, "
            f"{torch.cuda.device_count()} card(s)) wrote --dp 0's 50 lines "
            f"byte for byte in "
            f"{time.perf_counter() - t0:.1f} s")
    del one
    torch.cuda.empty_cache()
    return merge_launches, k2_launches, k1_fwd, k1_bwd


# ---------------- phases 27-29: module 15 ----------------

REMAT_ARMS = ("off", "remat_ffn", "remat")
REMAT_STEPS = 4       # steps an arm and batch shape takes after its first


def hold_k1(what: str, seen, checked):
    """Hold K1 (forward and backward at rate 0.1, as phase 6 does) against
    its plain version at every shape of ``seen`` (B, T, S, H, D, bias rows)
    that the kernel phases did not check; those join ``checked``. Runs
    after the run's launches were read: these launches are not counted in
    it."""
    import torch

    from imagetranslate_tpu_torch.ops import train_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    new = sorted(seen - checked)
    for shape in new:
        B, T, S, H, D, rows = shape
        q, k, v, g = (torch.randn(B, n, H, D, generator=gen,
                                  device="cuda").bfloat16()
                      for n in (T, S, S, T))
        bias = torch.randn(B, 1, rows, S, generator=gen, device="cuda")
        masked = torch.rand(bias.shape, generator=gen, device="cuda") < 0.2
        bias = torch.where(masked, torch.full_like(bias, -10000.0), bias)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = ta.fused_dropout_attention(*leaves, RATE, 5)
        grads = torch.autograd.grad(out, leaves, g)
        want = ta.fused_dropout_attention_reference(q, k, v, bias, RATE, 5)
        hand = ta.fused_dropout_attention_backward_reference(
            q, k, v, bias, g, RATE, 5)
        for name, got, ref in zip(("out", "dq", "dk", "dv", "dbias"),
                                  (out, *grads), (want, *hand)):
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = DBIAS_TOL if name == "dbias" else ATTN_TOL
            if got.shape != ref.shape or not err <= tol * scale:
                raise AssertionError(f"[{what}] K1 vs plain, {name} at "
                                     f"{shape}: err {err:.3g} > {tol:.3g} "
                                     f"* {scale:.3g}")
        checked.add(shape)
    log(f"[{what}] K1 shapes (B, T, S, H, D, bias rows) {sorted(seen)}: "
        f"{len(new)} of them held against the plain version here {new}, "
        "the rest by phase 6")


def mt_objective(model, batch, rng):
    """The MT step's objective on a staged batch, padded or packed (the
    train step's forward and loss, ``train/step.py``), dropout from
    ``rng``."""
    from imagetranslate_tpu_torch.train.step import _loss_impl

    if "src_seg" in batch:
        logits = model(batch["src"], batch["src_seg"] > 0, batch["dst"],
                       batch["dst_seg"] > 0, batch["src_langs"],
                       batch["dst_langs"], tgt_positions=batch["dst_pos"],
                       src_positions=batch["src_pos"],
                       src_segments=batch["src_seg"],
                       tgt_segments=batch["dst_seg"], deterministic=False,
                       rng=rng)
        seg = batch["dst_seg"]
        mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
    else:
        logits = model(batch["src"], batch["src_mask"], batch["dst"],
                       batch["dst_mask"], batch["src_langs"],
                       batch["dst_langs"], deterministic=False, rng=rng)
        mask = batch["dst_mask"][:, 1:] & batch["row_mask"][:, None]
    s, n = _loss_impl(model)(logits, batch["dst"][:, 1:], mask, epsilon=0.1)
    return s / n


def phase_remat(card, checked, checked_xent, pack):
    """Phase 27: phase 7's trainer (BERT-base, fp32 masters, bf16 compute,
    dropout 0.1, the fused cross-entropy) on B=256, S=T=64 and on phase
    24's packed 64 x 256 batches, each in three arms from one seed: without
    recompute, with ``remat_ffn`` and with ``remat``. Returns (K1 fwd, K1
    bwd, K5 fwd, K5 bwd) launches of the arms' steps."""
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.step import packed_mt_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                              attention_dropout=RATE, use_pallas_xent=True)
    shapes = {
        "B=256 S=T=64": train_batches(cfg, 2, 256, 64, 64, device),
        "packed 64 x 256": [packed_mt_batch_to_device(b, device)
                            for b in pack[0][:2]],
    }
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    n = REMAT_STEPS + 1
    totals = [0, 0, 0, 0]
    with Recorder() as rec:
        for label, batches in shapes.items():
            ref = None
            first = {}
            for arm in REMAT_ARMS:
                arm_cfg = dataclasses.replace(cfg, remat=arm == "remat",
                                              remat_ffn=arm == "remat_ffn")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                trainer = MTTrainer(arm_cfg, FullVocab(), lr=5e-4, warmup=8,
                                    seed=SEED, device=device)
                params = list(trainer.model.parameters())
                # Deterministic algorithms for the comparison: the CUDA
                # embedding backward accumulates with atomics, which moves
                # the position and language tables' gradients by ~1e-6 of
                # their largest value between two runs of one arm.
                was = torch.are_deterministic_algorithms_enabled()
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    loss = mt_objective(trainer.model, batches[0],
                                        torch.Generator().manual_seed(SEED))
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, torch.autograd.grad(
                                 loss, params, allow_unused=True))]
                finally:
                    torch.use_deterministic_algorithms(was)
                worst = 0.0
                if ref is None:
                    ref = (loss.item(), grads)
                else:
                    if loss.item() != ref[0]:
                        raise AssertionError(f"remat {label} {arm}: loss "
                                             f"{loss.item()!r} != "
                                             f"{ref[0]!r} without recompute")
                    for g, r in zip(grads, ref[1]):
                        scale = r.abs().max().item()
                        err = (g - r).abs().max().item()
                        worst = max(worst, err / scale if scale else err)
                    if worst > 1e-6:
                        raise AssertionError(f"remat {label} {arm}: "
                                             f"gradients differ by {worst:.3g}"
                                             " of a tensor's largest value")
                del grads, loss
                ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
                xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
                metrics = []
                for i in range(n):
                    if i == 1:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    trainer.state, m = trainer.mt_step(
                        trainer.state, batches[i % len(batches)],
                        trainer.rng)
                    metrics.append(m)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / REMAT_STEPS
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                got = (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
                       xent.BWD_LAUNCHES)
                want = (per_step * n * (2 if arm == "remat" else 1),
                        per_step * n, n, n)
                if got != want:
                    raise AssertionError(f"remat {label} {arm}: K1 / K5 "
                                         f"launches {got} in {n} steps, "
                                         f"want {want}")
                totals = [a + b for a, b in zip(totals, got)]
                losses = [(m["sum_loss"] / m["ntokens"]).item()
                          for m in metrics]
                if not all(x == x and abs(x) != float("inf") for x in losses):
                    raise AssertionError(f"remat {label} {arm}: loss not "
                                         f"finite: {losses}")
                first[arm] = metrics[0]["sum_loss"].item()
                log(f"[remat] {label}, {arm}: {ms:.2f} ms/step ({REMAT_STEPS}"
                    f" steps after the first), peak memory {peak:.2f} GiB "
                    f"(model, Adam state and the step); K1 {got[0] // n} + "
                    f"{got[1] // n} and K5 {got[2] // n} + {got[3] // n} "
                    f"launches a step; first-step loss sum {first[arm]!r}; "
                    f"objective {ref[0]!r}, largest gradient difference "
                    f"{worst:.3g} of a tensor's largest value against the "
                    f"arm without recompute (deterministic algorithms) "
                    f"({card})")
                del trainer, params, metrics
            if len(set(first.values())) != 1:
                raise AssertionError(f"remat {label}: first-step losses "
                                     f"{first} differ across the arms")
            del ref
    rec.require_checked("remat", checked, checked_xent)
    torch.cuda.empty_cache()
    return tuple(totals)


def prepare_itr1_corpus(workdir):
    """A parallel corpus (phase 8's: lines of 2-12 words, the reversed line
    as the target) and a 300-entry tokenizer from cli.train_tokenizer.
    Returns (tokenizer dir, source path, target path, lines)."""
    import numpy as np

    from imagetranslate_tpu_torch.cli import train_tokenizer

    rng = np.random.RandomState(SEED + 28)
    lines = [" ".join(WORDS[j] for j in rng.randint(
        0, len(WORDS), rng.randint(2, 12))) for _ in range(1200)]
    src, dst = (os.path.join(workdir, n) for n in ("src.txt", "dst.txt"))
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(dst, "w") as f:
        f.write("\n".join(" ".join(reversed(ln.split())) for ln in lines)
                + "\n")
    tagged = os.path.join(workdir, "tagged.txt")
    with open(tagged, "w") as f:
        f.write("\n".join(f"<en> {ln} </s>" for ln in lines) + "\n")
        f.write("<fa> " + lines[0] + " </s>\n")
    tok = os.path.join(workdir, "tok")
    train_tokenizer.main(["--data", tagged, "--vocab_size", "300",
                          "--model", tok])
    return tok, src, dst, lines


def _same_batches(what, got, want, names):
    if len(got) != len(want) or not got:
        raise AssertionError(f"{what}: {len(got)} batches, want "
                             f"{len(want)}")
    for g, w in zip(got, want):
        for name in names:
            a, b = getattr(g, name), getattr(w, name)
            if (a is None) != (b is None) or (
                    a is not None and (a.dtype != b.dtype
                                       or not (a == b).all())):
                raise AssertionError(f"{what}: batch field {name} differs")


def cpu_name() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, else vendor and
    family), and its core count."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name") or " ".join(
        v for v in (info.get("vendor_id"), info.get("cpu family") and
                    f"family {info['cpu family']}",
                    info.get("model") and f"model {info['model']}") if v)
    return (f"{name or platform.machine() or 'unknown CPU'}, "
            f"{os.cpu_count()} cores")


def phase_host_native():
    """The native host libraries of module 15 on this host: the record
    library and the BPE library must have been built by g++ here and be in
    use; the JPEG decoder where jpeglib.h is found (its build must not fail
    then). Returns the decoder's name for the logs."""
    from imagetranslate_tpu_torch.data import imagedec, recordio
    from imagetranslate_tpu_torch.text import native as bpe_native
    from imagetranslate_tpu_torch.utils import native

    build_dir = os.path.realpath(native.BUILD_DIR)
    for name, get in (("recordio", recordio.get_lib),
                      ("bpe", bpe_native.get_lib)):
        if get() is None:
            raise AssertionError(f"lib{name}.so was not built by g++ on "
                                 "this host")
        path = os.path.realpath(native.LOADED[name])
        if not path.startswith(build_dir + os.sep):
            raise AssertionError(f"lib{name}.so loaded from {path}, not "
                                 f"from {build_dir}")
    header = native.has_header("jpeglib.h")
    lib = imagedec.get_lib()
    if header and lib is None:
        raise AssertionError("jpeglib.h is present but the native JPEG "
                             "decoder did not build")
    decoder = ("native (libjpeg, DCT prescale "
               f"{'on' if imagedec.FAST_DCT_SCALE else 'off'})"
               if lib is not None else "Pillow (no jpeglib.h on this host)")
    log(f"[itr1] host libraries: "
        + ", ".join(f"lib{n}.so {'compiled in this run' if native.COMPILED.get(n) else 'from an earlier build'} "
                    f"at {os.path.relpath(native.LOADED[n], HERE)}"
                    for n in sorted(native.LOADED))
        + f"; JPEG decoder: {decoder}")
    return decoder


def time_host_itr1(n_examples: int = 200_000):
    """Host numbers: batching ITR1 records through pack_padded against the
    list batcher over the marshal file of the same examples, and the C++
    BPE encode against the Python one."""
    import marshal

    from imagetranslate_tpu_torch.data.binarize import load_mt
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.data.recordio import (
        PackedReader,
        PackedWriter,
    )

    examples = pack_examples(32000, n_examples, seed=SEED + 5)
    kw = dict(pad_id=0, max_batch=CLI_BATCH // 2,
              capacity_mb=CLI_CAPACITY // 2)
    with tempfile.TemporaryDirectory() as d:
        mpath, ppath = os.path.join(d, "m.mt"), os.path.join(d, "p.mt")
        with open(mpath, "wb") as f:
            marshal.dump(examples, f)
        with PackedWriter(ppath, 4) as w:
            for ex in examples:
                w.add(*ex)
        t0 = time.perf_counter()
        listed = MTBatcher(load_mt(mpath), **kw)
        t_list = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader = PackedReader(ppath)
        packed = MTBatcher.from_packed(reader, **kw)
        t_packed = time.perf_counter() - t0
        if not reader.native:
            raise AssertionError("the ITR1 reader did not use librecordio")
        _same_batches("host batching", packed.batches, listed.batches,
                      ("src", "dst", "src_sizes", "row_mask", "src_langs",
                       "dst_langs"))
    return t_list, t_packed, len(packed), n_examples


def time_host_bpe(tp, lines):
    """(Python encode s, C++ encode s, lines) over ``lines``, the ids
    equal."""
    from imagetranslate_tpu_torch.text.native import NativeBPE

    if not isinstance(tp.tokenizer, NativeBPE):
        raise AssertionError("TextProcessor did not take the C++ encoder")
    t0 = time.perf_counter()
    fast = [tp.tokenizer.encode(ln) for ln in lines]
    t_native = time.perf_counter() - t0
    py = tp.tokenizer.py
    py._cache.clear()
    t0 = time.perf_counter()
    slow = [py.encode(ln) for ln in lines]
    t_py = time.perf_counter() - t0
    if fast != slow:
        raise AssertionError("the C++ BPE encode differs from the Python "
                             "one")
    return t_py, t_native, len(lines)


def phase_itr1(card, checked, checked_xent, corpus):
    """Phase 28: a generated corpus through cli.create_mt_batches --packed
    -> cli.train_mt on the ITR1 file at its default model -> cli.translate;
    the batches of the ITR1 file against those of the marshal file;
    cli.create_batches --packed -> cli.train_lm; where Pillow is installed,
    cli.binarize_captions_from_list --packed -> CaptionTrainer steps; the
    native libraries and the host times. Returns (K1 fwd, K1 bwd, K2)
    launches."""
    import importlib.util

    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import create_batches, create_mt_batches
    from imagetranslate_tpu_torch.cli import train_lm, train_mt, translate
    from imagetranslate_tpu_torch.data.binarize import load_mt
    from imagetranslate_tpu_torch.data.loader import DocBlockDataset, MTBatcher
    from imagetranslate_tpu_torch.data.recordio import PackedReader, is_packed
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    t_start = time.perf_counter()
    decoder = phase_host_native()
    steps = 4
    fwd = bwd = k2 = 0
    with tempfile.TemporaryDirectory() as workdir, Recorder() as rec:
        tok, src, dst, lines = prepare_itr1_corpus(workdir)
        tp = TextProcessor(tok)
        args = ["--tok", tok, "--src", src, "--src-lang", "en", "--dst", dst,
                "--dst-lang", "fa"]
        itr1, marsh = (os.path.join(workdir, n) for n in ("t.itr1", "t.mt"))
        create_mt_batches.main(args + ["--output", itr1, "--packed"])
        create_mt_batches.main(args + ["--output", marsh])
        reader = PackedReader(itr1)
        if not (is_packed(itr1) and reader.native):
            raise AssertionError("create_mt_batches --packed did not write "
                                 "ITR1 through librecordio")
        kw = dict(pad_id=tp.pad_token_id(), max_batch=CLI_BATCH // 2,
                  capacity_mb=CLI_CAPACITY // 2)
        from_itr1 = MTBatcher.from_packed(reader, **kw)
        _same_batches("ITR1 vs marshal", from_itr1.batches,
                      MTBatcher(load_mt(marsh), **kw).batches,
                      ("src", "src_mask", "dst", "dst_mask", "src_langs",
                       "dst_langs", "src_sizes", "row_mask"))
        model = os.path.join(workdir, "model")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        tkp.LAUNCHES = 0
        train_mt.main(["--tok", tok, "--model", model, "--train_mt", itr1,
                       "--step", str(steps), "--lr", "0.001", "--warmup",
                       "10", "--device", "cuda"])
        fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        if not (fwd == bwd == 18 * steps):
            raise AssertionError(f"train_mt on ITR1: {fwd} + {bwd} K1 "
                                 f"launches in {steps} steps, want 18 + 18 "
                                 "a step")
        inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
        with open(inp, "w") as f:
            f.write("\n".join(lines[:40]) + "\n")
        translate.main(["--tok", tok, "--model", model + ".latest",
                        "--input", inp, "--output", out, "--src", "en",
                        "--target", "fa", "--device", "cuda"])
        k2 = tkp.LAUNCHES
        with open(out) as f:
            hyps = f.read().splitlines()
        if len(hyps) != 40 or k2 == 0:
            raise AssertionError(f"translate wrote {len(hyps)} lines with "
                                 f"{k2} K2 launches")
        log(f"[itr1] cli.create_mt_batches --packed: {len(reader)} pairs, "
            f"{len(from_itr1)} batches from pack_padded equal to the marshal "
            f"file's; cli.train_mt on the ITR1 file (768/12/3072, 6+6): "
            f"{steps} steps, K1 {fwd} + {bwd}; cli.translate of 40 lines, "
            f"{k2} K2 launches, e.g. {hyps[0]!r} ({card})")

        # The LM path on packed blocks (phase 15's documents and flags).
        _, _, doc_lines, _ = corpus
        docs = os.path.join(workdir, "docs.txt")
        with open(docs, "w") as f:
            for i in range(0, len(doc_lines), 12):
                lang = "en" if (i // 12) % 2 == 0 else "fa"
                f.write(f"<{lang}> " + " </s> ".join(doc_lines[i:i + 12])
                        + " </s>\n")
        lm_tok = corpus[0]
        blocks = {}
        for packed in (True, False):
            blocks[packed] = os.path.join(workdir, f"blocks_{packed}")
            create_batches.main(["--data", docs, "--cache", blocks[packed],
                                 "--tok", lm_tok, "--seq_len", "128",
                                 "--block", "16"]
                                + (["--packed"] if packed else []))
        got, want = (DocBlockDataset(blocks[p]) for p in (True, False))
        if not is_packed(os.path.join(blocks[True], "0.pkl")) or \
                [got[i] for i in range(len(got))] != \
                [want[i] for i in range(len(want))] or len(got) < 16:
            raise AssertionError("create_batches --packed: the ITR1 blocks "
                                 "differ from the marshal ones")
        lm_f0, lm_b0 = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        train_lm.main(["--tok", lm_tok, "--model",
                       os.path.join(workdir, "lm"), "--train",
                       blocks[True], "--step", "2", "--batch", "8", "--lr",
                       "0.001", "--warmup", "10", "--device", "cuda"])
        lm_f, lm_b = ta.FWD_LAUNCHES - lm_f0, ta.BWD_LAUNCHES - lm_b0
        fwd, bwd = fwd + lm_f, bwd + lm_b
        log(f"[itr1] cli.create_batches --packed: {len(got)} rows of 128 in "
            f"{got.file_count} ITR1 blocks, equal to the marshal blocks; "
            f"cli.train_lm: 2 steps, K1 {lm_f} + {lm_b} ({card})")

        # Captions, where Pillow can write the JPEGs.
        if importlib.util.find_spec("PIL") is None:
            log("[itr1] captions not run: Pillow is not installed")
        else:
            from imagetranslate_tpu_torch.cli import (
                binarize_captions_from_list,
            )
            from imagetranslate_tpu_torch.data.images import (
                CaptionBatcher,
                load_caption_bin,
            )
            from imagetranslate_tpu_torch.train.trainer_caption import (
                CaptionTrainer,
            )

            folder = os.path.join(workdir, "jpegs")
            write_jpegs(folder, 24)
            tsv = os.path.join(workdir, "caps.tsv")
            with open(tsv, "w") as f:
                for i in range(48):
                    f.write(f"{folder}/{i % 24:04d}.jpg\t{lines[i]}\n")
            bins = {}
            for packed in (True, False):
                bins[packed] = os.path.join(workdir, f"caps_{packed}.bin")
                binarize_captions_from_list.main(
                    ["--file", tsv, "--output", bins[packed], "--tok", tok,
                     "--lang", "en"] + (["--packed"] if packed else []))
            if not is_packed(bins[True]) or \
                    load_caption_bin(bins[True]) != load_caption_bin(
                        bins[False]):
                raise AssertionError("binarize_captions_from_list --packed "
                                     "differs from the marshal binary")
            cap_cfg = caption_train_config(tp.vocab_size())
            trainer = CaptionTrainer(cap_cfg, tp, lr=1e-4, warmup=10,
                                     seed=SEED, device="cuda")
            cap_f0, cap_b0 = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
            batcher = CaptionBatcher(bins[True], tp)
            step = trainer.train_epoch(0, os.path.join(workdir, "cap"),
                                       batcher, max_step=2,
                                       eval_every=10 ** 9,
                                       save_every=10 ** 9)
            cap_f = ta.FWD_LAUNCHES - cap_f0
            cap_b = ta.BWD_LAUNCHES - cap_b0
            if step != 2 or cap_f != cap_b or cap_f == 0:
                raise AssertionError(f"CaptionTrainer on the packed binary: "
                                     f"{step} steps, K1 {cap_f} + {cap_b}")
            fwd, bwd = fwd + cap_f, bwd + cap_b
            log(f"[itr1] cli.binarize_captions_from_list --packed: 48 "
                f"captions of 24 JPEGs (decoded by {decoder}), equal to the "
                f"marshal binary; CaptionTrainer (768/12/3072, 6+6, "
                f"ResNet-18 at 224): 2 steps on {len(batcher)} batches, K1 "
                f"{cap_f} + {cap_b} ({card})")
            del trainer
            torch.cuda.empty_cache()
        # Mostly words never seen before, so that neither encoder's word
        # cache decides the time.
        rng = np.random.RandomState(SEED)
        letters = np.array(list("abcdefghiklmnoprstuvwyz"))
        text = [" ".join("".join(rng.choice(letters, rng.randint(3, 10)))
                         for _ in range(12)) for _ in range(5000)]
        bpe_times = time_host_bpe(tp, text)
    hold_k1("itr1", rec.k1, checked)
    if rec.k5 - checked_xent:
        raise AssertionError(f"itr1 gave K5 unchecked shapes "
                             f"{rec.k5 - checked_xent}")
    t_list, t_packed, n_batches, n_examples = time_host_itr1()
    t_py, t_native, n_lines = bpe_times
    log(f"[itr1] host numbers ({cpu_name()}; card {card}): batching "
        f"{n_examples} pairs into {n_batches} batches: list batcher over the "
        f"marshal file {t_list:.3f} s, from_packed over ITR1 (pack_padded) "
        f"{t_packed:.3f} s ({t_list / t_packed:.1f}x); BPE encode of "
        f"{n_lines} lines: Python {t_py:.3f} s, C++ {t_native:.3f} s "
        f"({t_py / t_native:.1f}x); phase 28 took "
        f"{time.perf_counter() - t_start:.1f} s")
    return fwd, bwd, k2


def phase_recipe(card, checked):
    """Phase 29: cli.recipe_check at its default steps and floors on a
    generated sample corpus (make_sample_corpus), where sacrebleu and
    Pillow are installed; its ledger in the temporary workdir. Returns (K1
    fwd, K1 bwd, K2) launches."""
    import importlib.util

    from imagetranslate_tpu_torch.cli import recipe_check
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta

    missing = [m for m in ("sacrebleu", "PIL")
               if importlib.util.find_spec(m) is None]
    if missing:
        log(f"[recipe] not run: {', '.join(missing)} not installed on this "
            "host (cli.recipe_check scores BLEU with sacrebleu and writes "
            "its caption JPEGs with Pillow)")
        return 0, 0, 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        sample = os.path.join(workdir, "sample")
        recipe_check.make_sample_corpus(sample)
        ledger = os.path.join(workdir, "RECIPES.md")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        tkp.LAUNCHES = 0
        with Recorder() as rec:
            rc = recipe_check.main(["--sample-dir", sample, "--workdir",
                                    os.path.join(workdir, "work"),
                                    "--ledger", ledger, "--device", "cuda"])
        fwd, bwd, k2 = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, tkp.LAUNCHES
        with open(ledger) as f:
            rows = f.read().strip()
    if rc != 0:
        raise AssertionError(f"cli.recipe_check exited {rc}:\n{rows}")
    hold_k1("recipe", rec.k1, checked)
    log(f"[recipe] cli.recipe_check at its defaults (400 supervised, 60 MASS"
        f", 30 BT, 40 caption steps) in {time.perf_counter() - t0:.1f} s, "
        f"K1 {fwd} + {bwd}, K2 {k2} launches; ledger: "
        + " | ".join(rows.splitlines()) + f" ({card})")
    return fwd, bwd, k2


# ---------------- phase 30: module 14b ----------------

P30 = (256, 64, 64)        # B, S, T of the phase's steps: phase 7's shape
P30_MICRO = 4              # GPipe microbatches
P30_OPT = dict(lr=1e-3, warmup=1)   # Adam moves each weight ~lr a step
ZERO_TOL = 1e-5            # --zero against not, fp32: largest parameter
#                            difference over the largest value (the clip
#                            norm's order only; bf16 turns such a difference
#                            into lr-sized steps within a step or two)
PARITY_TOL = 1e-4          # fp32 mesh steps against one process: loss rtol,
#                            largest parameter difference / largest value
ROUTER_TOL = 1e-6          # a router and its moments across a model
#                            group, over their largest value: equal but for
#                            rounding (each rank's cuBLAS picks its own
#                            algorithm: 1.9e-9 absolute at 1x2 in a check)
P30_CLI_STEPS = 2


def p30_shapes():
    """K1 (B, T, S, H, D) and K5 (N, V) of phase 30's bf16 steps, held by
    phases 6 and 9 before the run: ZeRO at 2x1 (128 rows a rank) and 2x2
    (128 rows, 6 heads a rank), the GPipe microbatches (64 rows), the EP step
    at 1x2 (256 rows, 6 heads); K5 at 2x1 (128 rows) and on the last stage
    (the whole batch)."""
    B, S, T = P30
    k1 = set()
    for rows, heads in ((B // 2, 12), (B // 2, 6), (B // P30_MICRO, 12),
                        (B, 6)):
        k1 |= {(rows, S, S, heads, 64), (rows, T - 1, T - 1, heads, 64),
               (rows, T - 1, S, heads, 64)}
    return sorted(k1), [(B // 2 * (T - 1), 32000), (B * (T - 1), 32000)]


def card_params(cfg, seed, device):
    """A flax-layout parameter tree (CPU tensors) drawn on the card from
    ``seed`` with the JAX initializers that ``weights.random_params`` draws
    with numpy (normal(initializer_range) for kernels, embeddings, routers
    and experts; zero biases; unit LayerNorm scales): every process on the
    card draws the same, in a fraction of numpy's ~10 s at MoE width."""
    import torch

    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.train.weights import flax_from_state_dict

    model = Seq2Seq(cfg, device=device, param_dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith(("LayerNorm.weight", "ln.weight")):
                v.fill_(1.0)
            elif k.endswith((".bias", "moe.bi", "moe.bo")):
                v.zero_()
            else:
                v.normal_(0.0, cfg.initializer_range, generator=gen)
    return flax_from_state_dict(sd, cfg)


def _share(got, want) -> float:
    """Largest |got - want| over the largest |want|, over two state
    dicts."""
    diff = max(float((got[k].float() - want[k].float()).abs().max())
               for k in want)
    return diff / max(float(want[k].float().abs().max()) for k in want)


def z14b_rank(rank, workdir, cli_argvs):
    """One of phase 30's four ranks, all on the one card over gloo. Ranks 0
    and 1: ZeRO-1 at 2x1 (and bf16 steps with it), GPipe at 1x2 (fp32
    parity, the bf16 launch counts with and without remat, the dev decode
    of the gathered model), EP at 1x2 (fp32 parity, a bf16 step, the MoE
    beam decode); then the four: ZeRO-1 at 2x2, GPipe at 1x4, EP at 2x2, and
    ``cli_argvs`` through cli.train_mt. Rank 0 runs each parity run's
    one-process reference. Returns a dict of readings ("pair" on ranks 0
    and 1, "quad" on all)."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.decoding.beam import beam_search
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.parallel.comm import all_gather_stack
    from imagetranslate_tpu_torch.parallel.mesh import (
        ProcessMesh,
        make_mesh,
        shard_batch_safe,
        shard_params,
    )
    from imagetranslate_tpu_torch.train.optimizer import map_moments
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
    from imagetranslate_tpu_torch.train.weights import state_dict_from_flax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    B, S, T = P30
    dense = bert_base(32000)
    moe_cfg = dataclasses.replace(dense, **MOE)
    batches = train_batches(dense, 3, B, S, T, dev)
    params = {}
    out = {"where": f"{dist.get_backend()} on {dev}", "seconds": {}}
    t_part = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        out["seconds"][name] = round(now - t_part[0], 1)
        t_part[0] = now

    def tree(cfg):
        key = cfg.moe_experts
        if key not in params:
            params[key] = card_params(dataclasses.replace(
                cfg, dtype="float32"), SEED, dev)
        return params[key]

    def trainer(cfg, mesh, **kw):
        return MTTrainer(cfg, FullVocab(), params=tree(cfg), mesh=mesh,
                         seed=SEED, device=dev, **P30_OPT, **kw)

    def steps(tr, mesh, n):
        losses = []
        for i in range(n):
            b = batches[i % len(batches)]
            tr.state, m = tr.mt_step(
                tr.state, b if mesh is None else shard_batch_safe(b, mesh),
                torch.Generator().manual_seed(i))
            losses.append(float(m["sum_loss"] / m["ntokens"]))
        return losses

    def reset():
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
        tkp.LAUNCHES = tkp.MERGE_LAUNCHES = da.LAUNCHES = 0

    def counts():
        return (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
                xent.BWD_LAUNCHES)

    def opt_bytes(tr):
        total = []
        map_moments(tr.state.opt_state, lambda d: total.append(sum(
            t.numel() * t.element_size() for t in d.values())) or d)
        return sum(total)

    def reference(cfg, n, losses, full):
        """Rank 0: the one-process steps from the same weights; (largest
        relative loss difference, largest parameter difference over the
        largest value, the one-process losses)."""
        if rank != 0:
            return None
        one = trainer(cfg, None)
        ref = steps(one, None, n)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        share = _share(full, one.model.state_dict())
        del one
        torch.cuda.empty_cache()
        return rel, share, ref

    def zero_part(mesh, res, with_bf16):
        """Two fp32 steps with and without --zero from one seed under
        deterministic algorithms; then, ``with_bf16``, three bf16 steps at
        dropout 0.1 with it (K1, and K5 without a split vocab)."""
        arms = [("off", dataclasses.replace(dense, dtype="float32")),
                ("zero", dataclasses.replace(dense, dtype="float32"))]
        if with_bf16:
            arms.append(("bf16", dataclasses.replace(
                dense, dropout=RATE, attention_dropout=RATE,
                use_pallas_xent=True)))
        runs = {}
        for arm, cfg in arms:
            was = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(arm != "bf16", warn_only=True)
            try:
                tr = trainer(cfg, mesh, zero=arm != "off")
                reset()
                with Recorder() as rec:
                    # fp32: two steps show the order of the clip norm's
                    # sums; bf16: three, for the launches.
                    losses = steps(tr, mesh, 3 if arm == "bf16" else 2)
                split = 0 if tr.zero is None else sum(
                    p.numel() * p.element_size()
                    for k, p in tr.state.params.items() if tr.zero.split(k))
                runs[arm] = (losses, None if arm == "bf16" else tr._full(
                    tr.model.state_dict()), opt_bytes(tr), split, counts(),
                    rec.k1, rec.k5)
                del tr
                torch.cuda.empty_cache()
            finally:
                torch.use_deterministic_algorithms(was)
        off, on = runs["off"], runs["zero"]
        bf16 = runs.get("bf16", ([], None, 0, 0, (0, 0, 0, 0), set(), set()))
        res["zero"] = {
            "mesh": (mesh.n_data, mesh.n_model),
            "losses": (off[0], on[0], bf16[0]),
            "share": _share(on[1], off[1]), "bytes": (off[2], on[2]),
            "split": on[3], "counts": bf16[4], "k1": bf16[5], "k5": bf16[6]}
        mark(f"zero {mesh.n_data}x{mesh.n_model}")

    def pp_part(mesh, res):
        """Two fp32 GPipe steps at dropout 0 (M microbatches) against one
        process."""
        cfg = dataclasses.replace(dense, dtype="float32")
        tr = trainer(cfg, mesh, pp_microbatches=P30_MICRO)
        losses = steps(tr, mesh, 2)
        own = sorted({".".join(k.split(".")[:4])
                      for k in tr.model.layer_names()})
        full = tr._full(None)
        del tr
        torch.cuda.empty_cache()
        res["pp"] = {"losses": losses, "own": own,
                     "ref": reference(cfg, 2, losses, full)}
        mark(f"pp 1x{mesh.n_model}")

    def pp_extra(mesh, res):
        """GPipe's launches: one bf16 step at dropout 0.1, then one under
        remat; the fused beam decode of the gathered model."""
        pp_counts = {}
        for remat in (False, True):
            cfg = dataclasses.replace(
                dense, dropout=RATE, attention_dropout=RATE,
                use_pallas_xent=True, remat=remat,
                decode_attention_impl="fused")
            tr = trainer(cfg, mesh, pp_microbatches=P30_MICRO)
            reset()
            with Recorder() as rec:
                loss = steps(tr, mesh, 1)
            pp_counts[remat] = (counts(), rec.k1, rec.k5, loss)
            if not remat:
                Bd, Sd, K, _ = MT_DECODE
                src = np.random.RandomState(SEED).randint(5, 32000, (Bd, Sd))
                model = tr.decode_model()
                n_steps = 0
                step = model.decode_step

                def counted(*a, **kw):
                    nonlocal n_steps
                    n_steps += 1
                    return step(*a, **kw)

                model.decode_step = counted
                reset()
                with recording_decode_attention() as seen4:
                    best, lengths = tr._decode_batch(
                        src, src != 0, np.zeros(Bd, np.int32),
                        np.full(Bd, 6, np.int32), np.ones(Bd, np.int32),
                        np.full(Bd, Sd, np.int32), beam_width=K)
                res["pp_decode"] = (n_steps, tkp.LAUNCHES, da.LAUNCHES,
                                    seen4, int(lengths.sum()))
                del model
            del tr
            torch.cuda.empty_cache()
        res["pp_counts"] = pp_counts
        mark("pp extra")

    def ep_part(mesh, res):
        """Two fp32 steps of the MoE model, its experts split, at dropout
        0 against one process; the routers' spread across the model
        group."""
        cfg = dataclasses.replace(moe_cfg, dtype="float32")
        tr = trainer(cfg, mesh)
        losses = steps(tr, mesh, 2)
        opt = tr.state.opt_state
        spread = 0.0    # across the model group, over each tensor's largest
        for k, p in tr.state.params.items():
            if k.endswith("moe.router.weight"):
                for t in (p.detach(), opt.mu[k], opt.nu[k]):
                    g = all_gather_stack(t, mesh.model_group)
                    spread = max(spread, float((g - g[0]).abs().max())
                                 / float(g.abs().max()))
        experts = tr.state.params["encoder.encoder.layer.0.moe.wi"].shape[0]
        full = tr._full(tr.model.state_dict())
        del tr, opt
        torch.cuda.empty_cache()
        res["ep"] = {"mesh": (mesh.n_data, mesh.n_model), "losses": losses,
                     "router_spread": spread, "experts": experts,
                     "ref": reference(cfg, 2, losses, full)}
        mark(f"ep {mesh.n_data}x{mesh.n_model}")

    def ep_extra(mesh, res):
        """A bf16 MoE step at dropout 0.1 (K1); phase 4's beam decode of the
        MoE model through K2b and K4, scored against one process."""
        cfg = dataclasses.replace(moe_cfg, dropout=RATE,
                                  attention_dropout=RATE)
        tr = trainer(cfg, mesh)
        reset()
        with Recorder() as rec:
            loss = steps(tr, mesh, 1)
        res["ep_counts"] = (counts(), rec.k1, rec.k5, loss)
        del tr
        torch.cuda.empty_cache()
        serve_cfg = dataclasses.replace(moe_cfg,
                                        decode_attention_impl="fused")
        full = state_dict_from_flax(tree(moe_cfg), serve_cfg)
        model = Seq2Seq(serve_cfg, device=dev)
        model.load_state_dict(shard_params(full, mesh, model.shard_(mesh)))
        model.eval()
        Bd, Sd, K, L = MT_DECODE
        src = torch.as_tensor(np.random.RandomState(SEED).randint(
            5, 32000, (Bd, Sd))).to(dev)
        mask = torch.ones_like(src, dtype=torch.bool)
        n_steps = 0
        step = model.decode_step

        def counted(*a, **kw):
            nonlocal n_steps
            n_steps += 1
            return step(*a, **kw)

        model.decode_step = counted
        reset()
        with recording_decode_attention() as seen4, torch.no_grad():
            enc = model.encode(src, mask, torch.zeros(
                (Bd,), dtype=torch.int32, device=dev))
            best, _ = beam_search(
                model, enc, mask,
                torch.full((Bd,), 6, dtype=torch.int32, device=dev),
                torch.ones((Bd,), dtype=torch.int32, device=dev),
                torch.full((Bd,), Sd, dtype=torch.int32, device=dev),
                beam_width=K, max_len=max_len_for_decode(Sd),
                len_penalty_ratio=0.8, pad_id=dense.pad_id, eos_id=-1)
        decode = (n_steps, tkp.LAUNCHES, tkp.MERGE_LAUNCHES, da.LAUNCHES,
                  seen4)
        del model, enc
        torch.cuda.empty_cache()
        if rank == 0:
            # The one-process decode, and both decodes' sequence scores
            # under the one-process model.
            one = Seq2Seq(serve_cfg, device=dev)
            one.load_state_dict(full)
            one.eval()
            best_one, _, _, _ = run_decode(one, Bd, Sd, K, dev)
            s_one = sequence_scores(one, src, best_one)
            s_ep = sequence_scores(one, src, best)
            rel = float(((s_ep - s_one).abs() / s_one.abs()).max())
            same = float((best == best_one).float().mean())
            decode += (rel, same)
            del one
        res["ep_decode"] = decode
        del full
        torch.cuda.empty_cache()
        mark("ep extra")

    # Ranks 0 and 1 first, as 2x1 and 1x2 meshes of their own (JAX's
    # make_mesh over the first D x M devices), while 2 and 3 wait; then
    # the four.
    pair_group = dist.new_group([0, 1])       # collective: every rank
    if rank < 2:
        pair = out["pair"] = {}
        zero_part(ProcessMesh(2, 1, rank, 0, None, pair_group, dev), pair,
                  with_bf16=True)
        pipe = ProcessMesh(1, 2, 0, rank, pair_group, None, dev)
        pp_part(pipe, pair)
        pp_extra(pipe, pair)
        ep_part(pipe, pair)
        ep_extra(pipe, pair)
    dist.barrier()
    quad = out["quad"] = {}
    zero_part(make_mesh(2, 2, device="cuda"), quad, with_bf16=False)
    pp_part(make_mesh(1, 4, device="cuda"), quad)
    ep_part(make_mesh(2, 2, device="cuda"), quad)

    # ---- the CLI ----
    cli = []
    for argv in cli_argvs:
        reset()
        text = io.StringIO()
        with Recorder() as rec, contextlib.redirect_stdout(text):
            train_main(argv)
        cli.append((counts(), tkp.LAUNCHES, rec.k1, rec.k5, text.getvalue()))
        torch.cuda.empty_cache()
    quad["cli"] = cli
    mark("cli")
    return out


def phase_14b(card, checked, checked_xent, checked_k4):
    """Phase 30: ZeRO-1, the GPipe pipeline and expert parallelism
    (module 14b parts 1-3) at BERT-base width (V=32000, 6+3 layers, B=256,
    S=T=64, fp32 masters) on ranks that share the card over gloo:
    correctness only, no speed is read. One spawn of four ranks; the 2x1
    and 1x2 meshes on ranks 0 and 1. ZeRO-1 at 2x1 and 2x2: two fp32
    steps with and without --zero from one seed under torch's deterministic
    algorithms (largest parameter difference within ZERO_TOL of the largest
    value), each rank's optimizer state smaller by (1 - 1/D) of its split
    tensors'; then three bf16 steps at dropout 0.1 with the fused
    cross-entropy under --zero (K1, K5). GPipe (M=4) at 1x2 and 1x4 (its
    last stage holds no decoder layer): two fp32 steps at dropout 0 against
    one process (PARITY_TOL); at 1x2 one bf16 step at dropout 0.1 (K1 12 M
    + 12 M summed over the stages, 24 M forwards under remat; K5 1 + 1) and
    a beam decode of the gathered model (K2 and, "fused", K4 every step).
    EP (8 experts, top-2) at 1x2 and 2x2: two fp32 steps against one
    process, the router and its moments equal across each model group
    (ROUTER_TOL); at 1x2 a bf16 step at dropout 0.1 (K1) and phase 4's beam
    decode of the MoE model (K2b and K4 every step, sequence scores within
    DECODE_SCORE_RTOL of the one-process decode). Then, in the four ranks,
    cli.train_mt --mesh 2x2 --zero, --mesh 1x4 --pp-microbatches 4 and
    --mesh 2x2 --moe-experts 4 for a few steps, and cli.translate on the
    pipelined run's checkpoint in this process. Returns (K1 fwd, K1 bwd, K5
    fwd, K5 bwd, K2, K2b merges, K4) launches."""
    import numpy as np
    import torch

    from imagetranslate_tpu_torch.cli import create_mt_batches
    from imagetranslate_tpu_torch.cli import train_tokenizer
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.parallel.spawn import run_ranks

    per = 6 + 2 * 3                 # K1 calls a forward: 6 enc + 3 dec x 2
    k1_seen, k5_seen, k4_seen = set(), set(), set()
    totals = [0] * 7

    def add(c):
        for i, x in enumerate(c):
            totals[i] += x

    with tempfile.TemporaryDirectory() as workdir:
        rng = np.random.RandomState(SEED + 30)
        lines = [" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 12))) for _ in range(200)]
        paths = {n: os.path.join(workdir, n) for n in (
            "src.txt", "dst.txt", "tagged.txt", "tok", "train.mt", "in.txt",
            "out.txt", "store", "zero", "pp", "moe")}
        for name, rows in (("src.txt", lines), ("in.txt", lines[:50]),
                           ("dst.txt", [" ".join(reversed(ln.split()))
                                        for ln in lines])):
            with open(paths[name], "w") as f:
                f.write("\n".join(rows) + "\n")
        with open(paths["tagged.txt"], "w") as f:
            f.write("\n".join(f"<en> {ln} </s>" for ln in lines) + "\n")
            f.write("<fa> " + lines[0] + " </s>\n")
        train_tokenizer.main(["--data", paths["tagged.txt"], "--vocab_size",
                              "300", "--model", paths["tok"]])
        create_mt_batches.main(["--tok", paths["tok"], "--src",
                                paths["src.txt"], "--src-lang", "en", "--dst",
                                paths["dst.txt"], "--dst-lang", "fa",
                                "--output", paths["train.mt"]])
        # The CLIs at phase 26's width, two layers a stack: a stage of the
        # 1x4 pipeline holds one layer of a stack or none.
        common = ["--tok", paths["tok"], "--train_mt", paths["train.mt"],
                  "--enc", "2", "--dec", "2", "--step", str(P30_CLI_STEPS),
                  "--batch", "2000", "--lr", "0.001", "--warmup", "10",
                  "--device", "cuda"]
        cli_argvs = [
            ["--mesh", "2x2", "--zero", "--model", paths["zero"], *common],
            ["--mesh", "1x4", "--pp-microbatches", "4", "--model",
             paths["pp"], *common],
            ["--mesh", "2x2", "--moe-experts", "4", "--model", paths["moe"],
             *common]]
        t0 = time.perf_counter()
        got = run_ranks(z14b_rank, 4, paths["store"], (workdir, cli_argvs),
                        device="cuda", timeout=900)
        t_ranks = time.perf_counter() - t0
        pair = [r["pair"] for r in got[:2]]
        quad = [r["quad"] for r in got]

        # -- ZeRO-1 --
        for ranks in (pair, quad):
            for r, res in enumerate(ranks):
                z = res["zero"]
                n_data = z["mesh"][0]
                want = z["bytes"][0] - 2 * z["split"] * (n_data - 1) // n_data
                if not (z["share"] <= ZERO_TOL and z["bytes"][1] == want
                        and z["split"] > 0 and all(np.isfinite(
                            x).all() for x in z["losses"])):
                    raise AssertionError(
                        f"zero {z['mesh']} rank {r}: parameters differ by "
                        f"{z['share']:.3g} of the largest (limit "
                        f"{ZERO_TOL:.0e}); optimizer state {z['bytes']} B, "
                        f"want {want} with --zero; losses {z['losses']}")
                add(z["counts"] + (0, 0, 0))
                k1_seen |= z["k1"]
                k5_seen |= z["k5"]
            z = ranks[0]["zero"]
            log(f"[14b zero] {z['mesh'][0]}x{z['mesh'][1]}: 2 fp32 steps "
                f"with and without --zero under deterministic algorithms: "
                f"losses {z['losses'][0]} and {z['losses'][1]}; largest "
                f"parameter difference "
                f"{max(r['zero']['share'] for r in ranks):.3g} of the "
                f"largest value (limit {ZERO_TOL:.0e}); rank 0's optimizer "
                f"state {z['bytes'][0] / 2**20:.1f} -> "
                f"{z['bytes'][1] / 2**20:.1f} MiB (its split tensors "
                f"{z['split'] / 2**20:.1f} MiB, moments x2, over D="
                f"{z['mesh'][0]}) ({card})")
        z = pair[0]["zero"]
        fwd = sum(r["zero"]["counts"][0] for r in pair)
        if fwd != per * 3 * 2 or z["counts"][2] != 3:
            raise AssertionError(f"zero 2x1 bf16: K1 {fwd} forwards over "
                                 f"the ranks, K5 {z['counts']}")
        log(f"[14b zero] 2x1, 3 bf16 steps at dropout 0.1 under --zero: "
            f"losses {z['losses'][2]}, K1 {fwd} + "
            f"{sum(r['zero']['counts'][1] for r in pair)} over the ranks, "
            f"K5 {z['counts'][2]} + {z['counts'][3]} on rank 0 ({card})")

        # -- GPipe --
        for ranks in (pair, quad):
            res = ranks[0]["pp"]
            rel, share, ref = res["ref"]
            enc = [o for r in ranks for o in r["pp"]["own"]
                   if o.startswith("encoder")]
            dec = [o for r in ranks for o in r["pp"]["own"]
                   if o.startswith("decoder")]
            if not (rel <= PARITY_TOL and share <= PARITY_TOL
                    and len(enc) == len(set(enc)) == 6
                    and len(dec) == len(set(dec)) == 3):
                raise AssertionError(
                    f"pp 1x{len(ranks)}: losses {res['losses']} against "
                    f"{ref} (rel {rel:.3g}), parameters {share:.3g} of the "
                    f"largest (limit {PARITY_TOL:.0e}); stage layers {enc} "
                    f"{dec}")
            log(f"[14b pp] 1x{len(ranks)}, M={P30_MICRO}, fp32 at dropout "
                f"0: losses {res['losses']} against one process {ref} (rel "
                f"{rel:.2e}); merged parameters within {share:.2e} of the "
                f"largest value (limit {PARITY_TOL:.0e}); stage layers "
                f"{[r['pp']['own'] for r in ranks]} ({card})")
        for remat, want_fwd in ((False, per * P30_MICRO),
                                (True, 2 * per * P30_MICRO)):
            c = [r["pp_counts"][remat][0] for r in pair]
            got_c = tuple(sum(x[i] for x in c) for i in range(4))
            if got_c != (want_fwd, per * P30_MICRO, 1, 1):
                raise AssertionError(
                    f"pp 1x2 {'remat' if remat else 'step'}: (K1 fwd, K1 "
                    f"bwd, K5 fwd, K5 bwd) over the stages {got_c}, want "
                    f"({want_fwd}, {per * P30_MICRO}, 1, 1)")
            for r in pair:
                add(r["pp_counts"][remat][0] + (0, 0, 0))
                k1_seen |= r["pp_counts"][remat][1]
                k5_seen |= r["pp_counts"][remat][2]
            log(f"[14b pp] 1x2 bf16 step at dropout 0.1"
                f"{' under remat' if remat else ''}: K1 {got_c[0]} + "
                f"{got_c[1]} over the stages ({per} + {per} a microbatch, "
                f"M={P30_MICRO}), K5 {got_c[2]} + {got_c[3]}; loss "
                f"{pair[0]['pp_counts'][remat][3]} ({card})")
        for r, res in enumerate(pair):
            n_steps, k2_n, k4_n, seen4, tokens = res["pp_decode"]
            if not (n_steps > 0 and k2_n == n_steps and k4_n == 3 * n_steps):
                raise AssertionError(
                    f"pp decode rank {r}: {n_steps} steps, K2 {k2_n}, K4 "
                    f"{k4_n}")
            k4_seen |= seen4
            add((0, 0, 0, 0, k2_n, 0, k4_n))
        log(f"[14b pp] the dev decode of the gathered model on each stage "
            f"(B={MT_DECODE[0]}, beam {MT_DECODE[2]}, fused): "
            f"{pair[0]['pp_decode'][0]} steps, K2 and 3 K4 launches a step; "
            f"{pair[0]['pp_decode'][4]} tokens ({card})")

        # -- EP --
        for ranks in (pair, quad):
            res = ranks[0]["ep"]
            rel, share, ref = res["ref"]
            spread = max(r["ep"]["router_spread"] for r in ranks)
            if not (rel <= PARITY_TOL and share <= PARITY_TOL
                    and spread <= ROUTER_TOL and res["experts"] == 4):
                raise AssertionError(
                    f"ep {res['mesh']}: losses {res['losses']} against {ref} "
                    f"(rel {rel:.3g}), parameters {share:.3g} of the "
                    f"largest (limit {PARITY_TOL:.0e}), routers differ "
                    f"across a model group by {spread:.3g} of their "
                    f"largest (limit {ROUTER_TOL:.0e}), "
                    f"{res['experts']} experts a rank")
            log(f"[14b ep] {res['mesh'][0]}x{res['mesh'][1]}, 8 experts "
                f"top-2 (4 a rank), fp32 at dropout 0: losses "
                f"{res['losses']} against one process {ref} (rel "
                f"{rel:.2e}); parameters within {share:.2e} of the largest "
                f"value (limit {PARITY_TOL:.0e}); router weights and "
                f"moments across each model group within {spread:.2e} of "
                f"their largest value (limit {ROUTER_TOL:.0e}) ({card})")
        c = [r["ep_counts"][0] for r in pair]
        if sum(x[0] for x in c) != 2 * per or sum(x[1] for x in c) != 2 * per:
            raise AssertionError(f"ep 1x2 bf16 step: K1 {c}")
        for r in pair:
            add(r["ep_counts"][0] + (0, 0, 0))
            k1_seen |= r["ep_counts"][1]
        for r, res in enumerate(pair):
            n_steps, k2_n, merge_n, k4_n, seen4 = res["ep_decode"][:5]
            if not (n_steps > 0 and k2_n == merge_n == n_steps
                    and k4_n == 3 * n_steps):
                raise AssertionError(
                    f"ep decode rank {r}: {n_steps} steps, K2 {k2_n}, "
                    f"merges {merge_n}, K4 {k4_n}")
            k4_seen |= seen4
            add((0, 0, 0, 0, k2_n, merge_n, k4_n))
        n_steps, _, _, _, _, rel, same = pair[0]["ep_decode"]
        if rel > DECODE_SCORE_RTOL:
            raise AssertionError(f"ep decode: sequence scores differ from "
                                 f"the one-process decode by {rel:.3g}")
        log(f"[14b ep] 1x2 bf16 step at dropout 0.1: K1 "
            f"{sum(x[0] for x in c)} + {sum(x[1] for x in c)} over the "
            f"ranks; the MoE beam decode at 1x2 (bf16, fused; B="
            f"{MT_DECODE[0]} S={MT_DECODE[1]} beam {MT_DECODE[2]} L="
            f"{max_len_for_decode(MT_DECODE[1])}): {n_steps} steps, each "
            f"rank K2 on V/2, a merge and 3 K4 launches a step; tokens "
            f"{same:.4f} equal to the one-process decode's, sequence scores "
            f"within {rel:.2e} (limit {DECODE_SCORE_RTOL:.0e}) ({card})")
        log(f"[14b] four ranks in {t_ranks:.1f} s, over {got[0]['where']}; "
            f"seconds a part on rank 0: {got[0]['seconds']}")

        # -- the CLI --
        for i, name in enumerate(("--mesh 2x2 --zero",
                                  "--mesh 1x4 --pp-microbatches 4",
                                  "--mesh 2x2 --moe-experts 4")):
            fwd = sum(r["cli"][i][0][0] for r in quad)
            bwd = sum(r["cli"][i][0][1] for r in quad)
            text = quad[0]["cli"][i][4]
            losses = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                      if ln.startswith("Total loss in this epoch:")]
            if (not losses or not all(np.isfinite(losses)) or fwd == 0
                    or bwd == 0 or "Finished Training!" not in text):
                raise AssertionError(f"train_mt {name}: losses {losses}, K1 "
                                     f"{fwd} + {bwd}:\n{text[-2000:]}")
            for r in quad:
                add(r["cli"][i][0] + (r["cli"][i][1], 0, 0))
                k1_seen |= r["cli"][i][2]
                k5_seen |= r["cli"][i][3]
            log(f"[14b cli] cli.train_mt {name} (2+2 layers) in the four "
                f"ranks: {P30_CLI_STEPS} steps, epoch losses {losses}, K1 "
                f"{fwd} + {bwd} over the ranks ({card})")
        tkp.LAUNCHES = 0
        translate_main(["--tok", paths["tok"], "--model",
                        paths["pp"] + ".latest", "--input", paths["in.txt"],
                        "--output", paths["out.txt"], "--src", "en",
                        "--target", "fa", "--device", "cuda"])
        with open(paths["out.txt"]) as f:
            n_lines = len(f.read().splitlines())
        if n_lines != 50 or tkp.LAUNCHES == 0:
            raise AssertionError(f"translate of the pipelined checkpoint: "
                                 f"{n_lines} lines, K2 {tkp.LAUNCHES}")
        add((0, 0, 0, 0, tkp.LAUNCHES, 0, 0))
        log(f"[14b cli] cli.translate of the --pp-microbatches checkpoint "
            f"(weights and step) in one process: 50 lines, K2 "
            f"{tkp.LAUNCHES} launches ({card})")

    # Every shape the ranks gave the kernels was held against its plain
    # version: K1 here for those phase 6 did not take (the CLI's buckets),
    # K5 and K4 by phases 9 and 16.
    hold_k1("14b", k1_seen, checked)
    if k5_seen - checked_xent or k4_seen - checked_k4:
        raise AssertionError(f"14b: K5 shapes {sorted(k5_seen - checked_xent)}"
                             f" or K4 shapes {sorted(k4_seen - checked_k4)[:8]}"
                             " were not held against the plain version")
    torch.cuda.empty_cache()
    return tuple(totals)


# ---------------- phase 31: module 14b, parts 4-6 ----------------

P31_MLM = (16, 512)        # B, T of the MLM steps (phase 14's: the budget)
P31_LONG = (2, 4096)       # B, T of the long-document steps
P31_DEV = (8, 2048)        # rows, positions of the LM dev set (K3)
P31_OPT = dict(lr=1e-3, warmup=1)
P31_BT = (128, 64)         # rows, tokens of the back-translation batch
P31_CAPTION = (16, 5, 32)  # dev images, beam, L of the caption decode
P31_BN_TOL = 1e-4          # running statistics, mesh against one process,
#                            over the largest value (fp32, cuDNN picks its
#                            algorithm by batch: the ranks' halves and the
#                            whole batch convolve in other orders)
P31_LOGIT_TOL = 1e-4       # long-document logits, mesh against one process,
#                            over the largest value (fp32)
P31_CLI_STEPS = 2


def p31_shapes():
    """(K5 (N, V), K3 (B, T, S, H, D, bias), K4 (R, H, D, live)) of phase
    31, held by phases 9, 12 and 16 before the run: the image trainer's
    text MASS step at 2x1 (64 rows a rank, 32 span slots); the LM dev
    evaluation at 2x2 (4 rows and 6 heads a rank, 2048 positions); the
    caption dev decode at 2x1 (8 images a rank, beam 5, L=32) and the image
    trainer's back-translation decode at 2x1 (64 rows a rank, greedy, the
    MT trainer's L for 64 source tokens)."""
    from imagetranslate_tpu_torch.decoding.beam import max_len_for

    rows, S = P31_BT
    n_img, beam, L = P31_CAPTION
    L_bt = -(-max_len_for(S, 1.1, 5, 512) // 16) * 16
    k4 = [(n_img // 2 * beam, 12, 64, n) for n in range(1, L)]
    k4 += [(rows // 2, 12, 64, n) for n in range(1, L_bt)]
    B, T = P31_DEV
    return ([(rows // 2 * (S // 2), 32000)], [(B // 2, T, T, 6, 64, True)],
            k4)


def p31_host_lm(B: int, T: int, V: int, seed: int):
    """An MLM batch of numpy arrays: ids over the whole vocabulary with a
    skew, rows padded to lengths from T/2 up (some across a rank's run of
    positions), the last row padding."""
    import numpy as np

    rng = np.random.RandomState(seed)
    texts = (5 + (V - 5) * rng.rand(B, T) ** 3).astype(np.int32)
    lengths = rng.randint(T // 2, T + 1, B)
    texts = np.where(np.arange(T)[None, :] < lengths[:, None], texts,
                     0).astype(np.int32)
    row_mask = np.ones(B, bool)
    row_mask[-1] = False
    return {"texts": texts, "pad_mask": texts != 0,
            "langs": (np.arange(B) % 2).astype(np.int32),
            "row_mask": row_mask}


def p31_rank(rank, workdir, cli_argvs):
    """One of phase 31's four ranks, all on the one card over gloo. Ranks 0
    and 1: the MLM at 1x2, SenSim, Caption2Image, the caption step and its
    dev decode, and ImageMTTrainer under --zero, all at 2x1 or 1x2; then
    the four: the MLM at 2x2 with its dev evaluation at 2048 positions,
    the long-document LM at 1x4 and 2x2, and ``cli_argvs`` (module, argv)
    through the CLIs. Rank 0 runs each parity run's one-process reference.
    Returns a dict of readings ("pair" on ranks 0 and 1, "quad" on
    all)."""
    import contextlib
    import dataclasses
    import importlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from imagetranslate_tpu_torch.data.loader import DocBlockDataset
    from imagetranslate_tpu_torch.models.caption2image import Caption2Image
    from imagetranslate_tpu_torch.models.longdoc import longdoc_config
    from imagetranslate_tpu_torch.ops import decode_attention as da
    from imagetranslate_tpu_torch.ops import flash_attention as fa
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.parallel.mesh import (
        ProcessMesh,
        host_rows,
        make_mesh,
        shard_batch_safe,
        shard_params,
    )
    from imagetranslate_tpu_torch.train import step as pstep
    from imagetranslate_tpu_torch.train.optimizer import build_optimizer
    from imagetranslate_tpu_torch.train.trainer_caption import (
        CaptionTrainer,
        add_negatives,
    )
    from imagetranslate_tpu_torch.train.trainer_image_mt import (
        ImageMTTrainer,
    )
    from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer
    from imagetranslate_tpu_torch.train.trainer_longdoc import LongDocTrainer
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
    from imagetranslate_tpu_torch.train.trainer_sensim import SenSimTrainer
    from imagetranslate_tpu_torch.train.weights import (
        CAPTION,
        CAPTION2IMAGE,
        LM,
        LONGDOC,
        SENSIM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    V = 32000
    vocab = FullVocab()
    out = {"where": f"{dist.get_backend()} on {dev}", "seconds": {}}
    t_part = [time.perf_counter()]
    trees = {}

    def mark(name):
        now = time.perf_counter()
        out["seconds"][name] = round(now - t_part[0], 1)
        t_part[0] = now

    def tree(bridge, cfg):
        key = (bridge, cfg.hidden_size, cfg.enc_layers, cfg.dec_layers,
               cfg.max_position_embeddings)
        if key not in trees:
            trees[key] = bridge.random_params(cfg, SEED)
        return trees[key]

    def reset():
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        xent.FWD_LAUNCHES = xent.BWD_LAUNCHES = 0
        tkp.LAUNCHES = tkp.MERGE_LAUNCHES = da.LAUNCHES = fa.LAUNCHES = 0

    def counts():
        return (ta.FWD_LAUNCHES, ta.BWD_LAUNCHES, xent.FWD_LAUNCHES,
                xent.BWD_LAUNCHES, tkp.LAUNCHES, da.LAUNCHES, fa.LAUNCHES)

    def parity(losses, ref_losses, full, ref_full):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        return rel, _share(full, ref_full), ref_losses

    def lm_cfg(**kw):
        return dataclasses.replace(bert_base(V), **{
            "max_position_embeddings": P31_MLM[1], "dtype": "float32",
            **kw})

    # ---- the MLM: two fp32 steps at dropout 0, then a bf16 step ----
    B, T = P31_MLM
    lm_batches = [p31_host_lm(B, T, V, SEED + 31 + i) for i in range(2)]

    def lm_steps(tr, n):
        losses = []
        for i in range(n):
            tr.state, m = tr.step_fn(tr.state, tr.stage(lm_batches[i]),
                                     torch.Generator().manual_seed(i))
            losses.append(float(m["sum_loss"] / m["ntokens"]))
        return losses

    def mlm_part(mesh, res):
        cfg = lm_cfg()
        tr = LMTrainer(cfg, vocab, params=tree(LM, cfg), mesh=mesh,
                       seed=SEED, device=dev, **P31_OPT)
        losses = lm_steps(tr, 2)
        full = tr._full(tr.model.state_dict())
        vocab_split = tr.model.vocab_tp is not None
        del tr
        ref = None
        if rank == 0:
            one = LMTrainer(cfg, vocab, params=tree(LM, cfg), seed=SEED,
                            device=dev, **P31_OPT)
            ref = parity(losses, lm_steps(one, 2), full,
                         one.model.state_dict())
            del one
        del full
        torch.cuda.empty_cache()
        bf16 = lm_cfg(dtype="bfloat16", dropout=RATE, attention_dropout=RATE)
        tr = LMTrainer(bf16, vocab, params=tree(LM, cfg), mesh=mesh,
                       seed=SEED, device=dev, **P31_OPT)
        reset()
        with Recorder() as rec:
            loss = lm_steps(tr, 1)
        res["mlm"] = {"mesh": (mesh.n_data, mesh.n_model), "losses": losses,
                      "ref": ref, "vocab_split": vocab_split,
                      "bf16": (loss, counts(), rec.k1)}
        del tr
        torch.cuda.empty_cache()
        mark(f"mlm {mesh.n_data}x{mesh.n_model}")

    def lm_dev_part(mesh, res):
        """The LM's dev evaluation at 2048 positions (K3 on each rank's 6
        heads), against one process."""
        cfg = dataclasses.replace(bert_base(V), dtype="bfloat16",
                                  max_position_embeddings=P31_DEV[1])
        dev_data = DocBlockDataset(os.path.join(workdir, "dev2048"),
                                   load_all=True)
        tr = LMTrainer(cfg, vocab, params=tree(LM, cfg), mesh=mesh,
                       seed=SEED, device=dev)
        reset()
        with recording_flash() as seen:
            loss = tr.validate_and_save(os.path.join(workdir, "lm2048"),
                                        dev_data, P31_DEV[0])
        res["lm_dev"] = (loss, fa.LAUNCHES, seen)
        del tr
        if rank == 0:
            one = LMTrainer(cfg, vocab, params=tree(LM, cfg), seed=SEED,
                            device=dev)
            one.best_dev_loss = -1.0                  # nothing is saved
            res["lm_dev"] += (one.validate_and_save(
                os.path.join(workdir, "unused"), dev_data, P31_DEV[0]),)
            del one
        torch.cuda.empty_cache()
        mark("lm dev 2x2")

    # ---- the long-document LM: sequence parallelism ----
    LB, LT = P31_LONG
    lcfg = dataclasses.replace(longdoc_config(V, num_languages=2, size=3),
                               dropout=0.0, attention_dropout=0.0,
                               dtype="float32")
    long_batch = p31_host_lm(LB, LT, V, SEED + 35)

    def long_part(mesh, res):
        tr = LongDocTrainer(lcfg, vocab, params=tree(LONGDOC, lcfg),
                            mesh=mesh, seed=SEED, device=dev, **P31_OPT)
        staged = tr.stage(long_batch)
        rows = host_rows(LB, mesh)
        cols = tr._cols(LT)
        one = LongDocTrainer(lcfg, vocab, params=tree(LONGDOC, lcfg),
                             seed=SEED, device=dev, **P31_OPT)
        whole = one.stage(long_batch)
        with torch.no_grad():
            got = tr.model(staged["texts"], staged["pad_mask"],
                           staged["langs"])
            h = one.model.encode(whole["texts"], whole["pad_mask"],
                                 whole["langs"])[rows, cols]
            want = one.model.project_hidden(h)
        logit_share = float((got - want).abs().max()
                            / want.abs().max())
        del got, want, h
        tr.state, m = tr.step_fn(tr.state, staged,
                                 torch.Generator().manual_seed(0))
        losses = [float(m["sum_loss"] / m["ntokens"])]
        ref = None
        if rank == 0:
            _, m = one.step_fn(one.state, whole,
                               torch.Generator().manual_seed(0))
            ref = parity(losses, [float(m["sum_loss"] / m["ntokens"])],
                         tr.model.state_dict(), one.model.state_dict())
        res[f"long {mesh.n_data}x{mesh.n_model}"] = {
                       "logits": logit_share, "losses": losses, "ref": ref,
                       "run": (cols.start or 0, cols.stop or LT)}
        del tr, one
        torch.cuda.empty_cache()
        mark(f"long {mesh.n_data}x{mesh.n_model}")

    # ---- SenSim and Caption2Image at 2x1 ----
    scfg = dataclasses.replace(sensim_config(V), dropout=0.0,
                               attention_dropout=0.0, dtype="float32")

    def sensim_batch():
        n, t, pool = SENSIM_STEP
        rng = np.random.RandomState(SEED + 32)

        def ids(rows):
            x = (5 + (V - 5) * rng.rand(rows, t) ** 3).astype(np.int32)
            x[:, t // 2 + rng.randint(0, t // 2):] = 0
            return x

        src, dst = ids(n), ids(n)
        b = {"src": src, "src_mask": src != 0, "dst": dst,
             "dst_mask": dst != 0, "src_langs": np.zeros(n, np.int32),
             "dst_langs": np.ones(n, np.int32), "row_mask": np.ones(n, bool)}
        for prefix, lang in (("src_neg", 0), ("tgt_neg", 1)):
            p = ids(pool)
            b.update({prefix: p, f"{prefix}_mask": p != 0,
                      f"{prefix}_langs": np.full(pool, lang, np.int32),
                      f"{prefix}_row_mask": np.ones(pool, bool)})
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    def c2i_batch():
        n, t = C2I_STEP
        rng = np.random.RandomState(SEED + 33)
        src = (5 + (V - 5) * rng.rand(n, t) ** 3).astype(np.int32)
        b = {"src": src, "src_mask": src != 0,
             "src_langs": np.zeros(n, np.int32),
             "target_grid": rng.standard_normal(
                 (n, 49, scfg.hidden_size)).astype(np.float32),
             "row_mask": np.arange(n) < n - 3}
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    def c2i_trainer(mesh):
        model = Caption2Image(scfg, device=dev, param_dtype=torch.float32)
        full = CAPTION2IMAGE.state_dict_from_flax(
            tree(CAPTION2IMAGE, scfg), scfg)
        if mesh is not None:
            full = shard_params(full, mesh, model.shard_(mesh))
        model.load_state_dict(full)
        opt = build_optimizer(lr=P31_OPT["lr"],
                              warmup_updates=P31_OPT["warmup"])
        state = pstep.create_train_state(dict(model.named_parameters()), opt)
        return model, state, pstep.make_caption2image_train_step(model, opt)

    def text_part(mesh, res):
        """One fp32 step of each at dropout 0 against one process."""
        batch = sensim_batch()
        tr = SenSimTrainer(scfg, vocab, params=tree(SENSIM, scfg), mesh=mesh,
                           seed=SEED, device=dev, **P31_OPT)
        tr.state, m = tr.step_fn(tr.state, shard_batch_safe(batch, mesh),
                                 torch.Generator().manual_seed(0))
        losses = [float(m["sum_loss"] / m["ntokens"])]
        ref = None
        if rank == 0:
            one = SenSimTrainer(scfg, vocab, params=tree(SENSIM, scfg),
                                seed=SEED, device=dev, **P31_OPT)
            _, m = one.step_fn(one.state, batch,
                               torch.Generator().manual_seed(0))
            ref = parity(losses, [float(m["sum_loss"] / m["ntokens"])],
                         tr.model.state_dict(), one.model.state_dict())
            del one
        res["sensim"] = {"losses": losses, "ref": ref}
        del tr
        batch = c2i_batch()
        model, state, step = c2i_trainer(mesh)
        _, m = step(state, shard_batch_safe(batch, mesh),
                    torch.Generator().manual_seed(0))
        losses = [float(m["sum_loss"] / m["ntokens"])]
        ref = None
        if rank == 0:
            one, ostate, ostep = c2i_trainer(None)
            _, m = ostep(ostate, batch, torch.Generator().manual_seed(0))
            ref = parity(losses, [float(m["sum_loss"] / m["ntokens"])],
                         model.state_dict(), one.state_dict())
            del one, ostate
        res["c2i"] = {"losses": losses, "ref": ref}
        del model, state
        torch.cuda.empty_cache()
        mark("sensim, c2i 2x1")

    # ---- the caption step (the ResNet in training mode) and its decode ----
    ccfg = caption_train_config(V, dtype="float32", dropout=0.0,
                                attention_dropout=0.0)
    host = caption_host_batches(ccfg, 2, SEED + 34)

    def caption_batch(b, mesh):
        rows = host_rows(b.captions.shape[0], mesh)
        return pstep.caption_batch_to_device(b, b.images(), dev, rows=rows)

    def caption_part(mesh, res):
        tr = CaptionTrainer(ccfg, CaptionVocab(),
                            variables=tree(CAPTION, ccfg), mesh=mesh,
                            seed=SEED, device=dev, **P31_OPT)
        tr.state, m = tr.cap_step(tr.state, caption_batch(host[0], mesh),
                                  torch.Generator().manual_seed(0))
        losses = [float(m["sum_loss"] / m["ntokens"])]
        stats = {k: v.clone() for k, v in tr.model.named_buffers()}
        ref = None
        if rank == 0:
            one = CaptionTrainer(ccfg, CaptionVocab(),
                                 variables=tree(CAPTION, ccfg), seed=SEED,
                                 device=dev, **P31_OPT)
            _, m = one.cap_step(one.state, caption_batch(host[0], None),
                                torch.Generator().manual_seed(0))
            want = dict(one.model.named_buffers())
            rel = abs(losses[0] - float(m["sum_loss"] / m["ntokens"])) / abs(
                float(m["sum_loss"] / m["ntokens"]))
            ref = (rel, _share(stats, want))
            del one, want
        del tr, stats
        torch.cuda.empty_cache()
        # The dev decode (bf16, "fused") splits the images over the data
        # group: K2 and K4 on each rank's rows, the early exit joined.
        tr = CaptionTrainer(caption_train_config(V), CaptionVocab(),
                            variables=tree(CAPTION, ccfg), mesh=mesh,
                            seed=SEED, device=dev)
        n_img, beam, L = P31_CAPTION
        images = np.random.RandomState(SEED + 36).randint(
            0, 256, (n_img, 224, 224, 3)).astype(np.uint8)
        n_steps = 0
        step = tr.model.decode_step

        def counted(*a, **kw):
            nonlocal n_steps
            n_steps += 1
            return step(*a, **kw)

        tr.model.decode_step = counted
        reset()
        with recording_decode_attention() as seen4:
            best, lengths = tr.caption_images(
                images, np.full(n_img, 6, np.int32),
                np.zeros(n_img, np.int32), L, beam_width=beam)
        res["caption"] = {"losses": losses, "ref": ref,
                          "decode": (n_steps, counts(), seen4,
                                     tuple(best.shape),
                                     int(lengths.sum()))}
        del tr
        torch.cuda.empty_cache()
        mark("caption 2x1")

    # ---- ImageMTTrainer under --zero ----
    def image_mt_part(mesh, res):
        icfg = dataclasses.replace(
            image_mt_config(V), dtype="float32", dropout=0.0,
            attention_dropout=0.0, use_pallas_xent=False, freeze_image=True)
        mass = mass_batches(icfg, 1, *IMAGE_MT_TEXT)[0]
        cap = host[1]
        negs = ArrayCaptionBatcher(host).sample_negatives(
            cap.captions.shape[0], 7)

        def run(tr):
            losses = []
            rows = host_rows(mass.src.shape[0], mesh)
            crows = host_rows(cap.captions.shape[0], mesh)
            mm = pstep.caption_batch_to_device(cap, cap.images(), dev,
                                               rows=crows)
            mm["lengths"] = torch.as_tensor(cap.lengths[crows]).to(dev)
            mm["mask_prob"] = 0.7
            con = pstep.caption_batch_to_device(cap, cap.images(), dev,
                                                rows=crows)
            add_negatives(con, negs, 0, 0, dev, mesh)
            for i, (fn, b) in enumerate((
                    (tr.mass_step, pstep.mass_batch_to_device(mass, dev,
                                                              rows)),
                    (tr.mm_mass_step, mm), (tr.contrastive_step, con))):
                tr.state, m = fn(tr.state, b, torch.Generator().manual_seed(i))
                losses.append(float(m["sum_loss"] / m["ntokens"]))
            return losses

        runs = {}
        for zero in (False, True):
            was = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                tr = ImageMTTrainer(icfg, vocab, variables=tree(CAPTION,
                                                                icfg),
                                    mesh=mesh, zero=zero, seed=SEED,
                                    device=dev, **P31_OPT)
                losses = run(tr)
                runs[zero] = (losses, tr._full(tr.model.state_dict()),
                              0 if tr.zero is None else sum(
                                  map(tr.zero.split, tr.state.params)))
                del tr
                torch.cuda.empty_cache()
            finally:
                torch.use_deterministic_algorithms(was)
        # Softmax does not see the attention key biases or the pools'
        # score biases: their gradients are rounding noise, which Adam
        # turns into steps of up to lr whatever the order of the sums.
        kept = [k for k in runs[False][1] if not k.endswith(
            (".self.key.bias", "attention.w.bias"))]
        share = _share({k: runs[True][1][k] for k in kept},
                       {k: runs[False][1][k] for k in kept})
        res["image_mt"] = {"losses": (runs[False][0], runs[True][0]),
                           "share": share, "split": runs[True][2]}
        del runs
        torch.cuda.empty_cache()
        # bf16 under --zero: a text MASS step with the fused cross-entropy
        # (K5 over this rank's rows, the vocab whole), then a
        # back-translation step (its greedy decode: K2 and K4).
        bcfg = dataclasses.replace(image_mt_config(V),
                                   decode_attention_impl="fused")
        tr = ImageMTTrainer(bcfg, vocab, variables=tree(CAPTION, icfg),
                            mesh=mesh, zero=True, seed=SEED, device=dev,
                            **P31_OPT)
        rows = host_rows(mass.src.shape[0], mesh)
        reset()
        with Recorder() as rec:
            tr.state, m = tr.mass_step(
                tr.state, pstep.mass_batch_to_device(mass, dev, rows),
                tr.rng)
        mass_counts = counts()
        bt = mass_batches(bcfg, 1, *P31_BT, seed=SEED + 37)[0]
        n_steps = 0
        step = tr.model.decode_step

        def counted(*a, **kw):
            nonlocal n_steps
            n_steps += 1
            return step(*a, **kw)

        tr.model.decode_step = counted
        reset()
        with Recorder() as rec_bt, recording_decode_attention() as seen4:
            m = tr._bt_step(bt, MTTrainer.lang_directions(["aa", "bb"],
                                                          vocab), tr.rng)
        res["image_mt"]["bf16"] = (
            float(m["sum_loss"] / m["ntokens"]), mass_counts, rec.k1,
            rec.k5, n_steps, counts(), seen4, rec_bt.k1)
        del tr
        torch.cuda.empty_cache()
        mark("image_mt 2x1 zero")

    pair_group = dist.new_group([0, 1])       # collective: every rank
    if rank < 2:
        pair = out["pair"] = {}
        mlm_part(ProcessMesh(1, 2, 0, rank, pair_group, None, dev), pair)
        dp = ProcessMesh(2, 1, rank, 0, None, pair_group, dev)
        text_part(dp, pair)
        caption_part(dp, pair)
        image_mt_part(dp, pair)
    dist.barrier()
    quad = out["quad"] = {}
    mesh = make_mesh(2, 2, device="cuda")
    mlm_part(mesh, quad)
    lm_dev_part(mesh, quad)
    long_part(make_mesh(1, 4, device="cuda"), quad)
    long_part(mesh, quad)

    # ---- the CLIs ----
    cli = []
    for module, argv in cli_argvs:
        reset()
        text = io.StringIO()
        with Recorder() as rec, contextlib.redirect_stdout(text):
            importlib.import_module(
                f"imagetranslate_tpu_torch.cli.{module}").main(argv)
        cli.append((counts(), rec.k1, rec.k5, text.getvalue()))
        torch.cuda.empty_cache()
        mark(f"cli {module}")
    quad["cli"] = cli
    return out


def phase_mesh_families(card, checked, checked_xent, checked_flash,
                        checked_k4):
    """Phase 31: module 14b parts 4-6 on ranks that share the card over
    gloo: correctness only, no speed is read. One spawn of four ranks; the
    2x1 and 1x2 meshes on ranks 0 and 1. The BERT-base MLM (V=32000, 6
    layers, B=16, T=512: the masked-budget path) at 1x2 and 2x2: two fp32
    steps at dropout 0 against one process (PARITY_TOL), then a bf16 step
    at dropout 0.1 (K1 on each rank's 6 heads); at 2x2 its dev evaluation
    at 2048 positions (K3 on each rank's 4 rows and 6 heads) against one
    process (LM_DEV_RTOL). The long-document LM (preset 3, T=4096, B=2)
    under sequence parallelism at 1x4 and 2x2: each rank's logits against
    the same positions of one process (P31_LOGIT_TOL) and one fp32 step
    (PARITY_TOL). At 2x1: one fp32 SenSim step (both pools) and one
    Caption2Image step against one process; a caption step with the ResNet
    in training mode (the running statistics within P31_BN_TOL of one
    process's, from the global batch) and the dev decode of 16 images
    split over the ranks (bf16, fused: K2 and K4 every step); ImageMTTrainer
    under --zero (text MASS, multimodal MASS and contrastive fp32 steps
    with and without it, ZERO_TOL), then a bf16 text MASS step with the
    fused cross-entropy (K5) and a back-translation step (its greedy decode
    through K2 and K4). Then, in the four ranks, cli.train_lm --mesh 2x2,
    cli.train_lm --reformer --mesh 1x4 and (with Pillow)
    cli.train_captioning, cli.train_sensim, cli.train_txt2image and
    cli.train_mt --train --zero at --mesh 2x2 for two steps (768 wide, two
    layers a stack). Returns (K1 fwd, K1 bwd, K5 fwd, K5 bwd, K2, K4, K3)
    launches."""
    import numpy as np
    import torch

    from imagetranslate_tpu_torch.parallel.spawn import run_ranks

    totals = [0] * 7
    k1_seen, k5_seen, k4_seen = set(), set(), set()

    def add(c):
        for i, x in enumerate(c):
            totals[i] += x

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        write_blocks(os.path.join(workdir, "dev2048"), P31_DEV[0],
                     P31_DEV[1], 32000, P31_DEV[0], SEED + 38)
        corpus = prepare_umt_corpus(workdir)
        m11 = prepare_module11_corpus(workdir, corpus)
        tok, mono = corpus[0], corpus[1]
        V = corpus[3].vocab_size()
        blocks = os.path.join(workdir, "blocks")
        write_blocks(blocks, 32, 512, V, 16, SEED + 39)
        # The CLIs at their default widths, two layers a stack (as phase
        # 30's): the meshes' paths are the same at six.
        common = ["--tok", tok, "--step", str(P31_CLI_STEPS), "--warmup",
                  "2", "--enc", "2", "--device", "cuda"]

        def out_dir(name):
            return os.path.join(workdir, name)

        cli_argvs = [
            ("train_lm", [*common, "--model", out_dir("lm"), "--train",
                          blocks, "--batch", "8", "--mesh", "2x2"]),
            ("train_lm", [*common, "--model", out_dir("longdoc"), "--train",
                          blocks, "--batch", "4", "--reformer", "--mesh",
                          "1x4"]),
            ("train_sensim", [*common, "--model", out_dir("sensim"),
                              "--train_mt", m11["train"], "--src-neg",
                              m11["neg"][0], "--dst-neg", m11["neg"][1],
                              "--batch", str(M11_CLI["batch"]), "--mesh",
                              "2x2"])]
        if m11["caps"] is not None:
            images = ["--train", m11["caps"], "--image", m11["images"],
                      "--max-image", str(M11_CLI["max_image"]), "--mesh",
                      "2x2"]
            cli_argvs += [
                ("train_captioning", [*common, "--dec", "2", "--model",
                                      out_dir("cap"), *images]),
                ("train_txt2image", [*common, "--model", out_dir("c2i"),
                                     "--pretrained", m11["captioner"],
                                     *images]),
                ("train_mt", [*common, "--dec", "2", "--model",
                              out_dir("imt"), *images, "--zero",
                              "--mass_train",
                              f"{mono}en,{mono}fa"])]
        t_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run_ranks(p31_rank, 4, os.path.join(workdir, "store"),
                        (workdir, cli_argvs), device="cuda", timeout=900)
        t_ranks = time.perf_counter() - t0
        pair = [r["pair"] for r in got[:2]]
        quad = [r["quad"] for r in got]

        # -- the MLM --
        per = 6                       # K1 calls a forward: 6 encoder layers
        for ranks in (pair, quad):
            res = ranks[0]["mlm"]
            rel, share, ref = res["ref"]
            fwd = [r["mlm"]["bf16"][1][:2] for r in ranks]
            if not (rel <= PARITY_TOL and share <= PARITY_TOL
                    and res["vocab_split"]
                    and all(f == (per, per) for f in fwd)
                    and all(np.isfinite(r["mlm"]["bf16"][0][0])
                            for r in ranks)):
                raise AssertionError(
                    f"mlm {res['mesh']}: losses {res['losses']} against "
                    f"{ref} (rel {rel:.3g}), parameters {share:.3g} of the "
                    f"largest (limit {PARITY_TOL:.0e}); vocab split "
                    f"{res['vocab_split']}; bf16 K1 a rank {fwd}")
            for r in ranks:
                add(r["mlm"]["bf16"][1])
                k1_seen |= r["mlm"]["bf16"][2]
            log(f"[14b mlm] {res['mesh'][0]}x{res['mesh'][1]}, BERT-base "
                f"LM B={P31_MLM[0]} T={P31_MLM[1]} (the masked budget over "
                f"the global batch; heads, FFN and word rows split, out_bias "
                f"whole), fp32 at dropout 0: losses {res['losses']} against "
                f"one process {ref} (rel {rel:.2e}); parameters within "
                f"{share:.2e} of the largest value (limit "
                f"{PARITY_TOL:.0e}); a bf16 step at dropout {RATE}: K1 "
                f"{per} + {per} on each rank's 6 heads, loss "
                f"{res['bf16'][0]} ({card})")
        dev_losses = [r["lm_dev"][0] for r in quad]
        loss, _, seen3, ref = quad[0]["lm_dev"]
        for r in quad:
            require_flash("lm dev 2x2", r["lm_dev"][2], checked_flash,
                          r["lm_dev"][1], per)
            add((0,) * 6 + (r["lm_dev"][1],))
        if len(set(dev_losses)) != 1 or abs(loss - ref) > LM_DEV_RTOL * abs(
                ref):
            raise AssertionError(f"lm dev 2x2: losses {dev_losses} against "
                                 f"one process {ref}")
        log(f"[14b mlm] 2x2 dev evaluation, {P31_DEV[0]} rows of "
            f"{P31_DEV[1]} positions: K3 {per} a rank at {sorted(seen3)}; "
            f"dev loss {loss:.5f} on every rank, one process {ref:.5f} "
            f"(rel {abs(loss - ref) / abs(ref):.2e}, limit "
            f"{LM_DEV_RTOL:.0e}) ({card})")

        # -- the long-document LM --
        for key in ("long 1x4", "long 2x2"):
            ranks = [r[key] for r in quad]
            res = ranks[0]
            rel, share, ref = res["ref"]
            worst = max(x["logits"] for x in ranks)
            if not (rel <= PARITY_TOL and share <= PARITY_TOL
                    and worst <= P31_LOGIT_TOL):
                raise AssertionError(
                    f"{key}: logits {worst:.3g} of the largest (limit "
                    f"{P31_LOGIT_TOL:.0e}); losses {res['losses']} against "
                    f"{ref} (rel {rel:.3g}), parameters {share:.3g} (limit "
                    f"{PARITY_TOL:.0e})")
            log(f"[14b longdoc] {key}, preset 3 at T={P31_LONG[1]}, B="
                f"{P31_LONG[0]} (runs {[x['run'] for x in ranks]}, the halo "
                f"of k, v and the pad mask exchanged in every layer): each "
                f"rank's logits within {worst:.2e} of one process's (limit "
                f"{P31_LOGIT_TOL:.0e}); an fp32 step: loss {res['losses']} "
                f"against {ref} (rel {rel:.2e}), parameters within "
                f"{share:.2e} (limit {PARITY_TOL:.0e}) ({card})")

        # -- SenSim, Caption2Image --
        for name in ("sensim", "c2i"):
            res = pair[0][name]
            rel, share, ref = res["ref"]
            if not (rel <= PARITY_TOL and share <= PARITY_TOL):
                raise AssertionError(f"{name} 2x1: loss {res['losses']} "
                                     f"against {ref} (rel {rel:.3g}), "
                                     f"parameters {share:.3g}")
            log(f"[14b {name}] 2x1, fp32 at dropout 0: loss {res['losses']}"
                f" against one process {ref} (rel {rel:.2e}); parameters "
                f"within {share:.2e} of the largest value (limit "
                f"{PARITY_TOL:.0e}) ({card})")

        # -- the caption step and decode --
        res = pair[0]["caption"]
        rel, stats = res["ref"]
        if not (rel <= PARITY_TOL and stats <= P31_BN_TOL):
            raise AssertionError(f"caption 2x1: loss {res['losses']} (rel "
                                 f"{rel:.3g}), running statistics {stats:.3g}"
                                 f" of the largest (limit {P31_BN_TOL:.0e})")
        n_img, beam, L = P31_CAPTION
        dec = 6                                   # decoder layers
        for r in pair:
            n_steps, c, seen4, shape, _ = r["caption"]["decode"]
            if not (n_steps > 0 and c[4] == n_steps
                    and c[5] == dec * n_steps and shape == (n_img, L)):
                raise AssertionError(f"caption decode 2x1: {n_steps} steps, "
                                     f"K2 {c[4]}, K4 {c[5]}, best {shape}")
            k4_seen |= seen4
            add(c)
        log(f"[14b caption] 2x1, fp32 at dropout 0, the ResNet in training "
            f"mode: loss {res['losses']} (rel {rel:.2e} to one process), "
            f"running statistics within {stats:.2e} of one process's "
            f"(limit {P31_BN_TOL:.0e}); the dev decode of {n_img} images "
            f"({n_img // 2} a rank, beam {beam}, bf16, fused): "
            f"{res['decode'][0]} steps, K2 and {dec} K4 a step ({card})")

        # -- ImageMTTrainer under --zero --
        res = pair[0]["image_mt"]
        if not (res["share"] <= ZERO_TOL and res["split"] > 0):
            raise AssertionError(f"image_mt 2x1 --zero: parameters differ by "
                                 f"{res['share']:.3g} (limit {ZERO_TOL:.0e}); "
                                 f"{res['split']} split tensors")
        for r in pair:
            loss, mc, k1, k5, n_steps, c, seen4, k1_bt = r["image_mt"]["bf16"]
            if not (mc[0] == mc[1] > 0 and mc[2:4] == (1, 1)
                    and n_steps > 0 and c[4] == n_steps
                    and c[5] == dec * n_steps and c[0] == c[1] > 0
                    and np.isfinite(loss)):
                raise AssertionError(f"image_mt bf16 2x1: MASS (K1 fwd, K1 "
                                     f"bwd, K5 fwd, K5 bwd) {mc[:4]}; BT "
                                     f"{n_steps} steps, counts {c}")
            add(mc)
            add(c)
            k1_seen |= k1 | k1_bt
            k5_seen |= k5
            k4_seen |= seen4
        bf = pair[0]["image_mt"]["bf16"]
        log(f"[14b image_mt] 2x1, ImageMTTrainer with and without --zero "
            f"(freeze_image; text MASS, multimodal MASS, contrastive "
            f"fp32 steps under deterministic algorithms): losses "
            f"{res['losses'][0]} and {res['losses'][1]}, largest parameter "
            f"difference (but the key and pool biases) {res['share']:.3g} "
            f"of the largest value (limit "
            f"{ZERO_TOL:.0e}), {res['split']} tensors split; bf16 under "
            f"--zero: a text MASS step K1 {bf[1][0]} + {bf[1][1]}, K5 "
            f"{bf[1][2]} + {bf[1][3]} on each rank's rows; a "
            f"back-translation step: greedy decode {bf[4]} steps (K2 and "
            f"{dec} K4 a step), loss {bf[0]:.4f} ({card})")
        log(f"[14b 4-6] four ranks in {t_ranks:.1f} s (inputs {t_prep:.1f} "
            f"s), over {got[0]['where']}; seconds a part on rank 0: "
            f"{got[0]['seconds']}")

        # -- the CLIs --
        for i, (module, argv) in enumerate(cli_argvs):
            text = quad[0]["cli"][i][3]
            fwd = sum(r["cli"][i][0][0] for r in quad)
            bwd = sum(r["cli"][i][0][1] for r in quad)
            losses = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                      if ln.startswith("Total loss in this epoch:")]
            # The long-document LM's local block attention is plain tensor
            # code: no kernel of its own, and no K1.
            local = "--reformer" in argv
            k1_ok = (fwd, bwd) == (0, 0) if local else fwd > 0 and bwd > 0
            if (not losses or not all(np.isfinite(losses)) or not k1_ok
                    or "Finished Training!" not in text):
                raise AssertionError(f"{module} {argv[-2:]}: losses "
                                     f"{losses}, K1 {fwd} + {bwd}:\n"
                                     f"{text[-2000:]}")
            for r in quad:
                add(r["cli"][i][0])
                k1_seen |= r["cli"][i][1]
                k5_seen |= r["cli"][i][2]
            mesh = argv[argv.index("--mesh") + 1]
            log(f"[14b cli] cli.{module} --mesh {mesh}"
                f"{' --reformer' if '--reformer' in argv else ''}"
                f"{' --train --zero' if '--zero' in argv else ''} in the four "
                f"ranks: {P31_CLI_STEPS} steps, epoch losses {losses}, K1 "
                f"{fwd} + {bwd} over the ranks ({card})")
        if m11["caps"] is None:
            log("[14b cli] Pillow is not installed on this machine: "
                "cli.train_captioning, cli.train_txt2image and cli.train_mt "
                "--train are not run")

    hold_k1("14b 4-6", k1_seen, checked)
    if k5_seen - checked_xent or k4_seen - checked_k4:
        raise AssertionError(f"14b 4-6: K5 shapes "
                             f"{sorted(k5_seen - checked_xent)} or K4 shapes "
                             f"{sorted(k4_seen - checked_k4)[:8]} were not "
                             "held against the plain version")
    torch.cuda.empty_cache()
    return tuple(totals)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "imagetranslate_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(imagetranslate_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test runs on an H100 only",
              file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    start = time.perf_counter()

    def done(phases: str):
        log(f"[time] phases {phases} done at "
            f"{time.perf_counter() - start:.1f} s")

    card = phase_device()
    phase_build()
    topk = phase_kernel()
    done("1-3")
    launches, model = phase_decode(card)
    if profile:
        phase_profile(model, card)
    del model
    torch.cuda.empty_cache()
    phase_cli()
    done("4-5")
    with tempfile.TemporaryDirectory() as umt_dir:
        corpus = prepare_umt_corpus(umt_dir)
        m11 = prepare_module11_corpus(umt_dir, corpus)
        cli_k1, cli_k5 = umt_cli_shapes(corpus[3].vocab_size())
        mt_k1, mt_k5 = image_mt_shapes()
        pack = pack_shapes()
        z14b_k1, z14b_k5 = p30_shapes()
        p31_k5, p31_k3, p31_k4 = p31_shapes()
        attn_fwd, attn_bwd, checked = phase_kernel_attention(
            cli_k1 + caption_train_k1_shapes() + mt_k1
            + module11_shapes(m11) + pack[2] + z14b_k1)
        done("6")
        xent_fwd, xent_bwd, checked_xent = phase_kernel_xent(
            cli_k5 + mt_k5 + pack[3] + z14b_k5 + p31_k5)
        flash, checked_flash = phase_kernel_flash([long_cli_shape()]
                                                  + p31_k3)
        dec_attn, checked_k4 = phase_kernel_decode_attention(
            decode_path_shapes() + p31_k4)
        done("9, 12, 16")
        dec_attn_launches = phase_decode_fused(card, checked_k4)
        torch.cuda.empty_cache()
        caption_k4, caption_k2 = phase_caption(card, profile, checked_k4)
        dec_attn_launches += caption_k4
        torch.cuda.empty_cache()
        done("17-18")
        ct_fwd, ct_bwd, ct_k2, ct_k4 = phase_caption_train(
            card, profile, checked, checked_xent, checked_k4)
        dec_attn_launches += ct_k4
        caption_k2 += ct_k2
        torch.cuda.empty_cache()
        done("19")
        im_fwd, im_bwd, im_k5f, im_k5b, im_k2 = phase_image_mt(
            card, profile, checked, checked_xent, corpus)
        caption_k2 += im_k2
        torch.cuda.empty_cache()
        done("20")
        m11_fwd, m11_bwd, m11_k2, m11_k4 = phase_module11(
            card, checked, checked_xent, checked_k4, m11)
        moe_fwd, moe_bwd, moe_k5f, moe_k5b, moe_k2, moe_k4 = phase_moe(
            card, checked, checked_xent, checked_k4)
        caption_k2 += m11_k2 + moe_k2
        dec_attn_launches += m11_k4 + moe_k4
        torch.cuda.empty_cache()
        done("21-22")
        det_k2, det_k4 = phase_detector(card, profile, checked_k4, corpus)
        caption_k2 += det_k2
        dec_attn_launches += det_k4
        torch.cuda.empty_cache()
        pk_fwd, pk_bwd, pk_k5f, pk_k5b = phase_pack(
            card, profile, checked, checked_xent, pack, corpus)
        torch.cuda.empty_cache()
        done("23-24")
        fwd_launches, bwd_launches = phase_train(card, profile, checked,
                                                 checked_xent)
        torch.cuda.empty_cache()
        phase_train_cli()
        torch.cuda.empty_cache()
        done("7-8")
        xent_launches = phase_umt_train(card, checked, checked_xent)
        xent_launches = (xent_launches[0] + im_k5f + moe_k5f + pk_k5f,
                         xent_launches[1] + im_k5b + moe_k5b + pk_k5b)
        torch.cuda.empty_cache()
        phase_umt_cli(umt_dir, corpus, checked, checked_xent)
        torch.cuda.empty_cache()
        done("10-11")
        flash_launches = phase_long_source(card, profile, checked_flash)
        lm_k3, lm_fwd, lm_bwd = phase_lm(card, profile, checked_flash,
                                         checked)
        flash_launches += lm_k3
        fwd_launches += (lm_fwd + ct_fwd + im_fwd + m11_fwd + moe_fwd
                         + pk_fwd)
        bwd_launches += (lm_bwd + ct_bwd + im_bwd + m11_bwd + moe_bwd
                         + pk_bwd)
        phase_lm_cli(umt_dir, corpus)
        done("13-15")
        rm = phase_remat(card, checked, checked_xent, pack)
        torch.cuda.empty_cache()
        itr1_fwd, itr1_bwd, itr1_k2 = phase_itr1(card, checked,
                                                 checked_xent, corpus)
        torch.cuda.empty_cache()
        rc_fwd, rc_bwd, rc_k2 = phase_recipe(card, checked)
        torch.cuda.empty_cache()
        fwd_launches += rm[0] + itr1_fwd + rc_fwd
        bwd_launches += rm[1] + itr1_bwd + rc_bwd
        xent_launches = (xent_launches[0] + rm[2], xent_launches[1] + rm[3])
        launches += itr1_k2 + rc_k2
        done("27-29")
    torch.cuda.empty_cache()
    k2b = phase_kernel_k2b()
    torch.cuda.empty_cache()
    tp_merge, tp_k2, tp_fwd, tp_bwd = phase_tp_path(card)
    launches += tp_k2
    fwd_launches += tp_fwd
    bwd_launches += tp_bwd
    done("25-26")
    z = phase_14b(card, checked, checked_xent, checked_k4)
    fwd_launches += z[0]
    bwd_launches += z[1]
    xent_launches = (xent_launches[0] + z[2], xent_launches[1] + z[3])
    launches += z[4]
    tp_merge += z[5]
    dec_attn_launches += z[6]
    done("30")
    z = phase_mesh_families(card, checked, checked_xent, checked_flash,
                            checked_k4)
    fwd_launches += z[0]
    bwd_launches += z[1]
    xent_launches = (xent_launches[0] + z[2], xent_launches[1] + z[3])
    launches += z[4]
    dec_attn_launches += z[5]
    flash_launches += z[6]
    done("31")
    attn_src = "imagetranslate_tpu_torch/csrc/train_attention.cu"
    xent_src = "imagetranslate_tpu_torch/csrc/xent.cu"
    print(card)
    print(json.dumps({"kernels": [
        {"name": "project_topk", "route": "cuda",
         "source": "imagetranslate_tpu_torch/csrc/topk_project.cu",
         "replaces": "imagetranslate_tpu/ops/topk_project.py:206",
         "launches": launches + caption_k2, **topk},
        {"name": "fused_dropout_attention_fwd", "route": "cuda",
         "source": attn_src,
         "replaces": "imagetranslate_tpu/ops/train_attention.py:242",
         "launches": fwd_launches, **attn_fwd},
        {"name": "fused_dropout_attention_bwd", "route": "cuda",
         "source": attn_src,
         "replaces": "imagetranslate_tpu/ops/train_attention.py:256",
         "launches": bwd_launches, **attn_bwd},
        {"name": "smoothed_xent_rows_fwd", "route": "cuda",
         "source": xent_src,
         "replaces": "imagetranslate_tpu/ops/xent_pallas.py:118",
         "launches": xent_launches[0], **xent_fwd},
        {"name": "smoothed_xent_rows_bwd", "route": "cuda",
         "source": xent_src,
         "replaces": "imagetranslate_tpu/ops/xent_pallas.py:141",
         "launches": xent_launches[1], **xent_bwd},
        {"name": "flash_attention", "route": "cuda",
         "source": "imagetranslate_tpu_torch/csrc/flash_attention.cu",
         "replaces": "imagetranslate_tpu/ops/flash_attention.py:97",
         "launches": flash_launches, **flash},
        {"name": "decode_attention", "route": "cuda",
         "source": "imagetranslate_tpu_torch/csrc/decode_attention.cu",
         "replaces": "imagetranslate_tpu/ops/decode_attention.py:188",
         "launches": dec_attn_launches, **dec_attn},
        {"name": "sharded_project_topk", "route": "cuda",
         "source": "imagetranslate_tpu_torch/csrc/topk_project.cu",
         "replaces": "imagetranslate_tpu/ops/topk_project.py:305",
         "launches": tp_merge, **k2b},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
