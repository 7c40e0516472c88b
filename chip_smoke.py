#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) end to end on one card.

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file; exits non-zero
without a result line otherwise. It imports nothing of JAX or of the JAX
package. Phases, each printing JSON lines and failing loudly:

1. device  — the card's name and power limit, as nvidia-smi gives them,
             mx.runtime's feature list and storage.memory_info;
2. build   — nvcc builds every kernel from the checkout's sources, one
             process per source, all at once (into build/kernels/,
             listed in .gitignore);
3. kernels — each kernel against its plain PyTorch version at its
             path's shapes, bf16 and f32, with its stated tolerance (the
             backward kernels on BERT-base's (32 x 512) batch, flash on
             its fused-QKV views and a causal (2, 8, 2048, 128); the
             RMSNorm forward with its rstd and backward at the proxy1b
             step's (8 x 2048, 2048), causal flash at its (8, 16, 2048,
             128); the Adam sweep over BERTForPretrainFused's bf16
             multi-precision parameter set and the AdamW scan and sweep
             over proxy1b's and the SGD sweep over ResNet-50's two
             buckets, bit for bit; the LAMB sweep's three kernels over
             BERT-base's set and a small f32 bucket, phases 1 and 2 bit
             for bit, the norms to 1e-5 of an f64 sum; the dropout
             modes at p = 0.1: the hash-dropout kernel bit for bit,
             LayerNorm ± residual forward and backward with dx's zeros
             equal to the mask, flash forward and backward, and flash's
             mask bit for bit through lk = d with V the identity);
             kernel, plain and
             library-call times from CUDA events (cold L2), and the
             least time the card could take (bound_ms) from this run's
             bytes and operations; for the paged decode and the flash
             backward also device_ms and library_device_ms, events
             queued behind a sleep kernel (_queued_ms), which time the
             card and not the wrapper's host work, the paged decode's
             splits and CTAs, one launch under torch's sync-debug mode
             "error" (no host sync: lengths stays on the card), and both
             kernels' bits on a second call; the LayerNorm backward (±
             residual, ± dropout), the RMSNorm backward and the RMSNorm
             forward (also at decode's (8, 4096), beside an empty
             kernel's device_ms as the floor)
             the same bits on a second call; then launch_counts: the
             kernels one call of each of those launches at bf16 at the
             main paths' shapes, counted in a CUDA graph capture of the
             call, exactly one;
4. reference — the Llama decode path at Llama-3-8B widths, depth cut to
             2 layers, in f32: each stream's last decode-step logits
             against forward_full over the same tokens, to f32 noise;
             decode steps replay one CUDA graph per batch bucket,
             captured at start() and never again: captures, replays,
             launches per replay held against each graph's kernel
             nodes, the launch counts equal to the replays' and the
             prefills' exactly; one B = 8 step's graph logits against
             the eager _paged_forward bit for bit (all rows, then 5 rows
             and 3 padding rows);
5. serving — Llama-3-8B at full width (32 layers, bf16, seeded random
             weights) behind serving.Server: 8 concurrent
             submit_generate calls (prompts of 100-500 tokens, 32 new
             tokens each); tokens/s, TTFT, per-token latency, the
             kernels' launch counts over this phase, each stream's last
             decode-step logits against forward_full over the same
             tokens, and the graph checks of phase 4; a B = 8 step's
             host vs device ms through the graph and eagerly (the
             parent's path), in turns, and the graph's replay alone;
5a. multitenant — two Llama-3-8B tenants at full width and depth,
             bf16, different seeds, one page pool: the weight-3:1 token
             share over a window within 10%, then a pool filled by
             priority-0 streams that priority-10 arrivals must preempt
             (each victim Preempted with no token after, stats()
             counting exactly the victims), every completed stream's
             last logits against forward_full within 10%;
5b. reload — swap_model on a full Llama-3-8B while a stream decodes
             (it finishes on the old weights, the next runs on the new;
             one recapture per bucket, timed), then reload from a
             CheckpointManager bundle at 8B width and 2 layers through
             one injected, retried serving.reload fault (save and load
             s and MB/s, the weights bit for bit);
6. bert_reference — BERT-base widths, depth cut to 2 layers, every
             output (masked-LM head included), in f32: each sample served
             through Server.submit against a batch-1 forward of the same
             padded sample, and that forward against the same weights
             run through the plain versions (a CPU copy of the model),
             both to f32 noise;
7. bert_serving — bert_12_768_12 at full width and depth (bf16, seeded
             random weights, no MLM head) behind Server.submit: 256
             requests of 16-512 tokens from 8 client threads; requests/s,
             real and padded tokens/s, p50/p99 latency, batches by close
             reason, occupancy, the launches of each kernel per dispatched
             forward (exactly 25 LayerNorm, 12 flash, 12 bias+GELU), each
             response against its batch-1 forward, a breakdown of one
             (32, 512) forward (host vs device ms, top device events),
             and the burst served again under the profiler (the card's
             busy share of the wall time, its top device events);
8. train_reference — BERTForPretrainFused at BERT-base widths, depth
             cut to 2 layers, f32: three TrainStep Adam steps on the card
             against the same weights, batch and step seeds on the CPU
             (the plain versions): each loss, and each parameter's delta
             over the run by norm ratio; at dropout 0, then at 0.1 / 0.1;
9. bert_train — BERTForPretrainFused at bert_12_768_12, not cut (bf16,
             multi-precision Adam at lr 1e-4, seeded random weights), one
             (32, 512) batch, at dropout 0 and BERT's published 0.1 /
             0.1 in turns (0, 0.1, 0.1, 0) in the same process: 3
             warm-up and 20 timed TrainStep calls each; ms per step,
             samples/s, MFU, peak memory, the loss (finite, falling),
             exactly 26/26 LayerNorm (12 with dropout), 13/13
             bias+GELU, 12/12 flash (dropping with attention dropout)
             and 25/25 hash-dropout launches forward/backward and one
             sweep per dtype bucket per step, and a profiled step (host
             vs device ms, idle share, top device events, each port
             kernel's device time per launch);
10. bert_trainer_reference — the eager Gluon path (autograd.record,
             autograd.backward, gluon.Trainer with LAMB, no weight decay
             on beta, gamma and bias) on BERTForPretrainFused at
             BERT-base widths, depth cut to 2 layers, f32, at 0.1 / 0.1:
             three steps on the card against the same weights, batch and
             dropout seeds on the CPU (each loss to 1e-5, each
             parameter's delta by norm ratio to 1e-3) and the launch
             counts;
11. bert_trainer — that path on bert_12_768_12, not cut (bf16,
             multi-precision LAMB at lr 1e-3, wd 0.01, seeded random
             weights, dropout 0.1 / 0.1), one (32, 512) batch: 3 warm-up
             and 20 timed steps; ms per step, samples/s, MFU, peak
             memory, the loss (finite, falling strictly over the first
             three steps), the second step against the LAMB rule worked
             by hand in f64, exactly 26/26 LayerNorm (12 with dropout),
             13/13 bias+GELU, 12/12 flash, 25/25 hash dropout and one
             launch of each LAMB kernel per dtype bucket per step and no
             other sweep, the host ms of the forward, the backward and
             Trainer.step apart, a profiled step, and the memory a
             forward holds under record(), outside it and under pause();
11a. gluon_reference — the Gluon core as MXNet users write it, f32, BERT
             at BERT-base widths cut to 2 layers (pooler, classifier,
             dropout 0.1 / 0.1, TF32 off): bert_12_768_12(...),
             initialize(mx.init.Normal(0.02), ctx=) on the card and the
             CPU, the weights carried by a .params file; the hybridized
             predict forward on the card (one CUDA graph per signature,
             with and without a ragged valid_length) against the eager
             CPU forward (each output within 1e-4 of its largest), then
             three record / loss.backward() / Trainer.step Adam steps on
             each device with the same dropout seeds (losses to 1e-5,
             deltas to 1e-3 by norm ratio);
11b. gluon  — bert_12_768_12 with pooler and classifier, not cut, bf16,
             NDArrays on mx.gpu(), hybridize(static_alloc=True,
             static_shape=True): predict at (32, 128), (32, 512) and
             (32, 128) with a ragged valid_length, each graph's output
             the eager forward's bit for bit, one capture per signature
             and none over 20 replays, launches per replay equal to the
             graph's own kernel nodes and to the model's (25 LayerNorm,
             12 flash, 12 bias+GELU; no flash with the valid_length,
             whose mask takes the dense route), host and device ms per
             forward hybridized and eager with the card's idle share;
             train at 32 x 128 (Adam 2e-5, dropout 0.1 / 0.1: the loss
             finite and falling over the first three steps, every
             gradient an NDArray, exactly the model's launches per step,
             ms per step, samples/s, host ms of forward, backward and
             Trainer.step); save_parameters / load_parameters(ctx=
             mx.gpu()) of a fresh model bit for bit, MB/s each way;
12. llama_train_reference — LlamaModel(fused_ce=True) at proxy1b
             widths, depth cut to 2 layers, f32: three TrainStep AdamW
             steps on the card against the same weights and batch on the
             CPU (each loss to 1e-5, each parameter's delta by norm ratio
             to 1e-3) and the launch counts;
13. llama_train — the proxy1b Llama (700.5M parameters) not cut, built
             by mxnet_tpu_torch.tools.pretrain_llama (bf16, fused CE
             head, multi-precision AdamW at lr 3e-4, wd 0.1, beta 0.9 /
             0.95, seeded random weights), one (8, 2048) batch of
             RandomState(0) tokens: 3 warm-up and 10 timed TrainStep
             calls; ms per step, tokens/s, MFU, peak memory, the loss
             (finite, falling), exactly 21/21 RMSNorm and 10/10 flash
             launches forward/backward, one AdamW scan and one sweep per
             step and no other training kernel, and a profiled step;
13a. llama_remat — the same proxy1b from the same weights and batch in
             three settings: no remat, the driver's default (per-block
             remat, "full") and --remat dots: the first step's loss and
             every weight and f32 master under either policy equal to
             the no-remat step's bit for bit; ms per step, tokens/s,
             MFU, peak memory; exactly 41/21 RMSNorm and 20/10 flash
             launches forward/backward a step under remat;
14. resnet_train_reference — resnet18_v1(classes=10) at 64x64, batch
             4, f32 with TF32 off: three TrainStep SGD steps on the card
             against the CPU, which replays the card's ReLU and max-pool
             decisions (losses, running statistics and deltas);
15. resnet_train — resnet50_v1(layout="NHWC") bf16 at batch 256 x 224,
             SGD lr 0.1, momentum 0.9, multi-precision: 3 warm-up and 20
             timed steps, the second against the SGD rule by hand,
             exactly 2 sweeps per step, images/s, MFU, a profiled step;
15a. optimizer_paths — SGD, Adam, AdamW and LAMB, f32 and bf16 with
             f32 masters, three updates of a BERT layer's shapes through
             the fused sweep and through the per-parameter Updater:
             every weight, master and state bit for bit;
15b. resnet_v2_trainer_reference — resnet18_v2(classes=10) at 64x64,
             batch 4, f32, TF32 off: three eager steps (record,
             backward, Trainer('nag') with a cosine schedule) on the card
             against the CPU replaying the card's ReLU and max-pool
             decisions (phase 14's limits), then save_states /
             load_states into a fresh Trainer over a reloaded model and
             its step 3 = the uninterrupted one bit for bit;
15c. resnet_v2_trainer — resnet50_v2(layout="NHWC") bf16 at 128 x 224
             through GluonCV's recipe in the eager loop (NAG momentum
             0.9, wd 1e-4, multi-precision, cosine after a linear
             warmup): the loss falling, each learning rate the
             schedule's by hand, step 2 against NAG's rule in f64, no
             sweep launched, one per_param dispatch per parameter;
             ms per step, images/s, host ms of forward, backward and
             Trainer.step, save_states/load_states MB/s;
16. rtc     — mx.rtc.CudaModule over NVRTC (each module compiled to an
             sm_90a CUBIN): upstream MXNet's axpy as a template
             (axpy<float>, axpy<double>, axpy<__half>) and its
             shared-memory saxpy, the JAX package's two tests/test_rtc.py
             kernels in CUDA, (16384, 768) f32 row sums through dynamic
             shared memory (also above 48 KiB) to 1e-6 of an f64 sum, and
             a user axpy over a (32, 512, 768) activation in bf16 and f32,
             bit-identical to its plain version with --fmad=false, timed
             beside its byte bound and torch.add; the NVRTC compile ms,
             a cached get_kernel's ms, the host us per launch, and six
             refusals, each an MXNetError (the kernel sources and plain
             versions are tests/test_torch_cuda_rtc.py's);
17. imperative — the mx.nd path at BERT-base width:
             BERTForPretrainFused(bert_12_768_12), bf16, one eager step's
             gradients (record, autograd.backward; the kernels' launches
             exactly the model's), the 153 parameters and gradients
             wrapped as NDArrays without a copy, mx.nd.save / mx.nd.load
             of the 219 MB parameter dict bit for bit (s and MB/s each
             way), and a manual SGD update by two routes from the same
             weights, the NDArray ops w -= lr * g and a user CudaModule
             kernel launched once per parameter, bit-identical (device
             ms, host ms and launches of each, the byte bound), and that
             kernel alone on the largest parameter (the word embedding)
             beside its plain version, torch.sub and its byte bound;
17a. dp_reference — the data-parallel comms: BERTForPretrainFused at
             BERT-base widths cut to 2 layers, f32, TF32 off, dropout
             0.1 / 0.1, Adam, two batch slices a step, three steps each
             way: Trainer(kvstore='nccl'), with overlap_comms, and with
             partition='zero1' at world 1, each bit for bit with
             kvstore=None on the card; two CPU contexts cpu(0)/cpu(1),
             one slice each, against the card (losses to 1e-5, deltas
             to 1e-3); a one-rank NCCL group through comm.py's three
             primitives, the bits unchanged;
17b. dp_train — bf16 BERT-base not cut, multi-precision Adam lr 1e-4,
             (32, 512), dropout 0.1 / 0.1: Trainer(kvstore='nccl',
             overlap_comms=True) in turns with kvstore=None, then with
             2-bit compression, then partition='zero1', 3 warm-up and 20
             timed steps each: ms per step, samples/s, peak memory, host
             ms of forward, backward and step, buckets and bytes per
             step, last_overlap_stats, the loss finite and falling, and
             exactly the model's launches, one Adam sweep per dtype
             bucket and one twobit_quantize per gradient bucket per step
             with compression (none without); the kernels phase holds
             twobit_quantize bit for bit against its plain version on a
             25 MB bf16 bucket and an f32 bucket holding the edge values;
17c. data_llama — proxy1b (700.5M parameters, not cut, --no-remat)
             through mxnet_tpu_torch.tools.pretrain_llama.main with
             --data <tmp>/tokens.rec --save-dir <tmp>/ckpt --steps 4
             --save-every 4, the record file (32 records of 2049
             RandomState(0) int32 ids, the first 8 the synthetic batch)
             written with mx.recordio: the first loss equal to the
             synthetic path's bit for bit, every step's batch its
             records' ids, exactly 21/21 RMSNorm, 10/10 flash and one
             AdamW scan and sweep a step, the .params reloading into a
             fresh net bit for bit, the .states leaves byte for byte the
             step's; bytes written, the save's MB/s, tokens/s of the
             synced span; <tmp> removed;
17d. data_resnet — phase 15's ResNet-50 cell fed by mx.io: an
             NDArrayIter over 4 batches of seeded uint8 NCHW images ->
             DeviceFeedIter(step=, depth=2, make_normalize_transform(
             ImageNet, bf16)), two passes in turns with a staged batch:
             each staged batch the CPU transform of its source bit for
             bit, the loss finite and falling, 2 SGD sweeps a step,
             images/s fed and staged, the data wait per step;
17e. data_gluon — examples/train_mnist_gluon.py's loop on the card:
             MNIST (the seeded surrogate) -> transform_first(ToTensor())
             -> DataLoader(64, shuffle, num_workers=4, pin_memory=True),
             LeNet, record/backward/Trainer('sgd', momentum 0.9),
             mx.metric.Accuracy and callback.Speedometer over two
             passes: thread and fork workers' batches bit for bit those
             of num_workers=0 from one sampler seed, the accuracy
             rising, one SGD sweep a step, no /dev/shm block left after
             an early break;
17f. data_image — the reference's ImageNet pipeline on the card:
             1024 seeded JPEG records (320-500 x 240-375, quality 90,
             30-110 KB) written by recordio.pack_img through nvJPEG's
             encoder; nvJPEG's decode of tests/torch_image_fixtures
             against Pillow's pixels (gray within 2, 4:4:4 within 3,
             subsampled PSNR >= 40 dB and mean |diff| <= 1.0); the
             ImageRecordIter chain (resize 256, crop, flip, ImageNet
             mean/std) on the card against the CPU from the card's
             decoded images and the same seeds (uint8 steps bit for
             bit, float32 within 1e-6); resnet50_v1 at phase 15's cell
             fed by mx.io.ImageRecordIter on the card in turns with a
             staged batch: the loss finite, 2 SGD sweeps and one
             batched nvJPEG call per fed step, images/s fed and staged,
             the data wait, nvJPEG's ms per batch and image and its
             backend; a profiler round whose table names mx_sgd_sweep;
17g. coldstart — the compilation service's cold-start meter,
             mxnet_tpu_torch/tools/coldstart_bench.py: Llama-3-8B at
             full width (32 layers, bf16, phase 5's seed) behind
             serving.Server with decode graphs per batch bucket, the
             hybridized bert_12_768_12 predict at (32, 128) and (32, 512)
             through a head whose mx.rtc kernel scales the pooled output,
             and proxy1b's first TrainStep, each in fresh processes in
             three regimes (cold: NVRTC tier emptied, a manifest
             recorded; warm_disk: the CUBIN read from disk;
             warm_manifest: compiler.warm_start over that manifest before
             the first request): seconds from import to first_response,
             warm_start_done and first_train_step, the first dispatch's
             ms; fails unless the warm processes record zero
             cached_op/serving_decode/train_step misses after
             warm_start (warm_start's failed count 0), give the cold
             process's tokens, BERT outputs and first loss bit for bit,
             load the CUBIN from disk with no NVRTC compile, and launch
             rows 1, 2, 1', 3, 10 and 13 inside the graphs warm_start
             captured;
17h. compile_only — tools/pretrain_llama.py --config 8b --compile-only
             in a subprocess: under 1 GiB allocated on the card, params
             equal to param_count, argument bytes the analytic parameters
             x 14 B plus the batch, fits false, the FLOPs within 1% of
             6·N·tokens plus the causal attention's 6·L·B·S²·units; then
             proxy1b (remat off, 8 x 2048) under abstract_init through
             TrainStep.aot_compile and live on the card: the AOT
             argument bytes the live step's parameters, states and batch
             byte for byte, the AOT temp bytes beside the live peak less
             the arguments, the FLOPs within 1% of the analytic count,
             MFU beside the step's ms;
17i. rnn — the RNN op's card route (one cuDNN call per layer) against
             its plain step loop on the CPU, f32 with TF32 off, every
             mode and direction at 2 layers, seq 35, batch 8, width 64:
             outputs, states and gradients within RNN_F32_LIMIT of the
             largest magnitude (1e-5 for rnn_relu, 5e-5 where cuDNN's
             sigmoid/tanh run; both routes' distance from the step loop
             in f64 printed; in bf16 the card within 2^-7 of the f64
             loop or 1.5x the bf16 loop's distance), 2 cuDNN calls a
             call, cuDNN's RNN kernels
             named by the profiler, the inter-layer hash dropout's seeds
             and masks the CPU's at p = 0.5; cuDNN's ms per layer beside
             the step loop's on the card at the word LM's (35, 32, 650);
17j. word_lm — MXNet's word language model at its 650-wide line
             (Embedding(33278, 650), 2-layer LSTM with dropout 0.5, the
             decoder tied to the embedding, 28.4M f32 parameters) over a
             Zipf token stream: two clipped SGD steps on the card against
             the CPU (losses to 1e-5, deltas to 1e-3, TF32 off), 25 steps
             on the card (the loss falling over the first 5; exactly 3
             hash_dropout, 3 hash_dropout_bwd, 1 SGD sweep and 2 cuDNN
             layer calls a step; tokens/s, host/device ms and idle
             share, device ms by kind, the CE head's ms, peak memory),
             and evaluation through the hybridized LSTM (graph = eager
             bit for bit, one capture);
17k. vision_reference — f32, TF32 off: alexnet, vgg16_bn,
             squeezenet1.1, densenet121, inceptionv3 (299),
             mobilenet1.0, mobilenetv2_1.0 and mobilenetv3_large through
             get_model at batch 2, the card's NHWC build against the
             CPU's NCHW build from one .params file (1e-4 of the largest
             logit) and the hybridized graph against eager bit for bit
             with one capture; the new ops (1-D/3-D, grouped, depthwise,
             dilated convolution and Deconvolution with gradients, every
             pooling type and convention, the resize ops) card against
             CPU to 1e-5; a Conv2DLSTMCell over 10 64x64 frames; three
             SGD steps of mobilenet_v2_0_25 card against CPU with the
             card's ReLU6 decisions replayed; one AlexNet training step
             with the CPU's dropout seeds (2 + 2 hash-dropout launches,
             the masks bit for bit);
17l. mobilenet_train — mobilenetv2_1.0 (NHWC, 3.50M parameters) at its
             published widths and depth, bf16 with f32 BatchNorm, batch
             128 x 224, SGD lr 0.1, momentum 0.9, wd 4e-5,
             multi-precision: 3 warm-up and 20 timed TrainStep calls;
             the loss falling over the first three, step 2 against the
             SGD rule by hand, every running statistic moved, exactly 2
             SGD sweeps a step, the counted multiply-adds within 5% of
             300M an image; images/s, MFU, peak memory, host and device
             ms, device ms by kind, the depthwise convolutions',
             BatchNorms' and ReLU6s' own device ms;
17m. vision_serve — the hybridized inceptionv3 (NHWC) predict in bf16 at
             (32, 3, 299, 299): 20 graph replays equal to the eager
             forward bit for bit, one capture; host and device ms per
             forward, graph and eager, images/s;
17n. ssd_reference — ssd_toy(num_classes=3) at 64x64, batch 2, f32 with
             TF32 off, seeded weights carried to a CPU build by a .params
             file: the predict forward card against CPU (1e-4 of each
             output's largest), then two record / targets (mining at 3) /
             SSDMultiBoxLoss / backward / Trainer('adam') steps on each
             device: cls_target and loc_mask equal, each loss within
             1e-5, each delta within 1e-3 by norm ratio (the convolution
             biases feeding a BatchNorm, whose gradients are rounding,
             held to 1e-5 of the largest gradient); box_nms on the card
             against its plain version on the card and the CPU's op, bit
             for bit, over crafted rows (score ties, +-0 and NaN scores,
             shared and distinct ids, force_suppress, topk, the center
             format in and out, leading axes, 1000 and 3000 rows);
17o. ssd_train — get_ssd(20, base="small") (7,620 anchors at 300x300),
             f32, batch 32 of seeded images with up to 8 filled
             rectangles of known class, the eager Gluon path (record,
             net.targets with hard-negative mining at 3, SSDMultiBoxLoss,
             backward, Trainer('adam', lr 1e-3).step): 3 warm-up and 10
             timed steps, the loss finite and lower at the last step than
             the first, exactly one Adam sweep a step and no box_nms;
             images/s, ms per step, host and device ms, idle share,
             device ms by kind, MultiBoxTarget's own ms, peak memory;
17p. ssd_detect — that net hybridized: the forward's graph equal to the
             eager forward bit for bit with one capture; detect at batch
             32 (nms_topk 400, nms_threshold 0.45) equal to the plain
             route's rows (box_nms through its plain version on the same
             card inputs) bit for bit; exactly one box_nms call and one
             box_nms kernel (nms_plan's shared route) a detect;
             images/s, host and device ms a detect; the kernels phase
             holds box_nms against its plain version at detect's (32,
             7620, 6) rows with topk 400 (one kernel a call) and at the
             op's default topk=-1 (two), bit for bit;
17q. spatial_reference — the spatial group's 11 ops (ROIAlign,
             ROIPooling, PSROIPooling, DeformableConvolution, Correlation,
             BilinearSampler, SpatialTransformer, GridGenerator, Crop,
             im2col, col2im) at small shapes, f32 with TF32 off, card
             against CPU from the same numpy inputs: each output and each
             gradient the reference takes within the CPU tests'
             tolerances; a hybridized HybridBlock (F.contrib.ROIAlign,
             then a Dense): its graph against eager bit for bit, one
             capture;
17r. spatial — the group's path through mx.nd at published widths, f32,
             TF32 off, the launch counters set to 0 just before: Faster
             R-CNN's RoI head (GluonCV faster_rcnn_resnet50_v1b_voc:
             mx.nd.contrib.ROIAlign over a (2, 1024, 38, 63) C4 map, 256
             RoIs, 14 x 14, sr 2, scale 1/16, under autograd.record(),
             backward(), 3 steps; a 300-RoI predict call), FlowNetC's cost
             volume (mx.nd.Correlation, (8, 256, 48, 64), pad 20, max
             displacement 20, stride2 2: 441 channels, 3 steps forward and
             backward), R-FCN's head (mx.nd.contrib.PSROIPooling, (1,
             1029, 38, 63), 300 RoIs, 21 x 7 x 7) and the DCN res5 conv
             (mx.nd.contrib.DeformableConvolution, 512 filters, 3x3,
             dilate 2, 4 deformable groups, forward and backward), and
             Fast R-CNN's mx.nd.ROIPooling (256 RoIs of a (2, 512, 38,
             63) map, 7 x 7, forward and backward, timed): exact
             launches (one roi_align and one roi_align_bwd a step plus the
             predict call's, one correlation and one correlation_bwd a
             step), outputs finite and of their shapes, PSROIPooling and
             the DCN card against CPU (1e-5; the weight's gradient 1e-4)
             and both timed; host and device ms a step and peak MB. The
             kernels phase holds roi_align, roi_align_bwd, correlation and
             correlation_bwd against their plain versions at these shapes
             (the forwards within 1e-6 and 1e-5, the gradients within
             1e-5, FlowNetC's at batch 8);
18. summary — one {"kernels": [...]} line (the Pallas sites' kernels,
             hash_dropout, twobit_quantize, box_nms, roi_align,
             roi_align_bwd, correlation and correlation_bwd beside them,
             and an mx.rtc entry for mxnet_tpu/rtc.py:62: the imperative
             path's user SGD kernel, the rtc phase's axpy beside it), and
             the eager path's step beside TrainStep's at the same shape
             and dropout.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import functools
import itertools
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12}     # f32 outside the tensor cores
SEED = 0
N_STREAMS = 8
NEW_TOKENS = 32
BERT_REQUESTS = 256
BERT_CLIENTS = 8
BF16_ULP = 2.0 ** -7        # bf16 keeps 8 significant bits


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's path needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import runtime, storage

    features = runtime.Features()
    print(f"features: {features!r}", flush=True)
    free, total = storage.memory_info(mx.gpu(0))
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "features": {n: f.enabled for n, f in sorted(features.items())},
          "memory_free_bytes": free, "memory_total_bytes": total})
    for need in ("CUDA", "CUDNN", "NVJPEG"):
        if not features.is_enabled(need):
            fail(f"runtime feature {need} is off on this card")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from mxnet_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    out = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_seconds,
          "sources": list(_build.SOURCES),
          "dir": str(out.relative_to(_build.REPO_ROOT))})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

class _L2Flush:
    """Reads a buffer 2.5 times the 50 MB L2 before each timed launch, so
    every timing starts cold, as the serving path finds its inputs after
    a layer's weights have streamed through. A read leaves clean lines: a
    write-based flush would leave the timed kernel paying for dirty-line
    write-backs."""

    def __init__(self):
        self.buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self):
        self.buf.sum()


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each bracketed
    by CUDA events after an L2 flush."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(least time in ms, what bounds it): bytes over the memory rate vs
    operations over the peak rate for the dtype."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(out, ref, rtol, atol) -> tuple:
    """(max |out - ref|, whether every element meets atol + rtol*|ref|)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.all(err <= atol + rtol * ref.abs()))
    return float(err.max()), ok


# tolerances (see tests/test_torch_cuda_kernels.py): f32 differs in the
# order of f32 sums only; bf16 RMS output rounds twice (xhat, then the
# weight product) so two bf16 ulps; paged bf16 output rounds once
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 1e-5)}
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
# LayerNorm and bias+GELU: the same f32 arithmetic (statistics summed in
# another order, erff vs torch.erf), rounded once to bf16: one ulp;
# flash: bf16 P rounds against the running row max in the kernel and the
# final one in the plain version, then the output rounds once more; the
# f32 lse differs in the order of f32 sums
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
GELU_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 1e-6)}
FLASH_TOL = {torch.float32: (2e-5, 2e-5),
             torch.bfloat16: (2.0 ** -6, 2.0 ** -7)}
LSE_TOL = (1e-5, 1e-4)


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def rms_case(rows, d, dtype, flush, gen, rstd=False) -> dict:
    """The RMSNorm forward; with ``rstd`` the training path's call, which
    also writes the f32 row rstd (held against the plain version's to
    1e-5 relative; the output must equal the serving call's bit for
    bit). Each call gives the same bits twice (phase_launch_counts
    counts its kernels); at decode's few rows an empty kernel's device
    time is recorded beside it as the floor any launch pays."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         fused_rms_norm_reference)
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    out = fused_rms_norm(x, w, eps=eps)
    torch.cuda.synchronize()
    ref, ref_rstd = fused_rms_norm_reference(x, w, eps=eps,
                                             return_rstd=True)
    err, ok = within(out, ref, *RMS_TOL[dtype])
    rec = {"phase": "kernels", "kernel": "fused_rms_norm",
           "shape": [rows, d], "dtype": str(dtype).split(".")[-1],
           "rstd": rstd}
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = rows * d * size * 2 + d * size
    if rstd:
        out2, got_rstd = _rms_norm_fwd(x, w, eps, True)
        torch.cuda.synchronize()
        rstd_err, rstd_ok = within(got_rstd, ref_rstd, 1e-5, 0.0)
        ok = ok and rstd_ok and torch.equal(out2, out)
        rec["rstd_max_abs_err"] = rstd_err
        n_bytes += 4 * rows
        kern = lambda: _rms_norm_fwd(x, w, eps, True)      # noqa: E731
    else:
        kern = lambda: fused_rms_norm(x, w, eps=eps)        # noqa: E731
    b_ms, b_by = bound(n_bytes, 4.0 * rows * d, torch.float32)

    def library():
        return F.rms_norm(x, (d,), w, eps)

    # the same bits on a second call
    same = torch.equal(fused_rms_norm(x, w, eps=eps), out)
    ok = ok and same
    rec["same_bits_twice"] = same
    rec.update({
        "max_abs_err": err, "rtol_atol": list(RMS_TOL[dtype]), "ok": ok,
        "ms": time_ms(kern, flush),
        "plain_ms": time_ms(lambda: fused_rms_norm_reference(
            x, w, eps=eps, return_rstd=rstd), flush),
        "library_ms": time_ms(library, flush),
        "device_ms": _queued_ms(kern, flush),
        "library_device_ms": _queued_ms(library, flush),
        "bound_ms": b_ms, "bound_by": b_by})
    if rows <= 8:
        # what an empty kernel takes under _queued_ms: the practical floor
        # (after the timings above, whose first launches load the flush's
        # kernels: a lazy module load inside _queued_ms's window blocks
        # the host until the sleep ends)
        rec["empty_kernel_device_ms"] = _queued_ms(
            lambda: torch.cuda._sleep(0), flush)
    emit(rec)
    return rec


def rms_bwd_case(rows, d, dtype, flush, gen) -> dict:
    """The RMSNorm backward from the forward's saved rstd, dx and dw
    against the plain version (BWD_TOL of each one's largest magnitude).
    Library yardstick: F.rms_norm forward and its autograd backward on
    the same inputs (timed only; no single call gives the backward
    alone). Bytes: x and dy read, dx written, the rstd and the weight
    once; ~10 f32 operations per element (xhat, wdy, two products and a
    sum for the row mean, the dx expression, the dw sum)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_rms_norm_bwd,
                                         fused_rms_norm_bwd_reference)
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    x = (1.5 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    _, rstd = _rms_norm_fwd(x, w, 1e-5, True)
    got = fused_rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_rms_norm_bwd_reference(x, w, rstd, dy))
    same = _same_bits(got, fused_rms_norm_bwd(x, w, rstd, dy))
    leaves = [t.detach().requires_grad_() for t in (x, w)]

    def library():
        y = F.rms_norm(leaves[0], (d,), leaves[1], 1e-5)
        torch.autograd.grad(y, leaves, dy)

    size = _size(dtype)
    n_bytes = 3 * rows * d * size + 4 * rows + 2 * d * size
    b_ms, b_by = bound(n_bytes, 10.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_rms_norm_bwd",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "max_err_over_max_ref": rel, "tol": BWD_TOL[dtype],
           "same_bits_twice": same, "ok": rel <= BWD_TOL[dtype] and same,
           "ms": time_ms(lambda: fused_rms_norm_bwd(x, w, rstd, dy), flush),
           "plain_ms": time_ms(lambda: fused_rms_norm_bwd_reference(
               x, w, rstd, dy), flush),
           "library_ms": time_ms(library, flush),
           "device_ms": _queued_ms(lambda: fused_rms_norm_bwd(x, w, rstd,
                                                              dy), flush),
           "library_device_ms": _queued_ms(library, flush),
           "library": "F.rms_norm forward + its autograd backward",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def paged_case(b, dtype, flush, rs, gen) -> dict:
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (paged_attention_kernel,
                                         paged_attention_reference,
                                         paged_splits)

    h, kv, d, ps, max_len = 32, 8, 128, 16, 1024
    lengths = rs.randint(1, max_len + 1, size=b).astype(np.int32)
    if b > 1:
        lengths[-1] = 0                 # one empty (padding) row
    width = max_len // ps
    # scattered pages: a random permutation of the arena's pages
    table = rs.permutation(np.arange(1, 1 + b * width)).astype(
        np.int32).reshape(b, width)
    n_slots = (1 + b * width) * ps
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(n_slots, kv, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(n_slots, kv, d, device="cuda", generator=gen).to(dtype)
    pt = torch.from_numpy(table).cuda()
    ln = torch.from_numpy(lengths).cuda()
    scale = 1.0 / np.sqrt(d)

    def kern():
        return paged_attention_kernel(q, k, v, pt, ln, page_size=ps,
                                      scale=scale)

    def plain():
        return paged_attention_reference(q, k, v, pt, ln, page_size=ps,
                                         scale=scale)

    # the wrapper never reads lengths on the host: no synchronising call
    # (torch raises on one in this mode)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = kern()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    err, ok = within(out, plain(), *PAGED_TOL[dtype])
    if b > 1:                                            # empty row -> 0
        ok = ok and int(torch.count_nonzero(out[-1])) == 0
    ok = ok and torch.equal(kern(), out)                 # the same bits
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed) with a length mask and grouped-query heads
    slots = (pt.long()[:, :, None] * ps
             + torch.arange(ps, device="cuda")).reshape(b, -1)
    kg = k[slots].transpose(1, 2).contiguous()          # (B, KV, T, D)
    vg = v[slots].transpose(1, 2).contiguous()
    mask = (torch.arange(slots.shape[1], device="cuda")[None, :]
            < ln.long()[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    size = torch.tensor([], dtype=dtype).element_size()
    tot = int(lengths.sum())
    n_pages_read = int(sum(-(-int(n) // ps) for n in lengths))
    n_bytes = (2 * tot * kv * d * size + 2 * b * h * d * size
               + 4 * (n_pages_read + b))
    b_ms, b_by = bound(n_bytes, 4.0 * tot * h * d, dtype)
    rec = {"phase": "kernels", "kernel": "paged_attention_kernel",
           "shape": {"B": b, "H": h, "KV": kv, "D": d, "page_size": ps,
                     "sum_len": tot},
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "rtol_atol": list(PAGED_TOL[dtype]), "ok": ok,
           "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(library, flush),
           "device_ms": _queued_ms(kern, flush),
           "library_device_ms": _queued_ms(library, flush),
           "bound_ms": b_ms, "bound_by": b_by}
    rec["splits"] = paged_splits(b, kv, width, ps, torch.cuda.
                                 get_device_properties(0).multi_processor_count)
    rec["ctas"] = b * kv * rec["splits"]
    emit(rec)
    return rec


def ln_case(rows, d, dtype, with_res, flush, gen) -> dict:
    """LayerNorm(x + residual) over (rows, d), gamma/beta in x's dtype.
    Library yardstick: F.layer_norm without the residual (no single
    PyTorch call adds a residual, so that case records null)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_reference)

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    out = fused_layer_norm(x, g, b, r, eps=eps)
    torch.cuda.synchronize()
    err, ok = within(out, fused_layer_norm_reference(x, g, b, r, eps=eps),
                     *LN_TOL[dtype])
    size = _size(dtype)
    n_bytes = rows * d * size * (3 if with_res else 2) + 2 * d * size
    # sum (+ residual add), centre, square-accumulate, normalise, scale,
    # shift: ~7 f32 operations per element
    b_ms, b_by = bound(n_bytes, 7.0 * rows * d, torch.float32)

    def kern():
        return fused_layer_norm(x, g, b, r, eps=eps)

    def library():
        return F.layer_norm(x, (d,), g, b, eps)

    rec = {"phase": "kernels", "kernel": "fused_layer_norm",
           "shape": [rows, d], "residual": with_res, "dtype": _dname(dtype),
           "max_abs_err": err, "rtol_atol": list(LN_TOL[dtype]), "ok": ok,
           "ms": time_ms(kern, flush),
           "plain_ms": time_ms(lambda: fused_layer_norm_reference(
               x, g, b, r, eps=eps), flush),
           "library_ms": None if with_res else time_ms(library, flush),
           "device_ms": _queued_ms(kern, flush),
           "library_device_ms": None if with_res else _queued_ms(library,
                                                                 flush),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def gelu_case(rows, d, dtype, flush, gen) -> dict:
    """gelu(x + b) over (rows, d). No single PyTorch call computes this
    function (F.gelu takes no bias), so library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_bias_gelu,
                                         fused_bias_gelu_reference)

    x = (2 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    bias = torch.randn(d, device="cuda", generator=gen).to(dtype)
    out = fused_bias_gelu(x, bias)
    torch.cuda.synchronize()
    err, ok = within(out, fused_bias_gelu_reference(x, bias),
                     *GELU_TOL[dtype])
    size = _size(dtype)
    # add, scale, erf (counted as one), add, two multiplies
    b_ms, b_by = bound(2 * rows * d * size + d * size, 6.0 * rows * d,
                       torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_bias_gelu",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "rtol_atol": list(GELU_TOL[dtype]), "ok": ok,
           "ms": time_ms(lambda: fused_bias_gelu(x, bias), flush),
           "plain_ms": time_ms(lambda: fused_bias_gelu_reference(x, bias),
                               flush),
           "library_ms": None,
           "device_ms": _queued_ms(lambda: fused_bias_gelu(x, bias), flush),
           "library_device_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _flash_inputs(b, h, l, d, layout, dtype, gen, n, views):
    """``n`` tensors in ``layout``: "blhd" with ``views`` as
    MultiHeadAttention makes q, k and v, (b, l, h, d) views into one
    (b, l, 3*h*d) fused QKV output (sequence stride 3*h*d, k and v h*d
    and 2*h*d elements in), and any further ones contiguous; "blhd"
    without ``views`` contiguous (b, l, h, d) tensors, as the Llama path
    hands them over (rope's outputs and the repeated KV heads); "bhld"
    contiguous (b, h, l, d) tensors."""
    if layout == "blhd" and views:
        qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                          generator=gen).to(dtype)
        out = [t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1)]
        return out + [torch.randn(b, l, h, d, device="cuda",
                                  generator=gen).to(dtype)
                      for _ in range(n - 3)]
    shape = (b, l, h, d) if layout == "blhd" else (b, h, l, d)
    return [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            for _ in range(n)]


def flash_case(b, h, l, d, causal, layout, dtype, flush, gen,
               views=True, lk=None) -> dict:
    """Flash attention forward, output and lse against the plain version
    on the same inputs (``_flash_inputs``: "blhd" on fused-QKV views, or
    contiguous with ``views`` False; "bhld" contiguous), and the same
    bits on a second call. ``lk`` gives the keys (contiguous, no views)
    another length than the queries' ``l``; causal masking then aligns
    bottom-right. Library yardstick: F.scaled_dot_product_attention on
    the same inputs (timed only; the port never calls it), with
    causal_lower_right's mask where lk != l. Operations count the key
    positions this run visits: all lk for every row, or the causal
    triangle's."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from mxnet_tpu_torch.kernels import (flash_attention_fwd,
                                         flash_attention_reference)
    from mxnet_tpu_torch.kernels.flash import fwd_route

    lk = l if lk is None else lk
    if lk == l:
        q, k, v = _flash_inputs(b, h, l, d, layout, dtype, gen, 3, views)
    else:
        q, = _flash_inputs(b, h, l, d, layout, dtype, gen, 1, False)
        k, v = _flash_inputs(b, h, lk, d, layout, dtype, gen, 2, False)
    sdpa_in = [t.transpose(1, 2) for t in (q, k, v)] \
        if layout == "blhd" else [q, k, v]
    sdpa_kw = {"attn_mask": causal_lower_right(l, lk)} \
        if causal and lk != l else {"is_causal": causal}
    kw = {"causal": causal, "layout": layout}

    def kern():
        return flash_attention_fwd(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(*sdpa_in, **sdpa_kw)

    out, lse = kern()
    again, lse_again = kern()
    torch.cuda.synchronize()
    same = torch.equal(out, again) and torch.equal(lse, lse_again)
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    err, ok = within(out, ref, *FLASH_TOL[dtype])
    lse_err, lse_ok = within(lse, rlse, *LSE_TOL)
    off = lk - l
    pairs = l * (off + 1) + l * (l - 1) // 2 if causal else l * lk
    n_ops = 4.0 * b * h * pairs * d
    n_bytes = 2 * b * h * (l + lk) * d * _size(dtype) + 4 * b * h * l
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "shape": [b, h, l, d], "lk": lk, "layout": layout,
           "views": views, "q_strides": list(q.stride()), "causal": causal,
           "dtype": _dname(dtype), "route": fwd_route(dtype, d),
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "rtol_atol": list(FLASH_TOL[dtype]),
           "lse_rtol_atol": list(LSE_TOL), "same_bits_twice": same,
           "ok": ok and lse_ok and same,
           "ms": time_ms(kern, flush),
           "plain_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, **kw), flush),
           "library_ms": time_ms(library, flush),
           "device_ms": _queued_ms(kern, flush),
           "library_device_ms": _queued_ms(library, flush),
           "bound_ms": b_ms, "bound_by": b_by, "gflop": n_ops / 1e9,
           "mbytes": n_bytes / 1e6}
    emit(rec)
    return rec


# backward kernels: max |kernel - plain| over max |plain| (the gradients
# sum over many rows, so an elementwise test near 0 says nothing). f32:
# sums in other orders; bf16: P and dS (flash), or dx, dgamma and dbeta
# (LayerNorm, bias+GELU), round once from f32 values summed in another
# order, and each gradient rounds once more: two bf16 ulps of the
# largest magnitude
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def max_rel(outs, refs) -> tuple:
    """(largest max |out - ref|, whether each out is finite and within
    its BWD tolerance of max |ref|) over pairs, as f32."""
    errs, rels = [], []
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        errs.append(float((o - r).abs().max()))
        rels.append(errs[-1] / max(float(r.abs().max()), 1e-30)
                    if bool(torch.isfinite(o).all()) else float("inf"))
    return max(errs), max(rels)


def _grad_timer(out, inputs, grad):
    """A callable running autograd's backward of ``out`` with respect to
    ``inputs`` for ``grad`` (the graph is kept, so it can run again)."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def flash_bwd_case(b, h, l, d, causal, layout, dtype, flush, gen,
                   views=True) -> dict:
    """Flash attention backward (dq, dk, dv) against its plain version on
    the forward's own output and lse, on flash_case's inputs. Library
    yardstick: the autograd backward of F.scaled_dot_product_attention on
    the same inputs (timed only). Operations: the five products of the
    causal triangle or the full square; bytes: q, k, v, o, dO and lse
    read, dq, dk, dv written."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (flash_attention_bwd,
                                         flash_attention_bwd_reference,
                                         flash_attention_fwd)
    from mxnet_tpu_torch.kernels.flash import bwd_route

    q, k, v, do = _flash_inputs(b, h, l, d, layout, dtype, gen, 4, views)
    if layout == "blhd":
        to_sdpa = lambda t: t.transpose(1, 2)           # noqa: E731
    else:
        to_sdpa = lambda t: t                           # noqa: E731
    kw = {"causal": causal, "layout": layout}
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    err, rel = max_rel(got, flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do, **kw))
    same = all(torch.equal(a, b) for a, b in zip(
        got, flash_attention_bwd(q, k, v, o, lse, do, **kw)))
    leaves = [to_sdpa(t).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    pairs = l * (l + 1) // 2 if causal else l * l
    n_ops = 5 * 2.0 * b * h * pairs * d
    n_bytes = 8 * b * h * l * d * _size(dtype) + 4 * b * h * l
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention_bwd",
           "shape": [b, h, l, d], "layout": layout, "views": views,
           "causal": causal,
           "dtype": _dname(dtype), "route": bwd_route(dtype, d),
           "max_abs_err": err, "max_err_over_max_ref": rel,
           "tol": BWD_TOL[dtype], "same_bits_twice": same,
           "ok": rel <= BWD_TOL[dtype] and same,
           "ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     **kw), flush),
           "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
               q, k, v, o, lse, do, **kw), flush),
           "library_ms": time_ms(_grad_timer(sdpa_out, leaves, to_sdpa(do)),
                                 flush),
           "device_ms": _queued_ms(lambda: flash_attention_bwd(
               q, k, v, o, lse, do, **kw), flush),
           "library_device_ms": _queued_ms(
               _grad_timer(sdpa_out, leaves, to_sdpa(do)), flush),
           "library": "autograd backward of F.scaled_dot_product_attention",
           "bound_ms": b_ms, "bound_by": b_by, "gflop": n_ops / 1e9,
           "mbytes": n_bytes / 1e6}
    emit(rec)
    return rec


def ln_bwd_case(rows, d, dtype, with_res, flush, gen) -> dict:
    """LayerNorm(x + residual) backward from the forward's f32 row
    statistics. Library yardstick: autograd's backward of F.layer_norm
    without the residual (null with it: no single call adds one)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_layer_norm_bwd_reference)

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    _, mean, rstd = fused_layer_norm(x, g, b, r, return_stats=True)
    got = fused_layer_norm_bwd(x, g, mean, rstd, dy, r)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_layer_norm_bwd_reference(x, g, mean, rstd,
                                                           dy, r))
    same = _same_bits(got, fused_layer_norm_bwd(x, g, mean, rstd, dy, r))
    library = library_dev = None
    if not with_res:
        leaves = [t.detach().requires_grad_() for t in (x, g, b)]
        y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
        library = time_ms(_grad_timer(y, leaves, dy), flush)
        library_dev = _queued_ms(_grad_timer(y, leaves, dy), flush)
    size = _size(dtype)
    n_bytes = rows * d * size * (4 if with_res else 3) + 8 * rows \
        + 3 * d * size
    # recentre, scale, two products and two sums for the row means, the
    # dh expression, two column sums: ~12 f32 operations per element
    b_ms, b_by = bound(n_bytes, 12.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_layer_norm_bwd",
           "shape": [rows, d], "residual": with_res, "dtype": _dname(dtype),
           "max_abs_err": err, "max_err_over_max_ref": rel,
           "tol": BWD_TOL[dtype], "same_bits_twice": same,
           "ok": rel <= BWD_TOL[dtype] and same,
           "ms": time_ms(lambda: fused_layer_norm_bwd(x, g, mean, rstd, dy,
                                                      r), flush),
           "plain_ms": time_ms(lambda: fused_layer_norm_bwd_reference(
               x, g, mean, rstd, dy, r), flush),
           "library_ms": library,
           "device_ms": _queued_ms(lambda: fused_layer_norm_bwd(
               x, g, mean, rstd, dy, r), flush),
           "library_device_ms": library_dev,
           "library": "null: no single PyTorch call adds a residual"
                      if with_res else "autograd backward of F.layer_norm",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def gelu_bwd_case(rows, d, dtype, flush, gen) -> dict:
    """bias+GELU backward, recomputed from (x, bias). No single PyTorch
    call computes it (F.gelu takes no bias), so library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_bias_gelu_bwd,
                                         fused_bias_gelu_bwd_reference)

    x = (2 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    bias = torch.randn(d, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    got = fused_bias_gelu_bwd(x, bias, dy)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_bias_gelu_bwd_reference(x, bias, dy))
    size = _size(dtype)
    # add, erf and exp (one each), ~6 multiplies and adds, the bias sum
    b_ms, b_by = bound(3 * rows * d * size + d * size, 10.0 * rows * d,
                       torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_bias_gelu_bwd",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "max_err_over_max_ref": rel, "tol": BWD_TOL[dtype],
           "ok": rel <= BWD_TOL[dtype],
           "ms": time_ms(lambda: fused_bias_gelu_bwd(x, bias, dy), flush),
           "plain_ms": time_ms(lambda: fused_bias_gelu_bwd_reference(
               x, bias, dy), flush),
           "library_ms": None,
           "device_ms": _queued_ms(lambda: fused_bias_gelu_bwd(x, bias, dy),
                                   flush),
           "library_device_ms": None,
           "library": "null: no single PyTorch call (F.gelu takes no bias)",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the dropout modes (position-hash dropout) against their plain versions
# ---------------------------------------------------------------------------

DROP_P = 0.1
# integer operations of the murmur hash and the keep test per element;
# counted at the CUDA cores' f32 rate (the card's table has no int32 row)
HASH_OPS = 12.0


def bound_mixed(n_bytes: float, ops) -> tuple:
    """(least time in ms, what bounds it) for work on several units at
    once: ``ops`` is [(operations, dtype), ...], each over its own peak
    rate; the least time is the largest of those and the bytes' time."""
    best = (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes")
    for n_ops, dtype in ops:
        t = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
        if t > best[0]:
            best = (t, "operations")
    return best


def hash_dropout_case(shape, dtype, flush, gen) -> dict:
    """The Dropout op's kernel at p = 0.1 against its plain version: bit
    for bit, so its zeros are the plain version's mask. Library
    yardstick: F.dropout (it draws its own Philox mask; the work is the
    same)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import hash_dropout, hash_dropout_reference

    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    seed = 0x5EED
    out = hash_dropout(x, DROP_P, seed)
    torch.cuda.synchronize()
    ref = hash_dropout_reference(x, DROP_P, seed)
    same = torch.equal(out, ref)
    mask_same = torch.equal(out == 0, ref == 0)
    n = x.numel()
    b_ms, b_by = bound_mixed(2.0 * n * _size(dtype),
                             [(HASH_OPS * n, torch.float32)])
    rec = {"phase": "kernels", "kernel": "hash_dropout", "shape": list(shape),
           "dtype": _dname(dtype), "p": DROP_P, "bit_identical": same,
           "mask_identical": mask_same,
           "drop_share": float((ref == 0).float().mean()),
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "ok": same and mask_same,
           "ms": time_ms(lambda: hash_dropout(x, DROP_P, seed), flush),
           "plain_ms": time_ms(lambda: hash_dropout_reference(x, DROP_P,
                                                              seed), flush),
           "library_ms": time_ms(lambda: F.dropout(x, DROP_P, training=True),
                                 flush),
           "device_ms": _queued_ms(lambda: hash_dropout(x, DROP_P, seed),
                                   flush),
           "library_device_ms": _queued_ms(
               lambda: F.dropout(x, DROP_P, training=True), flush),
           "library": "F.dropout (its own Philox mask)",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def ln_drop_cases(rows, d, dtype, with_res, flush, gen) -> list:
    """LayerNorm(dropout(x) + residual) at p = 0.1, forward and backward,
    against the plain versions (LN_TOL forward; BWD_TOL backward, dres
    included); the zeros of dx must be the mask of the flat (row, col)
    ids bit for bit. No single PyTorch call drops and normalises, so
    library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_layer_norm_bwd_reference,
                                         fused_layer_norm_reference)
    from mxnet_tpu_torch.kernels.dropout import dropout_thresh, row_keep_mask

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    seed = 0xD0D0 + int(with_res)
    kw = {"dropout": DROP_P, "seed": seed}
    out, mean, rstd = fused_layer_norm(x, g, b, r, return_stats=True, **kw)
    got = fused_layer_norm_bwd(x, g, mean, rstd, dy, r, DROP_P, seed)
    torch.cuda.synchronize()
    f_err, f_ok = within(out, fused_layer_norm_reference(x, g, b, r, **kw),
                         *LN_TOL[dtype])
    want = fused_layer_norm_bwd_reference(x, g, mean, rstd, dy, r, DROP_P,
                                          seed)
    b_err, rel = max_rel(got, want)
    keep = row_keep_mask(rows, d, seed, dropout_thresh(DROP_P), "cuda")
    mask_same = bool(torch.equal(got[0] != 0, keep)
                     and torch.equal(want[0] != 0, keep))
    same = _same_bits(got, fused_layer_norm_bwd(x, g, mean, rstd, dy, r,
                                                DROP_P, seed))
    size = _size(dtype)
    f_ms, f_by = bound_mixed(
        rows * d * size * (3 if with_res else 2) + 2 * d * size,
        [(7.0 * rows * d, torch.float32), (HASH_OPS * rows * d,
                                            torch.float32)])
    # x, dy (and the residual) read; dx (and dres) written
    bw_ms, bw_by = bound_mixed(
        rows * d * size * (5 if with_res else 3) + 8 * rows + 3 * d * size,
        [(12.0 * rows * d, torch.float32), (HASH_OPS * rows * d,
                                             torch.float32)])
    common = {"phase": "kernels", "shape": [rows, d], "residual": with_res,
              "dtype": _dname(dtype), "p": DROP_P, "library_ms": None,
              "library": "null: no single PyTorch call drops and "
                         "normalises"}
    fwd = dict(common, kernel="fused_layer_norm[dropout]",
               max_abs_err=f_err, rtol_atol=list(LN_TOL[dtype]), ok=f_ok,
               ms=time_ms(lambda: fused_layer_norm(x, g, b, r, **kw), flush),
               plain_ms=time_ms(lambda: fused_layer_norm_reference(
                   x, g, b, r, **kw), flush),
               device_ms=_queued_ms(lambda: fused_layer_norm(
                   x, g, b, r, **kw), flush), library_device_ms=None,
               bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, kernel="fused_layer_norm_bwd[dropout]",
               max_abs_err=b_err, max_err_over_max_ref=rel,
               tol=BWD_TOL[dtype], mask_identical=mask_same,
               same_bits_twice=same,
               ok=rel <= BWD_TOL[dtype] and mask_same and same,
               ms=time_ms(lambda: fused_layer_norm_bwd(
                   x, g, mean, rstd, dy, r, DROP_P, seed), flush),
               plain_ms=time_ms(lambda: fused_layer_norm_bwd_reference(
                   x, g, mean, rstd, dy, r, DROP_P, seed), flush),
               device_ms=_queued_ms(lambda: fused_layer_norm_bwd(
                   x, g, mean, rstd, dy, r, DROP_P, seed), flush),
               library_device_ms=None,
               bound_ms=bw_ms, bound_by=bw_by)
    emit(fwd)
    emit(bwd)
    return [fwd, bwd]


def flash_drop_cases(b, h, l, d, causal, layout, dtype, flush,
                     gen) -> list:
    """Flash attention forward and backward at p = 0.1 against the plain
    versions, "blhd" on BERT's fused-QKV views as flash_case builds them;
    the forward gives the same bits (output, so mask, and lse) on a
    second call. Library yardstick: F.scaled_dot_product_attention with
    dropout_p=0.1 and its autograd backward (SDPA draws its own mask;
    only the work is the same). Operations: the products as without
    dropout, plus one hash per score, forward and backward."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (flash_attention_bwd,
                                         flash_attention_bwd_reference,
                                         flash_attention_fwd,
                                         flash_attention_reference)
    from mxnet_tpu_torch.kernels.flash import fwd_route

    if layout == "blhd":
        qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                          generator=gen).to(dtype)
        q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
        to_sdpa = lambda t: t.transpose(1, 2)           # noqa: E731
    else:
        q, k, v, do = (torch.randn(b, h, l, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        to_sdpa = lambda t: t                           # noqa: E731
    kw = {"causal": causal, "layout": layout, "dropout": DROP_P,
          "seed": 0xF1A5 + l}
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    f_err, f_ok = within(o, ref, *FLASH_TOL[dtype])
    lse_err, lse_ok = within(lse, rlse, *LSE_TOL)
    b_err, rel = max_rel(got, flash_attention_bwd_reference(q, k, v, o, lse,
                                                            do, **kw))
    leaves = [to_sdpa(t).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              dropout_p=DROP_P)
    pairs = l * (l + 1) // 2 if causal else l * l
    scores = b * h * pairs
    size = _size(dtype)
    f_ms, f_by = bound_mixed(4 * b * h * l * d * size + 4 * b * h * l,
                             [(4.0 * scores * d, dtype),
                              (HASH_OPS * scores, torch.float32)])
    bw_ms, bw_by = bound_mixed(8 * b * h * l * d * size + 4 * b * h * l,
                               [(10.0 * scores * d, dtype),
                                (HASH_OPS * scores, torch.float32)])
    common = {"phase": "kernels", "shape": [b, h, l, d], "layout": layout,
              "causal": causal, "dtype": _dname(dtype), "p": DROP_P}
    def library():
        return F.scaled_dot_product_attention(
            *[to_sdpa(t) for t in (q, k, v)], is_causal=causal,
            dropout_p=DROP_P)

    fwd = dict(common, kernel="flash_attention[dropout]",
               route=fwd_route(dtype, d), max_abs_err=f_err,
               lse_max_abs_err=lse_err, rtol_atol=list(FLASH_TOL[dtype]),
               same_bits_twice=same, ok=f_ok and lse_ok and same,
               ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), flush),
               plain_ms=time_ms(lambda: flash_attention_reference(
                   q, k, v, **kw), flush),
               library_ms=time_ms(library, flush),
               device_ms=_queued_ms(lambda: flash_attention_fwd(
                   q, k, v, **kw), flush),
               library_device_ms=_queued_ms(library, flush),
               library="F.scaled_dot_product_attention(dropout_p=0.1)",
               bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, kernel="flash_attention_bwd[dropout]",
               max_abs_err=b_err, max_err_over_max_ref=rel,
               tol=BWD_TOL[dtype], ok=rel <= BWD_TOL[dtype],
               ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw), flush),
               plain_ms=time_ms(lambda: flash_attention_bwd_reference(
                   q, k, v, o, lse, do, **kw), flush),
               library_ms=time_ms(_grad_timer(sdpa_out, leaves, to_sdpa(do)),
                                  flush),
               device_ms=_queued_ms(lambda: flash_attention_bwd(
                   q, k, v, o, lse, do, **kw), flush),
               library_device_ms=_queued_ms(
                   _grad_timer(sdpa_out, leaves, to_sdpa(do)), flush),
               library="autograd backward of F.scaled_dot_product_attention"
                       "(dropout_p=0.1)",
               bound_ms=bw_ms, bound_by=bw_by)
    emit(fwd)
    emit(bwd)
    return [fwd, bwd]


def flash_mask_case(d, dtype, flush, gen) -> dict:
    """The flash forward's mask, bit for bit: with lk = d and V the
    identity, O is the dropped, normalised P, so its zeros are the mask;
    the kernel's zeros must be the plain version's (q and k are small,
    so no kept P underflows to 0), and a second call's output the
    first's, bit for bit."""
    from mxnet_tpu_torch.kernels import (flash_attention_fwd,
                                         flash_attention_reference)
    from mxnet_tpu_torch.kernels.flash import fwd_route

    b, h, lq = 32, 12, 512
    q = (0.1 * torch.randn(b, h, lq, d, device="cuda",
                           generator=gen)).to(dtype)
    k = (0.1 * torch.randn(b, h, d, d, device="cuda",
                           generator=gen)).to(dtype)
    v = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous().to(
        dtype)
    kw = {"dropout": DROP_P, "seed": 0xA5A5 + d}

    def kern():
        return flash_attention_fwd(q, k, v, **kw)

    out, _ = kern()
    twice = torch.equal(kern()[0], out)
    torch.cuda.synchronize()
    ref, _ = flash_attention_reference(q, k, v, **kw)
    same = bool(torch.equal(out == 0, ref == 0))
    scores = b * h * lq * d
    b_ms, b_by = bound_mixed(
        (2 * b * h * lq * d + 2 * b * h * d * d) * _size(dtype) + 4 * b * h
        * lq, [(4.0 * scores * d, dtype), (HASH_OPS * scores,
                                            torch.float32)])
    rec = {"phase": "kernels", "kernel": "flash_attention[dropout, mask]",
           "shape": [b, h, lq, d], "lk": d, "v": "identity",
           "dtype": _dname(dtype), "route": fwd_route(dtype, d), "p": DROP_P,
           "mask_identical": same, "same_bits_twice": twice,
           "drop_share": float((ref == 0).float().mean()),
           "ok": same and twice, "ms": time_ms(kern, flush),
           "plain_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, **kw), flush), "library_ms": None,
           "device_ms": _queued_ms(kern, flush),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _pretrain_params() -> list:
    """(name, shape) of each trainable parameter of BERTForPretrainFused
    at bert_12_768_12's widths (the tied projection counted once)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    net = BERTForPretrainFused(dropout=0.0, ctx="cuda",
                               dtype=torch.bfloat16)
    out = [(name, tuple(p.shape)) for name, p in net.named_parameters()]
    del net
    torch.cuda.empty_cache()
    return out


def _pretrain_shapes() -> list:
    return [s for _, s in _pretrain_params()]



def adam_case(flush, gen) -> dict:
    """The fused Adam sweep over BERTForPretrainFused's bf16
    multi-precision parameter set (f32 masters and moments, bf16 grads,
    the bf16 weights written in the same pass), held bit for bit against
    its plain version from the same state. Library yardstick:
    torch._fused_adam_ over the same members as f32 weights and f32
    grads, with no bf16 weight to write (24 bytes per element against
    the sweep's 28): the nearest single PyTorch call, timed only."""
    from mxnet_tpu_torch.kernels import adam_sweep_reference, fused_adam_sweep

    shapes = _pretrain_shapes()
    n = sum(int(np.prod(s)) for s in shapes)

    def members(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ws = [torch.randn(s, device="cuda", generator=g) for s in shapes]
        gs = [torch.randn(s, device="cuda", generator=g).to(torch.bfloat16)
              for s in shapes]
        ms = [0.01 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        vs = [1e-4 * torch.rand(s, device="cuda", generator=g)
              for s in shapes]
        return ws, gs, ms, vs, [w.to(torch.bfloat16) for w in ws]

    lrs = [1e-4 * (1 - 0.999) ** 0.5 / (1 - 0.9)] * len(shapes)
    wds = [0.0] * len(shapes)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0)
    a = members(5)
    fused_adam_sweep(*a, lrs, wds, **kw)
    b = members(5)
    adam_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for grp in range(5)
               for x, y in zip(a[grp], b[grp]))
    err = max(float((x.float() - y.float()).abs().max())
              for grp in (0, 2, 3, 4) for x, y in zip(a[grp], b[grp]))
    del b
    ms = time_ms(lambda: fused_adam_sweep(*a, lrs, wds, **kw), flush)
    plain_ms = time_ms(lambda: adam_sweep_reference(*a, lrs, wds, **kw),
                       flush, iters=5, warmup=1)
    ws, gs, m1, v1, _ = a
    g32 = [g.float() for g in gs]
    steps = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = time_ms(lambda: torch._fused_adam_(
        ws, g32, m1, v1, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), flush)
    # bf16 grad read; f32 master, mean, var read and written; bf16 weight
    # written. ~15 f32 operations per element
    b_ms, b_by = bound(28.0 * n, 15.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_adam_sweep",
           "shape": [n], "members": len(shapes), "dtype": "bfloat16-mp",
           "bit_identical": same, "max_abs_err": err, "ok": same,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_adam_ on f32 weights and f32 grads, "
                      "no bf16 weight written",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 28.0 * n / 1e9}
    emit(rec)
    del a, ws, gs, m1, v1, g32
    torch.cuda.empty_cache()
    return rec


def _proxy1b_shapes() -> list:
    """The trainable parameter shapes of the proxy1b Llama (tools/
    pretrain_llama.py's config, 700.5M parameters)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_proxy1b

    net = llama_proxy1b(ctx="cuda", dtype=torch.bfloat16)
    shapes = [tuple(p.shape) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return shapes


def adamw_case(flush, gen) -> dict:
    """The AdamW scan and sweep over the proxy1b Llama's bf16
    multi-precision parameter set (f32 masters and moments, bf16 grads,
    the bf16 weights written in the same pass), with the pretraining tool's
    hyperparameters, held bit for bit against the plain version from the
    same state. The final norm's gradient holds a NaN and the first
    attn_norm's an inf: both members must keep their weights and moments
    bit for bit (no clip). Library yardstick: torch._fused_adamw_ over
    the same members as f32 weights and f32 grads, with no bf16 weight
    to write and no overflow scan (24 bytes per element against 30), and
    torch.optim.AdamW's semantics (wd times the uncorrected lr, eps
    inside the bias correction): the nearest single call, timed only.
    Bytes: the scan reads the bf16 grad (2 per element), the sweep 28."""
    from mxnet_tpu_torch.kernels import (adamw_sweep_reference,
                                         fused_adamw_sweep)

    shapes = _proxy1b_shapes()
    n = sum(int(np.prod(s)) for s in shapes)
    nan_j, inf_j = len(shapes) - 2, 1       # norm.weight, blocks.0.attn_norm

    def members(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ws = [0.02 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        gs = [(1e-3 * torch.randn(s, device="cuda", generator=g)).to(
            torch.bfloat16) for s in shapes]
        gs[nan_j].view(-1)[7] = float("nan")
        gs[inf_j].view(-1)[3] = float("inf")
        ms = [1e-4 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        vs = [1e-8 * torch.rand(s, device="cuda", generator=g)
              for s in shapes]
        return ws, gs, ms, vs, [w.to(torch.bfloat16) for w in ws]

    lrs = [3e-4 * (1 - 0.95 ** 3) ** 0.5 / (1 - 0.9 ** 3)] * len(shapes)
    wds = [0.1] * len(shapes)
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-6, rescale_grad=1.0)
    a = members(6)
    start = [[t.clone() for t in (a[0][j], a[2][j], a[3][j])]
             for j in (nan_j, inf_j)]
    fused_adamw_sweep(*a, lrs, wds, **kw)
    b = members(6)
    adamw_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for grp in (0, 2, 3, 4)
               for x, y in zip(a[grp], b[grp]))
    kept = all(torch.equal(x, y) for j, old in zip((nan_j, inf_j), start)
               for x, y in zip((a[0][j], a[2][j], a[3][j]), old))
    err = max(float((x.float() - y.float()).abs().nan_to_num().max())
              for grp in (0, 2, 3, 4) for x, y in zip(a[grp], b[grp]))
    del b, start
    ms = time_ms(lambda: fused_adamw_sweep(*a, lrs, wds, **kw), flush)
    plain_ms = time_ms(lambda: adamw_sweep_reference(*a, lrs, wds, **kw),
                       flush, iters=5, warmup=1)
    ws, gs, m1, v1, _ = a
    g32 = [g.float().nan_to_num() for g in gs]
    steps = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = time_ms(lambda: torch._fused_adamw_(
        ws, g32, m1, v1, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-6, amsgrad=False, maximize=False), flush)
    # ~15 f32 operations per element in the sweep, 3 in the scan
    b_ms, b_by = bound(30.0 * n, 18.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_adamw_sweep",
           "shape": [n], "members": len(shapes), "dtype": "bfloat16-mp",
           "bit_identical": same, "overflowed_members_kept": kept,
           "max_abs_err": err, "ok": same and kept,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_adamw_ on f32 weights and f32 grads, "
                      "no bf16 weight written, no scan, torch's AdamW "
                      "semantics",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 30.0 * n / 1e9,
           "bound_ms_scan": 2.0 * n / HBM_BYTES_PER_S * 1e3,
           "bound_ms_sweep": 28.0 * n / HBM_BYTES_PER_S * 1e3}
    emit(rec)
    del a, ws, gs, m1, v1, g32
    torch.cuda.empty_cache()
    return rec


def _resnet50_members() -> list:
    """ResNet-50 v1's trainable parameters as the main path holds them
    (``resnet50_v1(layout="NHWC")`` in bf16: channels-last convolution
    weights, f32 BatchNorm), one empty tensor of each's shape, dtype and
    memory layout."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = resnet50_v1(layout="NHWC", ctx="cuda", dtype=torch.bfloat16)
    like = [torch.empty_like(p.detach()) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return like


def _bits(t):
    """``t``'s bits as integers, so NaNs compare equal bit for bit."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def sgd_case(flush, gen) -> dict:
    """The fused SGD sweep over ResNet-50's parameter set in the step's
    two buckets, with the path's hyperparameters (lr 0.1, momentum 0.9,
    wd 0): the bf16 multi-precision bucket (25.50M elements: f32 masters
    and momenta, bf16 grads, the bf16 weights written in the same pass,
    the convolution weights channels-last) and the f32 BatchNorm bucket
    (53k elements, f32 momenta), held bit for bit against the plain
    version from the same state, with momentum 0.9 and with none (the
    momentum-free form), and with one member's grad holding a NaN and
    another's an inf (compared as bits: SGD propagates them, as the
    reference). ms: both buckets' launches, as a step runs them.
    Library yardstick: torch._fused_sgd_ over the same f32 masters with
    f32 grads and its own momentum convention (buf = m * buf + g, w -=
    lr * buf), no bf16 weight written: the nearest single PyTorch call,
    timed only. Bytes per element: bf16-mp 20 (read g 2, w 4, mom 4;
    write w 4, mom 4, w_low 2), f32 20 (read g, w, mom; write w, mom)."""
    from mxnet_tpu_torch.kernels import fused_sgd_sweep, sgd_sweep_reference

    like = _resnet50_members()
    low_like = [t for t in like if t.dtype == torch.bfloat16]
    f32_like = [t for t in like if t.dtype == torch.float32]
    n_mp = sum(t.numel() for t in low_like)
    n_f32 = sum(t.numel() for t in f32_like)
    nan_j, inf_j = 3, len(low_like) - 1      # a 1x1 conv, the Dense bias

    def members(seed, momentum):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def rand(t, dtype, scale):
            out = torch.empty_like(t, dtype=torch.float32)
            return (scale * out.normal_(generator=g)).to(dtype)

        mp = [[rand(t, torch.float32, 0.05) for t in low_like],
              [rand(t, torch.bfloat16, 1e-2) for t in low_like],
              [rand(t, torch.float32, 1e-3) for t in low_like]
              if momentum else None]
        mp.append([w.to(torch.bfloat16) for w in mp[0]])
        mp[1][nan_j].view(-1)[5] = float("nan")
        mp[1][inf_j].view(-1)[2] = float("inf")
        f32 = [[1.0 + rand(t, torch.float32, 0.1) for t in f32_like],
               [rand(t, torch.float32, 1e-2) for t in f32_like],
               [rand(t, torch.float32, 1e-3) for t in f32_like]
               if momentum else None, None]
        return mp, f32

    def run(fn, buckets, momentum):
        for ws, gs, moms, lows in buckets:
            fn(ws, gs, moms, lows, [0.1] * len(ws), [0.0] * len(ws),
               momentum=momentum, rescale_grad=1.0)

    same, err = True, 0.0
    for momentum in (0.9, 0.0):
        a, b = members(9, momentum), members(9, momentum)
        run(fused_sgd_sweep, a, momentum)
        run(sgd_sweep_reference, b, momentum)
        torch.cuda.synchronize()
        for ba, bb in zip(a, b):
            for grp in (0, 2, 3):
                if ba[grp] is None:
                    continue
                for x, y in zip(ba[grp], bb[grp]):
                    same &= torch.equal(_bits(x), _bits(y))
                    err = max(err, float((x.float() - y.float()).abs()
                                         .nan_to_num().max()))
        del b
    nan_kept = bool(torch.isnan(a[0][0][nan_j]).any()
                    and torch.isinf(a[0][0][inf_j]).any())
    a = members(9, 0.9)
    ms = time_ms(lambda: run(fused_sgd_sweep, a, 0.9), flush)
    ms_mp = time_ms(lambda: run(fused_sgd_sweep, a[:1], 0.9), flush)
    ms_f32 = time_ms(lambda: run(fused_sgd_sweep, a[1:], 0.9), flush)
    plain_ms = time_ms(lambda: run(sgd_sweep_reference, a, 0.9), flush,
                       iters=5, warmup=1)
    ws = [w.contiguous() for w in a[0][0] + a[1][0]]
    gs = [g.float().nan_to_num().contiguous() for g in a[0][1] + a[1][1]]
    bufs = [m.contiguous() for m in a[0][2] + a[1][2]]
    library_ms = time_ms(lambda: torch._fused_sgd_(
        ws, gs, bufs, weight_decay=0.0, momentum=0.9, lr=0.1,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False),
        flush)
    n = n_mp + n_f32
    # ~6 f32 operations per element
    b_ms, b_by = bound(20.0 * n, 6.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_sgd_sweep",
           "shape": [n_mp, n_f32], "members": [len(low_like),
                                               len(f32_like)],
           "dtype": "bfloat16-mp + float32",
           "bit_identical": same, "nonfinite_propagated": nan_kept,
           "max_abs_err": err, "ok": same and nan_kept,
           "ms": ms, "ms_bf16_mp_bucket": ms_mp, "ms_f32_bucket": ms_f32,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_sgd_ on the f32 masters and f32 "
                      "grads of both buckets, torch's momentum "
                      "convention, no bf16 weight written",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 20.0 * n / 1e9,
           "bound_ms_bf16_mp_bucket": 20.0 * n_mp / HBM_BYTES_PER_S * 1e3}
    emit(rec)
    del a, ws, gs, bufs
    torch.cuda.empty_cache()
    return rec


# LAMB's bias corrections at step t, as collect_scalars ships them: the
# eager Trainer's f32 reciprocals, or TrainStep's divisors
def _lamb_bc(t, recip):
    b1, b2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
    if recip:
        return (float(np.float32(1) / np.float32(b1)),
                float(np.float32(1) / np.float32(b2)))
    return b1, b2


def _lamb_check(members, lrs, wds, **kw) -> dict:
    """Three runs of one LAMB sweep from the same state (``members()``
    makes it anew): the kernel, the plain version fed the kernel's norms,
    the kernel again. Phases 1 and 2 (moments, upd, weights, bf16
    weights) must agree bit for bit with the plain version and the two
    kernel runs with each other, norms included; r1 and r2 are held to
    1e-5 relative of an f64 sum of the same values (NaN where they are
    NaN)."""
    from mxnet_tpu_torch.kernels import fused_lamb_sweep, lamb_sweep_reference

    n = len(lrs)
    bc = _lamb_bc(3, kw.get("bc_recip", True))
    bcs = ([bc[0]] * n, [bc[1]] * n)
    a = members()
    w0 = [w.clone() for w in a[0]]
    upd_k, norms_k = fused_lamb_sweep(*a, lrs, wds, *bcs, **kw)
    b = members()
    upd_p, _ = lamb_sweep_reference(*b, lrs, wds, *bcs, norms=norms_k, **kw)
    torch.cuda.synchronize()
    same, err = True, 0.0
    for grp in (0, 2, 3, 4):
        if a[grp] is None:
            continue
        for x, y in zip(a[grp], b[grp]):
            same &= torch.equal(_bits(x), _bits(y))
            if x.numel():
                err = max(err, float((x.float() - y.float()).abs()
                                     .nan_to_num().max()))
    for x, y in zip(upd_k, upd_p):
        same &= torch.equal(_bits(x), _bits(y))
    want = torch.stack([torch.stack([w.double().square().sum().sqrt(),
                                     u.double().square().sum().sqrt()])
                        for w, u in zip(w0, upd_p)]).float()
    del b, upd_p, w0
    nan_ok = torch.equal(torch.isnan(norms_k), torch.isnan(want))
    ok = ~torch.isnan(want)
    rel = float(((norms_k - want).abs() / want.clamp_min(1e-30))[ok].max())
    c = members()
    _, norms_c = fused_lamb_sweep(*c, lrs, wds, *bcs, **kw)
    torch.cuda.synchronize()
    repeat = torch.equal(_bits(norms_k), _bits(norms_c)) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(a[0], c[0]))
    return {"bit_identical": bool(same), "max_abs_err": err,
            "norms_max_rel_err_vs_f64": rel, "norms_nan_where_f64_nan":
            nan_ok, "second_run_identical": bool(repeat),
            "ok": bool(same and nan_ok and rel <= 1e-5 and repeat)}


def lamb_case(flush, gen) -> dict:
    """The LAMB sweep's three kernels (phase 1 with per-chunk partial
    norms, the per-member norms, phase 2) over BERTForPretrainFused's
    bf16 multi-precision parameter set (f32 masters and moments, bf16
    grads, the bf16 weights written in phase 2) with the Trainer path's
    hyperparameters (lr 1e-3, wd 0.01 and 0 on every beta, gamma and
    bias), in both bias-correction modes (the Trainer's f32 reciprocals,
    TrainStep's divisors), and over a small f32 bucket of ragged members
    (an empty one, one whose weights are all zero, one whose grad holds
    a NaN, one an inf) without bias correction and in both modes with
    both bounds (0.05, 5.0): each against the plain version
    (_lamb_check). ms: the bf16-mp bucket's three launches as the step
    runs them. No single PyTorch call computes LAMB (library_ms null).
    Bytes per element: phase 1 reads g 2, w 4, m 4, v 4 and writes m 4,
    v 4, upd 4; phase 2 reads w 4, upd 4 and writes w 4, w_low 2: 40;
    ~20 f32 operations."""
    from mxnet_tpu_torch.kernels import fused_lamb_sweep, lamb_sweep_reference

    names, shapes = zip(*_pretrain_params())
    n = sum(int(np.prod(s)) for s in shapes)
    lrs = [1e-3] * len(shapes)
    wds = [0.0 if any(k in nm for k in ("beta", "gamma", "bias")) else 0.01
           for nm in names]

    def big():
        g = torch.Generator(device="cuda").manual_seed(11)
        ws = [0.02 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        gs = [(1e-3 * torch.randn(s, device="cuda", generator=g)).to(
            torch.bfloat16) for s in shapes]
        ms = [1e-4 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        vs = [1e-8 * torch.rand(s, device="cuda", generator=g)
              for s in shapes]
        return ws, gs, ms, vs, [w.to(torch.bfloat16) for w in ws]

    small_shapes = [(5,), (0,), (4096,), (4097,), (300,), (9000,), (768,)]
    zero_j, nan_j, inf_j = 4, 5, 6

    def small():
        g = torch.Generator(device="cuda").manual_seed(12)
        ws = [torch.randn(s, device="cuda", generator=g)
              for s in small_shapes]
        ws[zero_j].zero_()
        gs = [torch.randn(s, device="cuda", generator=g)
              for s in small_shapes]
        gs[nan_j][8000] = float("nan")
        gs[inf_j][17] = float("inf")
        ms = [0.1 * torch.randn(s, device="cuda", generator=g)
              for s in small_shapes]
        vs = [torch.rand(s, device="cuda", generator=g)
              for s in small_shapes]
        return ws, gs, ms, vs, None

    base = dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                rescale_grad=1.0 / (32 * 512))
    checks = {}
    for recip in (True, False):
        checks[f"bf16_mp_bc_recip={recip}"] = _lamb_check(
            big, lrs, wds, bc_recip=recip, **base)
    sl = [0.01 * (1 + j) for j in range(len(small_shapes))]
    sw = [0.01] * len(small_shapes)
    checks["f32_no_bias_correction"] = _lamb_check(
        small, sl, sw, bias_correction=False, **base)
    for recip in (True, False):
        checks[f"f32_bounds_bc_recip={recip}"] = _lamb_check(
            small, sl, sw, bc_recip=recip, lower_bound=0.05,
            upper_bound=5.0, **base)
    nonfinite = checks["f32_no_bias_correction"]["norms_nan_where_f64_nan"]
    a = big()
    bcs = [[x] * len(shapes) for x in _lamb_bc(3, True)]
    ms = time_ms(lambda: fused_lamb_sweep(*a, lrs, wds, *bcs, **base), flush)
    plain_ms = time_ms(lambda: lamb_sweep_reference(*a, lrs, wds, *bcs,
                                                    **base),
                       flush, iters=5, warmup=1)
    b_ms, b_by = bound(40.0 * n, 20.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_lamb_sweep",
           "shape": [n], "members": len(shapes), "dtype": "bfloat16-mp",
           "checks": checks, "nonfinite_members_nan": nonfinite,
           "bit_identical": all(c["bit_identical"] for c in checks.values()),
           "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
           "norms_max_rel_err_vs_f64": max(
               c["norms_max_rel_err_vs_f64"] for c in checks.values()),
           "norms_tol": 1e-5,
           "ok": all(c["ok"] for c in checks.values()),
           "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "library": "none: no single PyTorch call computes LAMB",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 40.0 * n / 1e9}
    emit(rec)
    del a
    torch.cuda.empty_cache()
    return rec


TWOBIT_T = 0.5


def _nan_bits_equal(a, b) -> bool:
    """Equal NaN positions and equal bits everywhere else."""
    a, b = a.detach().cpu(), b.detach().cpu()
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    if a.dtype != b.dtype or not torch.equal(na, nb):
        return False
    return torch.equal(a[~na].contiguous().view(torch.uint8),
                       b[~nb].contiguous().view(torch.uint8))


def _twobit_edges(n, dtype, gen):
    """n seeded values with t, -t, t +- 1 ulp, +-0, NaN and +-inf each
    placed at 64 seeded positions."""
    t = torch.tensor(TWOBIT_T, dtype=dtype)
    inf = torch.tensor(float("inf"), dtype=dtype)
    up, down = torch.nextafter(t, inf), torch.nextafter(t, -inf)
    zero = torch.tensor(0.0, dtype=dtype)
    edges = torch.stack([t, -t, up, down, -up, -down, zero, -zero,
                         inf - inf, inf, -inf]).float()
    g = torch.randn(n, device="cuda", generator=gen) * 0.6
    idx = torch.randint(0, n, (64 * len(edges),), device="cuda",
                        generator=gen)
    g[idx] = edges.cuda().repeat(64)
    return g.to(dtype)


def twobit_case(flush, gen) -> list:
    """The kvstore's 2-bit quantizer with error feedback against its
    plain version (run on the CPU), bit for bit with NaN positions equal:
    five steps over a 25 MB bf16 bucket (the kvstore's default bucket
    cap), five over a 4M-element f32 bucket with t, t +- 1 ulp, +-0,
    NaN and +-inf placed in it; the same bits on a second call; one
    kernel per call (a graph capture's kernel nodes). Work per element:
    g and r read, q and r written (12 B in bf16, 16 B in f32), about
    five f32 operations. No single PyTorch call computes it."""
    from mxnet_tpu_torch.kernels import (twobit_quantize,
                                         twobit_quantize_reference)
    from mxnet_tpu_torch.kernels._build import kernels_per_call

    recs = []
    for dtype, n, edges in ((torch.bfloat16, (25 << 20) // 2, False),
                            (torch.float32, 1 << 22, True)):
        r_card = torch.zeros(n, device="cuda")
        r_cpu = torch.zeros(n)
        same = True
        for _ in range(5):
            g = _twobit_edges(n, dtype, gen) if edges else \
                (torch.randn(n, device="cuda", generator=gen) * 0.6).to(dtype)
            q = twobit_quantize(g, r_card, TWOBIT_T)
            qp = twobit_quantize_reference(g.cpu(), r_cpu, TWOBIT_T)
            same = same and _nan_bits_equal(q, qp) \
                and _nan_bits_equal(r_card, r_cpu)
        r1, r2 = r_card.clone(), r_card.clone()
        q1 = twobit_quantize(g, r1, TWOBIT_T)
        q2 = twobit_quantize(g, r2, TWOBIT_T)
        twice = _nan_bits_equal(q1, q2) and _nan_bits_equal(r1, r2)
        per_call = kernels_per_call(
            lambda: twobit_quantize(g, r1, TWOBIT_T, out=q1))
        r_t, q_t = torch.zeros(n, device="cuda"), torch.empty_like(g)
        size = g.element_size()
        b_ms, b_by = bound((2.0 * size + 8.0) * n, 5.0 * n, torch.float32)
        rec = {"phase": "kernels", "kernel": "twobit_quantize",
               "shape": [n], "dtype": _dname(dtype), "threshold": TWOBIT_T,
               "edge_values": edges, "steps": 5, "bit_identical": same,
               "same_bits_twice": twice, "kernels_per_call": per_call,
               "max_abs_err": 0.0 if same else None,
               "ms": time_ms(lambda: twobit_quantize(g, r_t, TWOBIT_T,
                                                     out=q_t), flush),
               "plain_ms": time_ms(lambda: twobit_quantize_reference(
                   g, r_t, TWOBIT_T), flush),
               "library_ms": None, "library": "null (no single call)",
               "bound_ms": b_ms, "bound_by": b_by}
        rec["device_ms"] = _queued_ms(
            lambda: twobit_quantize(g, r_t, TWOBIT_T, out=q_t), flush)
        rec["plain_device_ms"] = _queued_ms(
            lambda: twobit_quantize_reference(g, r_t, TWOBIT_T), flush)
        rec["ok"] = same and twice and per_call == 1
        emit(rec)
        recs.append(rec)
        del r_card, r_cpu, r1, r2, r_t, q_t
    return recs


def _warm_card(seconds=2.0) -> None:
    """Keep the card busy with bf16 GEMMs for ``seconds`` so its clocks
    have ramped up before anything is timed."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _warm_card()
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rs = np.random.RandomState(SEED)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (8, 8 * 512):
            recs.append(rms_case(rows, 4096, dtype, flush, gen))
        for b in (1, 8, 32):
            recs.append(paged_case(b, dtype, flush, rs, gen))
        # the BERT path's shapes: batch 32 x seq 512, BERT-base widths
        for with_res in (True, False):
            recs.append(ln_case(32 * 512, 768, dtype, with_res, flush, gen))
        recs.append(gelu_case(32 * 512, 3072, dtype, flush, gen))
        # BERT's heads as the path hands them over (views of the fused
        # QKV output), and a causal (2, 8, 2048, 128) for the streaming
        # TPU site
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (8, 12, 128, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.append(flash_case(*shape, dtype, flush, gen))
        # ragged lengths, causal with Lq < Lk (bottom-right aligned)
        recs.append(flash_case(2, 8, 200, 128, True, "bhld", dtype, flush,
                               gen, views=False, lk=328))
        # the pretraining path's backward kernels at its shapes
        for with_res in (True, False):
            recs.append(ln_bwd_case(32 * 512, 768, dtype, with_res, flush,
                                    gen))
        recs.append(gelu_bwd_case(32 * 512, 3072, dtype, flush, gen))
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.append(flash_bwd_case(*shape, dtype, flush, gen))
        # the dropout modes at p = 0.1, at the pretraining path's shapes
        recs.append(hash_dropout_case((32, 512, 768), dtype, flush, gen))
        for with_res in (True, False):
            recs.extend(ln_drop_cases(32 * 512, 768, dtype, with_res, flush,
                                      gen))
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.extend(flash_drop_cases(*shape, dtype, flush, gen))
        for d in (64, 128):
            recs.append(flash_mask_case(d, dtype, flush, gen))
        # the Llama pretraining path's shapes (proxy1b at 8 x 2048): the
        # RMSNorm forward with its rstd and its backward, and causal
        # flash on contiguous (8, 2048, 16, 128) heads, GQA repeated
        recs.append(rms_case(8 * 2048, 2048, dtype, flush, gen, rstd=True))
        recs.append(rms_bwd_case(8 * 2048, 2048, dtype, flush, gen))
        recs.append(flash_case(8, 16, 2048, 128, True, "blhd", dtype, flush,
                               gen, views=False))
        recs.append(flash_bwd_case(8, 16, 2048, 128, True, "blhd", dtype,
                                   flush, gen, views=False))
    recs.append(adam_case(flush, gen))
    recs.append(adamw_case(flush, gen))
    recs.append(sgd_case(flush, gen))
    recs.append(lamb_case(flush, gen))
    recs.extend(twobit_case(flush, gen))
    recs.append(nms_case(flush, gen))
    recs.append(nms_case(flush, gen, topk=-1))
    recs.extend(roi_align_cases(flush))
    recs.extend(correlation_cases(flush))
    bad = [r for r in recs if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    del flush
    torch.cuda.empty_cache()
    # each kernel's main-path shape stands for it in the summary: the
    # decode step's RMS (8, 4096) and paged B = 8, and BERT-base's
    # (32 x 512) batch for LayerNorm with the residual (24 of its 25
    # calls per forward, 24 of 26 backward), bias+GELU and flash
    # attention on fused-QKV views, forward and backward; bf16, and the
    # sweeps over the bf16-mp parameter sets; the RMSNorm backward at the
    # proxy1b step's (8 x 2048, 2048)
    pick = {r["kernel"]: r for r in recs
            if r["kernel"] in ("fused_adam_sweep", "fused_adamw_sweep",
                               "fused_sgd_sweep", "fused_lamb_sweep",
                               "box_nms", "roi_align", "roi_align_bwd",
                               "correlation", "correlation_bwd")
            and r.get("topk") != -1}
    pick["box_nms[topk=-1]"] = next(r for r in recs
                                    if r["kernel"] == "box_nms"
                                    and r["topk"] == -1)
    for r in recs:
        if r["dtype"] != "bfloat16":
            continue
        # the 25 MB bf16 bucket: the kvstore's default cap
        if r["kernel"] == "twobit_quantize":
            pick["twobit_quantize"] = r
        if r["kernel"] == "fused_rms_norm_bwd":
            pick["fused_rms_norm_bwd"] = r
        if r["kernel"] == "fused_layer_norm_bwd" and r["residual"]:
            pick["fused_layer_norm_bwd"] = r
        if r["kernel"] == "fused_bias_gelu_bwd":
            pick["fused_bias_gelu_bwd"] = r
        if r["kernel"] == "flash_attention_bwd" and r["layout"] == "blhd" \
                and r["views"]:
            pick["flash_attention_bwd"] = r
        # rule 2's main-path shape for the backward: proxy1b's causal
        # (8, 16, 2048, 128) contiguous heads
        if r["kernel"] == "flash_attention_bwd" and r["layout"] == "blhd" \
                and not r["views"]:
            pick["flash_attention_bwd[proxy1b]"] = r
        if r["kernel"] == "fused_rms_norm" and r["shape"] == [8, 4096]:
            pick["fused_rms_norm"] = r
        if r["kernel"] == "paged_attention_kernel" and r["shape"]["B"] == 8:
            pick["paged_attention_kernel"] = r
        if r["kernel"] == "fused_layer_norm" and r["residual"]:
            pick["fused_layer_norm"] = r
        if r["kernel"] == "fused_bias_gelu":
            pick["fused_bias_gelu"] = r
        if r["kernel"] == "flash_attention" and r["shape"] == [32, 12, 512,
                                                               64] \
                and r["layout"] == "blhd":
            pick["flash_attention"] = r
        # rule 2's main-path shape for the forward, as for the backward
        if r["kernel"] == "flash_attention" and r["layout"] == "blhd" \
                and not r["views"]:
            pick["flash_attention[proxy1b]"] = r
        # the dropout modes: the residual LayerNorm (the 12 add+norms
        # that drop), flash on the fused-QKV views, the Dropout op
        if r["kernel"] in ("fused_layer_norm[dropout]",
                           "fused_layer_norm_bwd[dropout]") \
                and r["residual"]:
            pick[r["kernel"]] = r
        if r["kernel"] in ("flash_attention[dropout]",
                           "flash_attention_bwd[dropout]") \
                and r["layout"] == "blhd":
            pick[r["kernel"]] = r
        if r["kernel"] == "hash_dropout":
            pick["hash_dropout"] = r
    return pick


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

class _LogitsTap:
    """Keeps the logits each engine dispatch returned. The scheduler
    emits a dispatch's tokens in row order right after it returns, so
    the k-th on_token callback after a dispatch belongs to row k."""

    def __init__(self, engine):
        self.last = None
        self.row = 0
        for name in ("prefill", "decode_step"):
            setattr(engine, name, self._wrap(getattr(engine, name)))

    def _wrap(self, fn):
        def run(*args):
            self.last = fn(*args)
            self.row = 0
            return self.last
        return run

    def take(self) -> np.ndarray:
        row = self.last[self.row]
        self.row += 1
        return row


def _graph_counts(engine) -> dict:
    """Each captured decode bucket's launches per replay, by wrapper, held
    against the graph's own kernel nodes of those kernels (RMSNorm
    kernels; the paged decode's split kernel, one per launch beside its
    combine kernel); fails on a difference."""
    from mxnet_tpu_torch.kernels._build import graph_kernel_names

    out = {}
    for b, w in engine.buckets():
        graph, per = engine.graph(b, w)
        names = graph_kernel_names(graph)
        nodes = {"fused_rms_norm": sum("rms_norm" in k for k in names),
                 "paged_attention_kernel": sum("paged_split_kernel" in k
                                               for k in names)}
        launches = {fn.__name__: n for (fn, attr), n in per.items()
                    if attr == "launches"}
        if launches != nodes:
            fail(f"decode graph {b}x{w}: launches per replay {launches}, "
                 f"the graph's kernel nodes {nodes}")
        out[f"{b}x{w}"] = {"launches_per_replay": launches,
                           "kernel_nodes": len(names)}
    return out


def _serve(net, dtype, prompts, new_tokens, tol, **server_kw) -> tuple:
    """Serve ``prompts`` concurrently through ``serving.Server`` after one
    warm-up request, then hold each stream's last decode-step logits
    against ``forward_full`` over the same tokens: the largest |diff|
    must stay within ``tol`` times the largest |logit|. Decode steps
    replay the engine's CUDA graphs, one captured per batch bucket at
    ``start()`` and none after. Kernel launch counts are zeroed just
    before the streams are submitted and read just after they complete:
    each replay adds its graph's launches, and the counts must equal
    the replays' and the eager prefills' exactly. Returns (results, the
    server's engine)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         paged_attention_kernel)

    n = len(prompts)
    srv = mx.serving.Server(net, dtype=dtype, **server_kw)
    with srv:
        engine = srv.engine
        captured = engine.captures
        if captured != len(server_kw["batch_buckets"]):
            fail(f"start() captured {captured} decode graphs for the "
                 f"buckets {server_kw['batch_buckets']}")
        tap = _LogitsTap(engine)
        # warm-up: one short request through both phases (cuBLAS picks
        # its kernels; the kernels' libraries load)
        srv.submit_generate(prompts[0][:16], 2).result(600)
        torch.cuda.synchronize()

        last_logits = [None] * n
        times = [[] for _ in range(n)]

        def on_token(s):
            def cb(i, tok):
                times[s].append(time.perf_counter())
                last_logits[s] = tap.take()
            return cb

        torch.cuda.reset_peak_memory_stats()
        replays0, batches0 = engine.replays, srv.stats()["batches"]
        fused_rms_norm.launches = 0
        paged_attention_kernel.launches = 0
        t_start = time.perf_counter()
        handles, t_submit = [], []
        for s, p in enumerate(prompts):
            t_submit.append(time.perf_counter())
            handles.append(srv.submit_generate(p, new_tokens,
                                               on_token=on_token(s)))
        outs = [h.result(600) for h in handles]
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {"fused_rms_norm": fused_rms_norm.launches,
                    "paged_attention_kernel": paged_attention_kernel.launches}
        stats = srv.stats()
        layers = engine.cfg["num_layers"]
        replays = engine.replays - replays0
        prefills = stats["batches"] - batches0
        graphs = {"captures_at_start": captured,
                  "captures": engine.captures, "replays": replays,
                  "prefills": prefills, "per_replay": _graph_counts(engine)}
    if graphs["captures"] != captured:
        fail(f"decode graphs captured again in steady state: {graphs}")
    want = {"fused_rms_norm": (replays + prefills) * (2 * layers + 1),
            "paged_attention_kernel": replays * layers}
    if launches != want:
        fail(f"launch counts {launches} are not the replays' and "
             f"prefills' {want}")
    if any(len(o) != new_tokens for o in outs):
        fail(f"a stream did not complete: {[len(o) for o in outs]}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    ttft = [times[s][0] - t_submit[s] for s in range(n)]
    per_tok = [(times[s][-1] - times[s][0]) / (new_tokens - 1)
               for s in range(n)]
    errs, rel, agree = [], [], 0
    for s in range(n):
        seq = np.concatenate([prompts[s], outs[s][:-1]])[None, :]
        full = srv.engine.forward_full(seq)[0]
        dec = last_logits[s]
        if int(np.argmax(dec)) != int(outs[s][-1]):
            fail(f"stream {s}: tapped logits do not match its last token")
        err = float(np.max(np.abs(dec - full)))
        errs.append(err)
        rel.append(err / float(np.max(np.abs(full))))
        agree += int(np.argmax(dec) == np.argmax(full))
    finite = bool(all(np.isfinite(lg).all() for lg in last_logits))
    out = {"streams": n, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens,
           "tokens_per_s": n * new_tokens / (t_end - t_start),
           "wall_s": t_end - t_start,
           "ttft_ms": {"mean": 1e3 * float(np.mean(ttft)),
                       "max": 1e3 * float(np.max(ttft))},
           "per_token_ms": {"mean": 1e3 * float(np.mean(per_tok)),
                            "max": 1e3 * float(np.max(per_tok))},
           "launches": launches, "graphs": graphs,
           "batches": stats["batches"], "defrags": stats["defrags"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "vs_forward_full": {"max_abs_err": errs,
                               "err_over_max_logit": rel, "tolerance": tol,
                               "argmax_agree": f"{agree}/{n}",
                               "finite": finite}}
    if not finite or max(rel) > tol:
        fail(f"decode logits disagree with forward_full: {out}")
    return out, srv.engine


def _prompts(rs, n, lo, hi, vocab) -> list:
    lens = rs.choice(np.arange(lo, hi + 1), n, replace=False)
    return [rs.randint(0, vocab, size=int(k)).astype(np.int32)
            for k in lens]


def phase_reference() -> None:
    """The decode path at Llama-3-8B widths in f32, depth cut to 2
    layers: cached decode must match a full recompute to f32 noise
    (1e-3 of the largest logit; a wrong page, mask or position would
    move the logits by O(1))."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    net = llama_3_8b(num_layers=2, ctx=mx.gpu(0), dtype=torch.float32,
                     generator=gen)
    rs = np.random.RandomState(SEED + 1)
    res, engine = _serve(net, "float32", _prompts(rs, 4, 20, 120, 128256),
                         8, tol=1e-3, batch_buckets=(1, 2, 4),
                         len_buckets=(128,), decode_pages=128, page_size=16)
    emit({"phase": "reference", "model": "llama_3_8b(num_layers=2)",
          "dtype": "float32", **res})
    emit({"phase": "reference", "step": "graph_vs_eager",
          **_graph_vs_eager(engine, rs, 128256, context=100)})
    del net
    torch.cuda.empty_cache()


def phase_serving() -> dict:
    """Llama-3-8B, all 32 layers, bf16. The decode path (paged kernel,
    K/V written by earlier dispatches' GEMM shapes) and forward_full (one
    prefill, bf16 scores in the gather path) round bf16 at different
    places over 32 layers: each stream's logits must agree within 10% of
    the largest logit magnitude, and the argmax agreement is reported."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = llama_3_8b(ctx=mx.gpu(0), dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    cfg = net._decode_cfg
    n_params = sum(p.numel() for p in net.parameters())
    emit({"phase": "serving", "step": "model", "config": cfg,
          "params": n_params, "dtype": "bfloat16",
          "build_s": time.perf_counter() - t0})
    if (cfg["num_layers"], cfg["units"], cfg["num_heads"],
            cfg["num_kv_heads"], cfg["vocab_size"]) != (32, 4096, 32, 8,
                                                        128256):
        fail(f"not Llama-3-8B at full width: {cfg}")
    rs = np.random.RandomState(SEED)
    res, engine = _serve(net, "bfloat16",
                 _prompts(rs, N_STREAMS, 100, 500, cfg["vocab_size"]),
                 NEW_TOKENS, tol=0.1, batch_buckets=(1, 2, 4, 8),
                 len_buckets=(128, 512), decode_pages=512, page_size=16)
    emit({"phase": "serving", "step": "generate", **res})
    emit({"phase": "serving", "step": "graph_vs_eager",
          **_graph_vs_eager(engine, rs, cfg["vocab_size"])})
    emit({"phase": "serving", "step": "decode_breakdown",
          **_decode_breakdown(engine, rs, cfg["vocab_size"])})
    return res["launches"]


def _tapped(srv, model, prompt, new_tokens, taps, last):
    """submit_generate with an on_token callback that keeps the row of
    the dispatch's logits each token came from (``taps[model]``)."""
    key = len(last)
    last.append(None)

    def cb(i, tok):
        last[key] = taps[model].take()

    h = srv.submit_generate(prompt, new_tokens, on_token=cb, model=model)
    return key, h


def _check_streams(srv, streams, last, tol) -> dict:
    """Each completed stream's last decode-step logits against its
    tenant engine's forward_full over the same tokens: the largest
    |diff| within ``tol`` of the largest |logit|."""
    rel, agree = [], 0
    for model, prompt, out, key in streams:
        seq = np.concatenate([prompt, out[:-1]])[None, :]
        full = srv._tenant(model).engine.forward_full(seq)[0]
        dec = last[key]
        if int(np.argmax(dec)) != int(out[-1]):
            fail(f"{model} stream: tapped logits do not match its last "
                 "token")
        rel.append(float(np.max(np.abs(dec - full)) / np.max(np.abs(full))))
        agree += int(np.argmax(dec) == np.argmax(full))
    out = {"streams": len(streams), "err_over_max_logit_max": max(rel),
           "err_over_max_logit_mean": float(np.mean(rel)),
           "argmax_agree": f"{agree}/{len(streams)}", "tolerance": tol}
    if max(rel) > tol or not all(np.isfinite(last[k]).all()
                                 for *_, k in streams):
        fail(f"decode logits disagree with forward_full: {out}")
    return out


def phase_multitenant() -> dict:
    """Two Llama-3-8B tenants at full width and depth, bf16, with
    different seeded weights (32.1 GB together), behind one Server and
    one page pool. First 8 streams each (prompts 50-120, 48 new tokens;
    "premium" at weight 3, the default tenant at 1): the token share
    over a window of >= 192 tokens while all 16 decode must be 3:1 within
    10%. Then 8 default streams of 400-500-token prompts and 200 new
    tokens reserve all but one page less than a premium stream needs,
    and 3 premium streams (priority 10, 32 new tokens) arrive: each must
    preempt. Each victim ends Preempted and never yields another token;
    stats() counts exactly the victims; every completed stream's last
    logits hold against forward_full within the serving phase's 10%;
    both kernels launch (counted per replay)."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b
    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         paged_attention_kernel)
    from mxnet_tpu_torch.serving import DEFAULT_MODEL, Preempted

    t0 = time.perf_counter()
    nets = [llama_3_8b(ctx=mx.gpu(0), dtype=torch.bfloat16,
                       generator=torch.Generator(device="cuda").manual_seed(
                           SEED + 10 + i)) for i in range(2)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    vocab, page = 128256, 16
    rs = np.random.RandomState(SEED + 10)
    fair = [_prompts(rs, 8, 50, 120, vocab) for _ in range(2)]
    squat = _prompts(rs, 8, 400, 500, vocab)
    prem = _prompts(rs, 3, 100, 300, vocab)
    squat_new, prem_new, fair_new = 200, 32, 48

    def pages(n):
        return -(-n // page)

    held = sum(pages(len(p) + squat_new) for p in squat)
    need = min(pages(len(p) + prem_new) for p in prem)
    decode_pages = 1 + held + need - 1
    if decode_pages - 1 < sum(pages(len(p) + fair_new)
                              for f in fair for p in f):
        fail("the multitenant pool cannot hold the fairness streams")
    srv = mx.serving.Server(nets[0], dtype="bfloat16",
                            batch_buckets=(1, 2, 4, 8),
                            len_buckets=(128, 512),
                            decode_pages=decode_pages, page_size=page,
                            max_generate_tokens=768, priority=0, weight=1.0)
    last, done = [], []
    with srv:
        srv.register_model("premium", nets[1], slo_class="premium",
                           priority=10, weight=3.0)
        taps = {m: _LogitsTap(srv._tenant(m).engine)
                for m in (DEFAULT_MODEL, "premium")}
        captures = {m: srv._tenant(m).engine.captures for m in taps}
        # warm-up: one short request per tenant
        for m in taps:
            srv.submit_generate(fair[0][0][:16], 2, model=m).result(600)
        torch.cuda.synchronize()
        fused_rms_norm.launches = 0
        paged_attention_kernel.launches = 0

        def tokens():
            ms = srv.stats()["models"]
            return ms[DEFAULT_MODEL]["tokens"], ms["premium"]["tokens"]

        t1 = time.perf_counter()
        base = tokens()
        handles = []
        for m, prompts in zip((DEFAULT_MODEL, "premium"), fair):
            for p in prompts:
                handles.append((m, p) + _tapped(srv, m, p, fair_new, taps,
                                                last))
        deadline = time.perf_counter() + 600
        while not (srv.stats()["generates_active"] == 16
                   and sum(tokens()) - sum(base) >= 16 + 24):
            if time.perf_counter() > deadline:
                fail("the fairness streams never all decoded together")
            time.sleep(0.002)
        a1, b1 = tokens()
        while (tokens()[0] - a1) + (tokens()[1] - b1) < 192:
            time.sleep(0.002)
        a2, b2 = tokens()
        share = (b2 - b1) / ((a2 - a1) + (b2 - b1))
        for m, p, key, h in handles:
            done.append((m, p, h.result(600), key))
        fair_s = time.perf_counter() - t1
        # preemption: squatters fill the pool, premium arrivals evict
        t2 = time.perf_counter()
        squatters = [(p,) + _tapped(srv, DEFAULT_MODEL, p, squat_new, taps,
                                    last) for p in squat]
        while srv.stats()["generates_active"] < len(squat):
            time.sleep(0.002)
        premium = [(p,) + _tapped(srv, "premium", p, prem_new, taps, last)
                   for p in prem]
        victims, survivors = [], 0
        for p, key, h in premium:
            done.append(("premium", p, h.result(600), key))
        for p, key, h in squatters:
            try:
                done.append((DEFAULT_MODEL, p, h.result(600), key))
                survivors += 1
            except Preempted:
                got = h.tokens()
                if h.next_token(len(got), timeout=1) is not None:
                    fail("a preempted stream yielded a token after its end")
                victims.append(len(got))
        preempt_s = time.perf_counter() - t2
        torch.cuda.synchronize()
        launches = {"fused_rms_norm": fused_rms_norm.launches,
                    "paged_attention_kernel": paged_attention_kernel.launches}
        stats = srv.stats()
        graphs = {m: {"captures_at_register": captures[m],
                      "captures": srv._tenant(m).engine.captures,
                      "replays": srv._tenant(m).engine.replays}
                  for m in taps}
    if abs(share - 0.75) / 0.75 > 0.10:
        fail(f"premium token share {share} is not 3:1 within 10%")
    if not victims:
        fail("no squatter was preempted")
    if (stats["preemptions"] != len(victims)
            or stats["models"][DEFAULT_MODEL]["preempted"] != len(victims)):
        fail(f"stats() preemptions {stats['preemptions']} are not the "
             f"{len(victims)} victims")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    if any(g["captures"] != g["captures_at_register"]
           for g in graphs.values()):
        fail(f"decode graphs captured again in steady state: {graphs}")
    check = _check_streams(srv, done, last, tol=0.1)
    out = {"tenants": {DEFAULT_MODEL: {"priority": 0, "weight": 1.0},
                       "premium": {"priority": 10, "weight": 3.0}},
           "build_s": build_s, "decode_pages": decode_pages,
           "fairness": {"window_tokens": [a2 - a1, b2 - b1],
                        "premium_share": share, "target": 0.75,
                        "seconds": fair_s},
           "preemption": {"victims": len(victims),
                          "victim_tokens": victims,
                          "survivors": survivors,
                          "premium_streams": len(premium),
                          "stats_preemptions": stats["preemptions"],
                          "seconds": preempt_s},
           "launches": launches, "graphs": graphs,
           "tokens": stats["tokens"], "vs_forward_full": check}
    emit({"phase": "multitenant", **out})
    del srv, nets, taps
    # the two tenants' 32 GB of weights may be held by a reference cycle
    # of the server: collect them before the reload phase builds two
    # Llama-3-8B models of its own
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_reload() -> dict:
    """Hot reload at Llama-3-8B width. (1) swap_model on the full bf16
    model while a stream decodes: that stream finishes on the old
    weights (its last logits against the OLD block's forward_full
    within 10%), the next runs on the new ones (against the engine's,
    now the new block's); the engine recaptures each of its 4 bucket
    graphs exactly once, timed. (2) reload from a CheckpointManager
    bundle at that width, depth cut to 2 layers, bf16, through one
    injected transient serving.reload fault (retried): the served block
    holds the bundle's weights bit for bit and a stream holds against
    forward_full; the bundle's save and load s and MB/s."""
    import shutil
    from pathlib import Path

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b
    from mxnet_tpu_torch.serving import DEFAULT_MODEL, PagePool

    def net(seed, **kw):
        return llama_3_8b(ctx=mx.gpu(0), dtype=torch.bfloat16,
                          generator=torch.Generator(device="cuda")
                          .manual_seed(seed), **kw)

    vocab = 128256
    rs = np.random.RandomState(SEED + 20)
    pa, pb = _prompts(rs, 2, 200, 400, vocab)
    kw = dict(dtype="bfloat16", batch_buckets=(1, 2, 4, 8),
              len_buckets=(128, 512), decode_pages=256, page_size=16)
    old = net(SEED + 20)
    srv = mx.serving.Server(old, **kw)
    last = []
    with srv:
        engine = srv.engine
        taps = {DEFAULT_MODEL: _LogitsTap(engine)}
        caps0 = engine.captures
        refresh = {}
        real_refresh = engine.refresh_params

        def timed_refresh(model):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_refresh(model)
            torch.cuda.synchronize()
            refresh["ms"] = 1e3 * (time.perf_counter() - t)

        engine.refresh_params = timed_refresh
        key_a, ha = _tapped(srv, DEFAULT_MODEL, pa, 256, taps, last)
        if ha.next_token(3, timeout=600) is None:
            fail("the reload phase's first stream did not start")
        new = net(SEED + 21)            # built while stream A decodes
        torch.cuda.synchronize()
        srv.swap_model(new)
        swapped_at = len(ha.tokens())
        out_a = ha.result(600)
        key_b, hb = _tapped(srv, DEFAULT_MODEL, pb, 16, taps, last)
        out_b = hb.result(600)
        recaptures = engine.captures - caps0
        version = srv.model_version
    if recaptures != len(kw["batch_buckets"]):
        fail(f"one swap recaptured {recaptures} decode graphs, not one per "
             f"bucket {kw['batch_buckets']}")
    old_engine = old.decode_engine(PagePool(64, 16), dtype=torch.bfloat16)
    seq_a = np.concatenate([pa, out_a[:-1]])[None, :]
    full_old = old_engine.forward_full(seq_a)[0]
    full_new = engine.forward_full(seq_a)[0]
    rel_old = float(np.max(np.abs(last[key_a] - full_old))
                    / np.max(np.abs(full_old)))
    rel_new = float(np.max(np.abs(last[key_a] - full_new))
                    / np.max(np.abs(full_new)))
    b_check = _check_streams(srv, [(DEFAULT_MODEL, pb, out_b, key_b)],
                             last, tol=0.1)
    swap = {"stream_a_tokens_at_swap": swapped_at,
            "stream_a_vs_old_forward_full": rel_old,
            "stream_a_vs_new_forward_full": rel_new,
            "stream_b_vs_forward_full": b_check,
            "recaptures": recaptures, "refresh_ms": refresh.get("ms"),
            "model_version": version}
    if swapped_at >= 256 or rel_old > 0.1 or rel_new <= rel_old:
        fail(f"the stream in flight did not finish on the old weights: "
             f"{swap}")
    emit({"phase": "reload", "step": "swap_model", **swap})
    del srv, engine, old_engine, old, new, taps
    torch.cuda.empty_cache()

    # (2) a bundle at 8B width, 2 layers
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    old2, new2 = net(SEED + 22, num_layers=2), net(SEED + 23, num_layers=2)
    mgr = CheckpointManager(str(ckpt_dir), keep_last=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mgr.save(1, params=new2)
    save_s = time.perf_counter() - t
    nbytes = (Path(mgr.path(1)) / "params.params").stat().st_size
    load = {}

    def factory(path):
        block = net(SEED + 24, num_layers=2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        block.load_parameters(str(Path(path) / "params.params"))
        torch.cuda.synchronize()
        load["s"] = time.perf_counter() - t
        return block

    last = []
    with mx.serving.Server(old2, **kw) as srv:
        with fault.inject("serving.reload=once") as st:
            t = time.perf_counter()
            step = srv.reload(mgr, factory)
            reload_s = time.perf_counter() - t
            injected = st()["serving.reload"]
        served = srv.current_model()
        same = all(torch.equal(a, b) for a, b in
                   zip(served.state_dict().values(),
                       new2.state_dict().values()))
        taps = {DEFAULT_MODEL: _LogitsTap(srv.engine)}
        key, h = _tapped(srv, DEFAULT_MODEL, pa, 16, taps, last)
        out = h.result(600)
        check = _check_streams(srv, [(DEFAULT_MODEL, pa, out, key)], last,
                               tol=0.1)
        loaded_step = srv.loaded_step
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    bundle = {"model": "llama_3_8b(num_layers=2)", "dtype": "bfloat16",
              "bytes": nbytes, "save_s": save_s,
              "save_mb_per_s": nbytes / 1e6 / save_s,
              "load_s": load["s"], "load_mb_per_s": nbytes / 1e6 / load["s"],
              "reload_s": reload_s, "fault": injected,
              "loaded_step": loaded_step, "weights_bit_for_bit": same,
              "vs_forward_full": check}
    if (step != 1 or loaded_step != 1 or not same
            or injected.get("injected") != 1 or injected.get("hits") != 2):
        fail(f"reload from the bundle failed its checks: {bundle}")
    emit({"phase": "reload", "step": "checkpoint", **bundle})
    del srv, old2, new2, served
    torch.cuda.empty_cache()
    return {"swap": swap, "checkpoint": bundle}


def _device_breakdown(step, steps, n_top=8, kind=None) -> dict:
    """Where ``step()``'s time goes: host wall time per call (synchronised,
    unprofiled, after one warm call) against the device time
    torch.profiler records over as many further calls, the ``n_top``
    device events that take most of it, and device time by kind
    (``kind(name)``, default :func:`_kind`)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()                        # host clock, unprofiled
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    device_ms, top, by_kind = _device_events(prof, steps, n_top,
                                             kind or _kind)
    return {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "device_idle_share": 1 - device_ms / host_ms,
            "top_device_ms_per_step": top,
            "device_ms_per_step_by_kind": by_kind,
            "port_kernels_per_step": _port_kernel_times(prof, steps)}


# the port's own CUDA kernels, by their __global__ names in kernels/csrc
_PORT_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "dkdv_kernel",
                 "dq_kernel",
                 "dkdv_wgmma_kernel", "dq_wgmma_kernel",
                 "delta_kernel", "ln_vec_kernel", "ln_scalar_kernel",
                 "ln_bwd_ring_kernel", "ln_bwd_scalar_kernel", "bias_gelu",
                 "adam_kernel", "rms_norm",
                 "paged_split_kernel", "paged_combine_kernel",
                 "dropout_kernel", "adamw_kernel",
                 "adamw_scan_kernel", "sgd_kernel", "lamb_phase1_kernel",
                 "lamb_norms_kernel", "lamb_phase2_kernel",
                 "nms_cluster_kernel", "nms_tile_kernel",
                 "nms_sweep_kernel", "roi_align_fwd_kernel",
                 "roi_align_bwd_kernel", "corr_fwd_kernel",
                 "corr_bwd_kernel")


def _kind(name) -> str:
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels"
    if any(k in name.lower() for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "library_gemm"
    if "Memcpy" in name or "Memset" in name:
        return "copy_memset"
    return "other_library"


def _device_events(prof, per, n_top=8, kind=None) -> tuple:
    """(device ms, the ``n_top`` largest device events in ms, device ms by
    kind: the port's kernels, library GEMMs, copies, other library
    kernels), each divided by ``per``. Device-side events only (kernels,
    copies, memsets): a CPU op's device time repeats its kernels' time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device ms by event name, cut to 60 characters (names that share
    # the cut prefix add up)
    by_name, by_kind = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or dev_us(e) <= 0:
            continue
        ms = dev_us(e) / 1e3 / per
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + ms
        k = (kind or _kind)(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return sum(by_name.values()), dict(top[:n_top]), by_kind


def _port_kernel_times(prof, per) -> dict:
    """Each of the port's kernels (its name with the template arguments,
    so a dropout instance stands apart) by device ms and launches per
    step, and device microseconds per launch: the kernel's own time,
    without the wrapper's host time that an event-timed call may
    include."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != DeviceType.CUDA or us <= 0 \
                or _kind(e.key) != "port_kernels":
            continue
        name = e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0]
        rec = out.setdefault(name, {"ms": 0.0, "launches": 0})
        rec["ms"] += us / 1e3 / per
        rec["launches"] += e.count / per
    for rec in out.values():
        rec["us_per_launch"] = 1e3 * rec["ms"] / rec["launches"]
    return out


def _decode_rows(engine, rs, vocab, batch, context, extra):
    """``batch`` rows prefilled with ``context``-token prompts, pages for
    ``extra`` more tokens each, at the page-table width of a server
    whose generate budget is 768 tokens. Returns (owners, table, next
    tokens)."""
    owners = [object() for _ in range(batch)]
    table = np.zeros((batch, engine.pool.pages_for(768)), np.int32)
    tokens = rs.randint(0, vocab, size=(batch, 512)).astype(np.int32)
    for i, o in enumerate(owners):
        pages = engine.pool.alloc(o, context + extra)
        table[i, :len(pages)] = pages
    lengths = np.full((batch,), context, np.int32)
    nxt = np.argmax(engine.prefill(tokens, lengths, table), -1)
    return owners, table, nxt.astype(np.int32)


def _graph_vs_eager(engine, rs, vocab, batch=8, context=300) -> dict:
    """One (batch, 1) decode step's logits from the bucket's CUDA graph
    against the eager ``_paged_forward`` on the same inputs and arenas
    (the eager step first; the replay rewrites the same K/V values into
    the same slots), bit for bit: all rows, then the first 5 with rows
    5-7 padding (length 0, an all-scratch page table)."""
    owners, table, nxt = _decode_rows(engine, rs, vocab, batch, context, 4)
    try:
        out = {"batch": batch, "context": context, "checks": []}
        for n in (batch, 5):
            tk = np.where(np.arange(batch) < n, nxt, 0).astype(np.int32)
            ln = np.where(np.arange(batch) < n, context + 1, 0).astype(
                np.int32)
            tb = np.where((np.arange(batch) < n)[:, None], table, 0).astype(
                np.int32)
            want = engine.decode_step_eager(tk, ln, tb)
            got = engine.decode_step(tk, ln, tb)
            same = bool(np.array_equal(got.view(np.int32),
                                       want.view(np.int32)))
            out["checks"].append({
                "rows": n, "same_bits": same,
                "max_abs_err": float(np.max(np.abs(got - want))),
                "finite": bool(np.isfinite(got).all())})
            if not same or not np.isfinite(got).all():
                fail(f"decode graph logits differ from the eager step: "
                     f"{out}")
    finally:
        for o in owners:
            engine.pool.free(o)
    return out


def _decode_breakdown(engine, rs, vocab, batch=8, steps=8) -> dict:
    """A (batch, 1) decode step's host vs device time, through the
    bucket's CUDA graph (``decode_step``) and eagerly
    (``decode_step_eager``, the parent's path) in turns; rows hold
    300-token prompts, as in the serving phase. ``replay_ms``: the
    graph's replay alone, CUDA events around 20 replays."""
    owners, table, nxt = _decode_rows(engine, rs, vocab, batch, 300,
                                      6 * steps + 8)
    state = {"lengths": np.full((batch,), 301, np.int32), "nxt": nxt}
    out = {"batch": batch, "context": 300}
    try:
        engine.decode_step(state["nxt"], state["lengths"], table)
        for name in ("graph", "eager", "graph_again"):
            fn = (engine.decode_step_eager if name == "eager"
                  else engine.decode_step)

            def step(fn=fn):
                state["lengths"] = state["lengths"] + 1
                state["nxt"] = np.argmax(fn(state["nxt"], state["lengths"],
                                            table), -1)

            res = _device_breakdown(step, steps)
            res["paged_us_per_launch"] = {
                k: v["us_per_launch"]
                for k, v in res["port_kernels_per_step"].items()
                if k.startswith("paged")}
            out[name] = res
        graph, _ = engine.graph(batch, table.shape[1])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        graph.replay()
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        end.synchronize()
        out["replay_ms"] = start.elapsed_time(end) / 20
    finally:
        for o in owners:
            engine.pool.free(o)
    return out


# ---------------------------------------------------------------------------
# 6-7. BERT through Server.submit
# ---------------------------------------------------------------------------

def _bert_counts():
    from mxnet_tpu_torch.kernels import (flash_attention, fused_bias_gelu,
                                         fused_layer_norm)

    return {"fused_layer_norm": fused_layer_norm.launches,
            "flash_attention": flash_attention.launches,
            "fused_bias_gelu": fused_bias_gelu.launches}


def _reset_bert_counts() -> None:
    from mxnet_tpu_torch.kernels import (flash_attention, fused_bias_gelu,
                                         fused_layer_norm)

    fused_layer_norm.launches = 0
    flash_attention.launches = 0
    fused_bias_gelu.launches = 0


def _bert_samples(rs, n, vocab, lo=16, hi=512) -> list:
    """``n`` token-id samples, lengths uniform in [lo, hi], ids uniform in
    [1, vocab)."""
    lens = rs.randint(lo, hi + 1, size=n)
    return [rs.randint(1, vocab, size=int(k)).astype(np.float32)
            for k in lens]


def _serve_bert(net, samples, n_clients, **server_kw) -> dict:
    """Serve ``samples`` through Server.submit from ``n_clients`` threads,
    each submitting its contiguous share back to back and then waiting.
    The launch counters are zeroed after the server's warm-up and just
    before the first submit, and read once the last future resolved;
    a forward pre-hook records each dispatched batch's shape."""
    import mxnet_tpu_torch as mx

    n = len(samples)
    shapes = []
    hook = net.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape)))
    results = [None] * n
    t_sub = [0.0] * n
    t_done = [0.0] * n
    per = -(-n // n_clients)
    try:
        with mx.serving.Server(net, ctx=mx.gpu(0), **server_kw) as srv:
            torch.cuda.synchronize()
            warm = srv.stats()["warmup_forwards"]
            del shapes[:]
            _reset_bert_counts()

            def client(c):
                futs = []
                for i in range(c * per, min(n, (c + 1) * per)):
                    t_sub[i] = time.perf_counter()
                    f = srv.submit(samples[i])
                    f.add_done_callback(
                        lambda _f, i=i: t_done.__setitem__(
                            i, time.perf_counter()))
                    futs.append((i, f))
                for i, f in futs:
                    results[i] = f.result(600)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _bert_counts()
            stats = srv.stats()
    finally:
        hook.remove()
    if any(r is None for r in results):
        fail(f"{sum(r is None for r in results)} of {n} requests were "
             "not served")
    lat_ms = 1e3 * (np.asarray(t_done) - np.asarray(t_sub))
    return {"results": results, "shapes": shapes, "wall": wall,
            "launches": launches, "stats": stats, "lat_ms": lat_ms,
            "warmup_forwards": warm}


def _fold(acc, got, ref) -> tuple:
    """Fold one sample's leaves into ``acc``: (largest |got - ref| per
    leaf, largest |ref| per leaf) over the samples seen so far."""
    e = [float(np.max(np.abs(g - r))) for g, r in zip(got, ref)]
    m = [float(np.max(np.abs(r))) for r in ref]
    if acc is None:
        return e, m
    return ([max(x, y) for x, y in zip(acc[0], e)],
            [max(x, y) for x, y in zip(acc[1], m)])


def _verdict(acc, tol) -> dict:
    rel = [e / m for e, m in zip(*acc)]
    return {"max_abs_err": acc[0], "max_abs_output": acc[1],
            "err_over_max_output": rel, "tolerance": tol,
            "ok": max(rel) <= tol}


def _leaves(out) -> list:
    """Row 0 of each output leaf of a batch-1 forward, as f32 numpy."""
    out = out if isinstance(out, tuple) else (out,)
    return [a[0].float().cpu().numpy() for a in out]


def _check_bert(net, samples, served, tol, buckets, plain=None) -> dict:
    """Each served response against a batch-1 forward of its padded
    sample on the card, leaf by leaf: the largest |diff| over all samples
    must stay within ``tol`` times the largest |output| of that leaf.
    With ``plain`` (the same weights on the CPU, whose tensors take every
    kernel's plain version), each batch-1 forward is also held against
    ``plain``'s forward of the same sample, within ``tol`` likewise."""
    batched, vs_plain = None, None
    with torch.inference_mode():
        for s, got in zip(samples, served["results"]):
            length = next(b for b in buckets if b >= len(s))
            padded = torch.zeros((1, length), dtype=torch.float32)
            padded[0, :len(s)] = torch.from_numpy(s)
            alone = _leaves(net(padded.cuda()))
            got = got if isinstance(got, tuple) else (got,)
            if not all(np.isfinite(g).all() for g in got):
                fail("a served BERT response is not finite")
            batched = _fold(batched, got, alone)
            if plain is not None:
                vs_plain = _fold(vs_plain, alone, _leaves(plain(padded)))
    out = {"vs_batch1": _verdict(batched, tol)}
    if plain is not None:
        out["batch1_vs_plain"] = _verdict(vs_plain, tol)
    return out


def _bert_summary(served, samples, net_cfg, per_forward) -> dict:
    stats = served["stats"]
    shapes = served["shapes"]
    forwards = len(shapes)
    want = {k: v * forwards for k, v in per_forward.items()}
    lat = served["lat_ms"]
    return {"requests": len(samples),
            "requests_per_s": len(samples) / served["wall"],
            "real_tokens_per_s": sum(len(s) for s in samples)
            / served["wall"],
            "padded_tokens_per_s": sum(b * l for b, l in shapes)
            / served["wall"],
            "wall_s": served["wall"],
            "latency_ms": {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99)),
                           "max": float(np.max(lat))},
            "batches": stats["batches"], "forwards": forwards,
            "close_reasons": stats["close_reasons"],
            "mean_occupancy": stats["batch_rows"] / stats["batch_slots"],
            "batch_shapes": sorted(set(shapes)),
            "warmup_forwards": served["warmup_forwards"],
            "launches": served["launches"], "launches_expected": want,
            "launches_per_forward": per_forward, "config": net_cfg}


def _profile_burst(net, samples, buckets) -> dict:
    """The same burst served again under torch.profiler (device activity
    only, so the host pays little for it): the card's busy time over the
    burst's wall time, and the device events that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        served = _serve_bert(net, samples, BERT_CLIENTS,
                             shape_buckets=[(b,) for b in buckets],
                             batch_buckets=(1, 2, 4, 8, 16, 32),
                             slo_ms=500.0, batch_timeout_ms=10.0)
    device_ms, top, _ = _device_events(prof, 1)
    wall_ms = served["wall"] * 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "forwards": len(served["shapes"]),
            "top_device_ms": top}


def _per_forward(cfg, decoder) -> dict:
    layers = cfg["num_layers"]
    return {"fused_layer_norm": 2 * layers + 1 + int(decoder),
            "flash_attention": layers,
            "fused_bias_gelu": layers + int(decoder)}


def phase_bert_reference() -> None:
    """BERT-base widths in f32, depth cut to 2 layers, every output: a
    response served in a batch must equal the batch-1 forward of its
    padded sample, and that forward the plain versions' forward of the
    same weights on the CPU, to f32 noise (1e-4 of the largest output; a
    wrong row, pad, mask, stride or kernel would move it by O(1))."""
    import copy

    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    net = bert_12_768_12(num_layers=2, ctx="cuda", dtype=torch.float32,
                         generator=gen)
    rs = np.random.RandomState(SEED + 2)
    samples = _bert_samples(rs, 24, net.config["vocab_size"])
    buckets = (128, 512)
    served = _serve_bert(net, samples, 4,
                         shape_buckets=[(b,) for b in buckets],
                         batch_buckets=(1, 2, 4, 8), slo_ms=500.0,
                         batch_timeout_ms=10.0)
    per_forward = _per_forward(net.config, decoder=True)
    out = _bert_summary(served, samples, net.config, per_forward)
    out.update(_check_bert(net, samples, served, 1e-4, buckets,
                           plain=copy.deepcopy(net).to("cpu")))
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "bert_reference", "model": "bert_12_768_12("
          "num_layers=2)", "dtype": "float32", **out})
    if not out["vs_batch1"]["ok"]:
        fail(f"f32 BERT responses disagree with batch-1 forwards: "
             f"{out['vs_batch1']}")
    if not out["batch1_vs_plain"]["ok"]:
        fail(f"f32 BERT forwards on the card disagree with the plain "
             f"versions: {out['batch1_vs_plain']}")
    if out["launches"] != out["launches_expected"]:
        fail(f"BERT reference launch counts {out['launches']} are not "
             f"{out['launches_expected']}")
    del net
    torch.cuda.empty_cache()


def phase_bert_serving() -> dict:
    """bert_12_768_12 (12 layers, 768 units, 3072 FFN, 12 heads, vocab
    30522), bf16, no MLM head, behind Server.submit. Each response must
    agree with the batch-1 forward of its padded sample within one bf16
    ulp (2**-7) of the leaf's largest magnitude. Every kernel of the
    path is row-independent and the readings so far were exactly 0.0;
    the ulp leaves room for cuBLAS to sum another GEMM shape (a batch
    of 32 against a batch of 1) in another order, while a wrong row, pad
    or mask would move a response by O(1)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = bert_12_768_12(use_decoder=False, ctx="cuda",
                         dtype=torch.bfloat16, generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"]) != (12, 768, 3072, 12,
                                                     30522):
        fail(f"not BERT-base at full width and depth: {cfg}")
    rs = np.random.RandomState(0)
    samples = _bert_samples(rs, BERT_REQUESTS, cfg["vocab_size"])
    buckets = (128, 512)
    served = _serve_bert(net, samples, BERT_CLIENTS,
                         shape_buckets=[(b,) for b in buckets],
                         batch_buckets=(1, 2, 4, 8, 16, 32), slo_ms=500.0,
                         batch_timeout_ms=10.0)
    per_forward = _per_forward(cfg, decoder=False)
    out = _bert_summary(served, samples, cfg, per_forward)
    out.update(_check_bert(net, samples, served, BF16_ULP, buckets))
    x = torch.from_numpy(np.stack([np.resize(s, 512) for s in
                                   samples[:32]])).cuda()

    def forward():
        with torch.inference_mode():
            net(x)

    out["forward_breakdown"] = {"batch": 32, "seq": 512,
                                **_device_breakdown(forward, 5)}
    out["burst_profile"] = _profile_burst(net, samples, buckets)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "bert_serving", "model": "bert_12_768_12",
          "dtype": "bfloat16", **out})
    if not out["vs_batch1"]["ok"]:
        fail(f"bf16 BERT responses disagree with batch-1 forwards: "
             f"{out['vs_batch1']}")
    if out["launches"] != out["launches_expected"]:
        fail(f"BERT serving launch counts {out['launches']} are not "
             f"{out['launches_expected']} ({per_forward} per forward)")
    del net
    torch.cuda.empty_cache()
    return out["launches"]


# ---------------------------------------------------------------------------
# 8-9. BERT pretraining through TrainStep
# ---------------------------------------------------------------------------

def _train_wrappers() -> dict:
    from mxnet_tpu_torch.kernels import (flash_attention, flash_attention_bwd,
                                         fused_adam_sweep, fused_adamw_sweep,
                                         fused_bias_gelu, fused_lamb_sweep,
                                         fused_sgd_sweep,
                                         fused_bias_gelu_bwd,
                                         fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_rms_norm, fused_rms_norm_bwd,
                                         hash_dropout, hash_dropout_bwd,
                                         twobit_quantize)

    return {f.__name__: f for f in (
        fused_layer_norm, fused_layer_norm_bwd, fused_bias_gelu,
        fused_bias_gelu_bwd, flash_attention, flash_attention_bwd,
        fused_adam_sweep, hash_dropout, hash_dropout_bwd, fused_rms_norm,
        fused_rms_norm_bwd, fused_adamw_sweep, fused_sgd_sweep,
        fused_lamb_sweep, twobit_quantize)}


# the other counters some wrappers keep beside ``launches``
_SUB_COUNTS = (("dropout_launches", "[dropout]"), ("scan_launches", "[scan]"),
               ("phase1_launches", "[phase1]"), ("norms_launches", "[norms]"),
               ("wgmma_launches", "[wgmma]"))


def _reset_train_counts() -> None:
    for f in _train_wrappers().values():
        f.launches = 0
        for attr, _ in _SUB_COUNTS:
            if hasattr(f, attr):
                setattr(f, attr, 0)


def _train_counts() -> dict:
    """Each training wrapper's launches; for the LayerNorm and flash
    wrappers also their launches with dropout, as "<name>[dropout]", for
    the AdamW sweep its scans, as "fused_adamw_sweep[scan]", and for the
    LAMB sweep its phase-1 and norms launches, as
    "fused_lamb_sweep[phase1]" and "fused_lamb_sweep[norms]" (its own
    count is phase 2's), and for the flash forward and backward their
    launches on the warpgroup route, as "flash_attention[wgmma]" and
    "flash_attention_bwd[wgmma]"."""
    out = {}
    for name, f in _train_wrappers().items():
        out[name] = f.launches
        for attr, suffix in _SUB_COUNTS:
            if hasattr(f, attr):
                out[name + suffix] = getattr(f, attr)
    return out


def _per_step(cfg, buckets, dropout=0.0, attn_dropout=0.0,
              wgmma=False) -> dict:
    """Launches of each kernel in one TrainStep of BERTForPretrainFused:
    embed_ln, two add+norms per layer and decoder_ln, forward and
    backward (the first add+norm of each layer drops, with dropout); the
    FFN's and decoder_transform's bias+GELU; one flash attention per
    layer (dropping with attention dropout); the Dropout op after
    embed_ln and after each layer's attention and FFN, forward and
    backward; one sweep per dtype bucket. ``wgmma``: the flash forward
    and backward take the warpgroup route (bf16 at head dim 64 or
    128)."""
    layers = cfg["num_layers"]
    drop_ln = layers if dropout > 0 else 0
    drop_attn = layers if attn_dropout > 0 else 0
    drop_op = 2 * layers + 1 if dropout > 0 else 0
    return {**dict.fromkeys(_train_counts(), 0),
            "fused_layer_norm": 2 * layers + 2,
            "fused_layer_norm[dropout]": drop_ln,
            "fused_layer_norm_bwd": 2 * layers + 2,
            "fused_layer_norm_bwd[dropout]": drop_ln,
            "fused_bias_gelu": layers + 1,
            "fused_bias_gelu_bwd": layers + 1,
            "flash_attention": layers,
            "flash_attention[dropout]": drop_attn,
            "flash_attention_bwd": layers,
            "flash_attention_bwd[dropout]": drop_attn,
            "flash_attention[wgmma]": layers if wgmma else 0,
            "flash_attention_bwd[wgmma]": layers if wgmma else 0,
            "fused_adam_sweep": buckets,
            "hash_dropout": drop_op, "hash_dropout_bwd": drop_op}


def phase_train_reference(dropout=0.0, attn_dropout=0.0) -> None:
    """BERTForPretrainFused at BERT-base widths (768 units, 3072 FFN, 12
    heads, vocab 30522, CE chunk 5120), depth cut to 2 layers, f32: three
    TrainStep Adam steps (lr 1e-4) on a (4, 128) batch on the card
    against the same weights and batch on the CPU, which runs every
    kernel's plain version; at ``dropout`` / ``attn_dropout``, each
    device's seed stream is seeded alike, so both runs draw the same step
    seeds and drop the same elements. Limits, set before the first run:
    each step's loss within 1e-5 relative; each parameter's delta over
    the run within 1e-3 of its norm, ‖Δw_card − Δw_cpu‖ / ‖Δw_cpu‖ (Adam
    makes elements whose gradient is f32 noise step by ±lr either way);
    the key third of each QKV bias, whose true gradient is 0 (softmax
    ignores a constant added to every key), held instead to moving less
    than 1% of 3·lr on both sides."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    t0 = time.perf_counter()
    lr, steps = 1e-4, 3
    cpu_net = BERTForPretrainFused(
        num_layers=2, dropout=dropout, attn_dropout=attn_dropout,
        ctx=mx.cpu(), generator=torch.Generator().manual_seed(SEED + 3))
    card_net = copy.deepcopy(cpu_net).cuda()
    units = cpu_net.config["units"]
    w0 = {k: v.detach().clone() for k, v in cpu_net.state_dict().items()}
    rs = np.random.RandomState(SEED + 3)
    tok = rs.randint(0, 30000, (4, 128)).astype(np.int32)
    lab = rs.randint(0, 30000, (4, 128)).astype(np.int32)
    losses, launches = {}, None
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        step = mx.parallel.TrainStep(net, lambda outs, *a: outs, "adam",
                                     loss_only=True,
                                     optimizer_params={"learning_rate": lr})
        mx.random.seed(SEED + 3, ctx=step._device)
        _reset_train_counts()
        losses[name] = [float(step((tok, lab), ())[0])
                        for _ in range(steps)]
        launches = _train_counts()            # the card's run, read last
        buckets = len(step._buckets)
    ratios, key_bias = {}, []
    card_sd = card_net.state_dict()
    for key, start in w0.items():
        dc = (cpu_net.state_dict()[key] - start).flatten()
        dg = (card_sd[key].cpu() - start).flatten()
        if key.endswith("qkv_proj.bias"):
            k_part = torch.arange(units, 2 * units)
            key_bias.append(max(float(dc[k_part].abs().max()),
                                float(dg[k_part].abs().max())))
            keep = torch.ones_like(dc, dtype=torch.bool)
            keep[k_part] = False
            dc, dg = dc[keep], dg[keep]
        norm = float(dc.norm())
        if norm > 0:
            ratios[key] = float((dg - dc).norm()) / norm
        elif float(dg.norm()) != 0.0:
            ratios[key] = float("inf")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _per_step(
        card_net.config, buckets, dropout, attn_dropout).items()}
    out = {"phase": "train_reference",
           "model": "BERTForPretrainFused(num_layers=2)", "dtype": "float32",
           "dropout": dropout, "attn_dropout": attn_dropout,
           "batch": [4, 128], "steps": steps, "lr": lr,
           "losses": losses, "loss_max_rel_diff": loss_rel,
           "loss_tol": 1e-5, "delta_worst": [worst, ratios[worst]],
           "delta_median": float(np.median(list(ratios.values()))),
           "delta_tol": 1e-3, "key_bias_max_abs_delta": max(key_bias),
           "key_bias_tol": 0.01 * steps * lr, "launches": launches,
           "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 training losses on the card disagree with the CPU's: "
             f"{losses}")
    if ratios[worst] > 1e-3 or max(key_bias) > 0.01 * steps * lr:
        fail(f"f32 parameter deltas on the card disagree with the CPU's: "
             f"{worst} {ratios[worst]}, key bias {max(key_bias)}")
    if launches != want:
        fail(f"training reference launch counts {launches} are not {want}")
    del cpu_net, card_net
    torch.cuda.empty_cache()


def phase_bert_train(dropout=0.0, attn_dropout=0.0) -> dict:
    """BERTForPretrainFused at bert_12_768_12 (12 layers, 768 units, 3072
    FFN, 12 heads of 64, vocab 30522, max length 512, CE chunk 5120),
    at ``dropout`` / ``attn_dropout`` (BERT's published 0.1 / 0.1, or 0),
    bf16 with multi-precision Adam (lr 1e-4), seeded random weights, one
    (32, 512) batch of RandomState(0) tokens and labels as in
    bench_bert.py: 3 warm-up and 20 timed TrainStep calls. The loss must
    be finite every step and fall over the run; the launches of every
    kernel must be exactly its per-step count times 20."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    # an earlier phase's model may still be held by a reference cycle
    # (the Llama-3-8B server's 16 GB of weights): collect it, or the
    # peak below counts it
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = BERTForPretrainFused(dropout=dropout, attn_dropout=attn_dropout,
                               ctx="cuda", dtype=torch.bfloat16,
                               generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"], cfg["max_length"],
            cfg["chunk"]) != (12, 768, 3072, 12, 30522, 512, 5120):
        fail(f"not BERT-base at full width and depth: {cfg}")
    mx.random.seed(SEED)
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    step = mx.parallel.TrainStep(
        net, lambda outs, *a: outs, "adam", loss_only=True,
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True})
    warm = [float(step((tok, lab), ())[0]) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(20):
        timed.append(step((tok, lab), ())[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    losses = warm + [float(x) for x in timed]
    per_step = _per_step(cfg, len(step._buckets), dropout, attn_dropout,
                         wgmma=True)
    want = {k: v * 20 for k, v in per_step.items()}
    samples_s = 32 * 20 / wall
    out = {"phase": "bert_train", "model": "BERTForPretrainFused "
           "(bert_12_768_12)", "dtype": "bfloat16, multi-precision adam",
           "dropout": dropout, "attn_dropout": attn_dropout,
           "params": sum(p.numel() for p in net.parameters()),
           "config": cfg, "batch": [32, 512], "steps": 20,
           "ms_per_step": wall * 1e3 / 20, "samples_per_s": samples_s,
           "mfu": samples_s * 6 * 110e6 * 512 / 989e12,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           # host ms each timed call took to return (no synchronise)
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step((tok, lab), ()),
                                              2, n_top=16)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 BERT-base training loss is not finite or did not fall: "
             f"{losses}")
    if launches != want:
        fail(f"BERT-base training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 10-11. BERT pretraining through the eager Gluon path with LAMB
# ---------------------------------------------------------------------------

# the eager path's optimizer, as GluonNLP's BERT pretraining scripts drive
# it: LAMB through gluon.Trainer, no weight decay on beta, gamma and bias
TRAINER_OPT = {"learning_rate": 1e-3, "wd": 0.01, "multi_precision": True}
NO_WD = ".*beta|.*gamma|.*bias"


def _lamb_trainer(net, opt):
    import mxnet_tpu_torch as mx

    params = net.collect_params()
    for p in net.collect_params(NO_WD).values():
        p.wd_mult = 0.0
    return mx.gluon.Trainer(params, "lamb", dict(opt))


def _trainer_step(net, trainer, tok, lab, times=None):
    """One step of the eager path, as a user writes it: the per-position
    loss under autograd.record(), autograd.backward with MXNet's head
    gradient of ones, trainer.step(loss.numel()) (rescale 1 / n, so the
    update is the mean loss's). Returns the mean loss, on the device;
    appends each part's host seconds (forward, backward, step) to
    ``times``."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    with mx.autograd.record():
        loss = net(tok, lab)
    t1 = time.perf_counter()
    mx.autograd.backward(loss)
    t2 = time.perf_counter()
    trainer.step(loss.numel())
    if times is not None:
        times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return loss.detach().float().mean()


def _trainer_buckets(trainer) -> int:
    return len({p.dtype for p in trainer._params if p.grad_req != "null"})


def _trainer_per_step(cfg, buckets, dropout, attn_dropout,
                      wgmma=False) -> dict:
    """Launches of each kernel in one eager step of BERTForPretrainFused:
    the model's as in a TrainStep (_per_step), and one launch of each of
    the three LAMB kernels per dtype bucket in place of the Adam sweep."""
    return {**_per_step(cfg, buckets, dropout, attn_dropout, wgmma),
            "fused_adam_sweep": 0, "fused_lamb_sweep": buckets,
            "fused_lamb_sweep[phase1]": buckets,
            "fused_lamb_sweep[norms]": buckets}


def phase_bert_trainer_reference() -> None:
    """BERTForPretrainFused at BERT-base widths, depth cut to 2 layers,
    f32, at dropout 0.1 / 0.1: three steps of the eager path
    (_trainer_step; LAMB at lr 1e-3, wd 0.01, none on beta, gamma and
    bias) on a (4, 128) batch on the card against the same weights and
    batch on the CPU, each device's seed stream seeded alike by
    mx.random.seed, so both draw the same dropout seeds. Limits, as
    phase_train_reference's: each loss within 1e-5 relative; each
    parameter's delta within 1e-3 of its norm; the key third of each QKV
    bias, whose true gradient is 0, held to moving less than lr per step
    on both sides (LAMB's m / (sqrt(v) + eps) of f32 noise is below 1 in
    magnitude, and the zero-initialised bias takes ratio 1)."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    t0 = time.perf_counter()
    opt = {"learning_rate": TRAINER_OPT["learning_rate"],
           "wd": TRAINER_OPT["wd"]}
    lr, steps = opt["learning_rate"], 3
    cpu_net = BERTForPretrainFused(
        num_layers=2, dropout=0.1, attn_dropout=0.1, ctx=mx.cpu(),
        generator=torch.Generator().manual_seed(SEED + 5))
    card_net = copy.deepcopy(cpu_net).cuda()
    units = cpu_net.config["units"]
    w0 = {k: v.detach().clone() for k, v in cpu_net.state_dict().items()}
    rs = np.random.RandomState(SEED + 5)
    tok = torch.from_numpy(rs.randint(0, 30000, (4, 128)).astype(np.int32))
    lab = torch.from_numpy(rs.randint(0, 30000, (4, 128)).astype(np.int32))
    losses, launches = {}, None
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        dev = next(net.parameters()).device
        trainer = _lamb_trainer(net, opt)
        mx.random.seed(SEED + 5, ctx=dev)
        _reset_train_counts()
        losses[name] = [float(_trainer_step(net, trainer, tok.to(dev),
                                            lab.to(dev)))
                        for _ in range(steps)]
        launches = _train_counts()            # the card's run, read last
        buckets = _trainer_buckets(trainer)
    ratios, key_bias = {}, []
    card_sd = card_net.state_dict()
    for key, start in w0.items():
        dc = (cpu_net.state_dict()[key] - start).flatten()
        dg = (card_sd[key].cpu() - start).flatten()
        if key.endswith("qkv_proj.bias"):
            k_part = torch.arange(units, 2 * units)
            key_bias.append(max(float(dc[k_part].abs().max()),
                                float(dg[k_part].abs().max())))
            keep = torch.ones_like(dc, dtype=torch.bool)
            keep[k_part] = False
            dc, dg = dc[keep], dg[keep]
        norm = float(dc.norm())
        if norm > 0:
            ratios[key] = float((dg - dc).norm()) / norm
        elif float(dg.norm()) != 0.0:
            ratios[key] = float("inf")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _trainer_per_step(
        card_net.config, buckets, 0.1, 0.1).items()}
    out = {"phase": "bert_trainer_reference",
           "model": "BERTForPretrainFused(num_layers=2)", "dtype": "float32",
           "entry_points": "autograd.record, autograd.backward, "
                           "gluon.Trainer('lamb')",
           "dropout": 0.1, "attn_dropout": 0.1, "batch": [4, 128],
           "steps": steps, "optimizer": opt, "no_wd": NO_WD,
           "losses": losses, "loss_max_rel_diff": loss_rel,
           "loss_tol": 1e-5, "delta_worst": [worst, ratios[worst]],
           "delta_median": float(np.median(list(ratios.values()))),
           "delta_tol": 1e-3, "key_bias_max_abs_delta": max(key_bias),
           "key_bias_tol": steps * lr, "launches": launches,
           "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 Trainer losses on the card disagree with the CPU's: "
             f"{losses}")
    if ratios[worst] > 1e-3 or max(key_bias) > steps * lr:
        fail(f"f32 Trainer parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}, key bias {max(key_bias)}")
    if launches != want:
        fail(f"Trainer reference launch counts {launches} are not {want}")
    del cpu_net, card_net
    torch.cuda.empty_cache()


def _lamb_state(trainer) -> list:
    """Each trained parameter's (master, mean, var) as f64 copies on the
    card: the f32 master of a bf16 multi-precision parameter, the f32
    parameter itself otherwise."""
    out = []
    for i, p in enumerate(trainer._params):
        st = trainer._updater.states[i]
        w, (m, v) = st if isinstance(st[1], tuple) \
            else (p.data()._data, st)
        out.append((w.double(), m.double(), v.double()))
    return out


def _lamb_rule_excess(trainer, before, n) -> dict:
    """How far one Trainer LAMB step strayed from its rule, worked by hand
    in f64 from ``before`` (_lamb_state) and each parameter's gradient,
    which the step leaves in its buffer, rescaled by 1 / n: the moments
    within 1e-6 of their largest term; the bias-corrected ``upd``, the
    per-parameter norms and trust ratio, and the new master ``w - lr *
    ratio * upd`` within 1e-6 of the largest master plus 1e-5 of the
    largest step (f32 rounding of each operation; the f32 reciprocal of
    the bias correction; r1 and r2 summed in another order); each bf16
    weight its master rounded. ``worst_excess`` is the largest error
    over its limit (above 1 breaks the rule)."""
    opt = trainer.optimizer
    b1, b2, eps = opt.beta1, opt.beta2, opt.epsilon
    worst, rounded = 0.0, True

    def excess(err, lim):
        return float(err.abs().max()) / max(float(lim), 1e-30)

    for i, (p, (w0, m0, v0), (w1, m1, v1)) in enumerate(
            zip(trainer._params, before, _lamb_state(trainer))):
        t = opt._index_update_count[i]
        lr, wd = opt._get_lr(i), opt._get_wd(i)
        g = p.grad()._data.double() / n
        m = b1 * m0 + (1 - b1) * g
        v = b2 * v0 + (1 - b2) * g * g
        worst = max(worst, excess(m1 - m, 1e-6 * float(
            (b1 * m0.abs() + (1 - b1) * g.abs()).max())))
        worst = max(worst, excess(v1 - v, 1e-6 * float(
            (b2 * v0 + (1 - b2) * g * g).max())))
        upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps) \
            + wd * w0
        r1, r2 = float(w0.norm()), float(upd.norm())
        ratio = r1 / r2 if r1 > 0 and r2 > 0 else 1.0
        step = lr * ratio * upd
        worst = max(worst, excess(w1 - (w0 - step), 1e-6 * float(
            w0.abs().max()) + 1e-5 * float(step.abs().max())))
        if p.dtype == "bfloat16":
            rounded &= torch.equal(p.data()._data, w1.to(torch.bfloat16))
    return {"worst_excess": worst, "bf16_is_master_rounded": bool(rounded),
            "tol": "moments 1e-6 of the largest term; masters 1e-6 of the "
                   "largest master + 1e-5 of the largest step"}


def _forward_memory(net, tok, lab) -> dict:
    """Device memory of one forward whose output is held, over what was
    allocated before it: under autograd.record(), outside it (torch's
    grad mode on: recorded all the same, the saved activations held
    while the output lives) and under autograd.pause() (nothing
    saved)."""
    import contextlib
    import gc

    import mxnet_tpu_torch as mx

    out = {}
    for name, scope in (("record", mx.autograd.record),
                        ("outside_record", contextlib.nullcontext),
                        ("pause", mx.autograd.pause)):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with scope():
            loss = net(tok, lab)
        torch.cuda.synchronize()
        out[name] = {
            "held_gib": (torch.cuda.memory_allocated() - base) / 2 ** 30,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
        del loss
    return out


def phase_bert_trainer() -> dict:
    """The eager Gluon path's main run: BERTForPretrainFused at
    bert_12_768_12 (12 layers, 768 units, 3072 FFN, 12 heads of 64,
    vocab 30522, max length 512, CE chunk 5120), bf16 with seeded random
    weights, at BERT's published dropout 0.1 / 0.1, one (32, 512) batch
    of RandomState(0) tokens and labels as in bench_bert.py, trained
    through net.collect_params(), wd_mult = 0 on every beta, gamma and
    bias, gluon.Trainer(params, "lamb", {lr 1e-3, wd 0.01,
    multi_precision}) and, each step, autograd.record(), autograd
    .backward(loss), trainer.step(loss.numel()): 3 warm-up and 20 timed
    steps. The loss must be finite every step and fall strictly over the
    first three; the second step, the first whose moments are not 0,
    must follow the LAMB rule worked by hand (_lamb_rule_excess); the
    launches must be exactly the model's per step (26/26 LayerNorm, 12
    with dropout, 13/13 bias+GELU, 12/12 flash, 25/25 hash dropout), one
    launch of each LAMB kernel per dtype bucket, and no other sweep.
    Reports ms per step, samples/s, MFU, peak memory, the host ms of the
    forward, the backward and trainer.step apart, the backward's walk of
    the graph alone, a profiled step, and the memory of a forward under
    record(), outside it and under pause()."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    timed_steps = 20
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = BERTForPretrainFused(dropout=0.1, attn_dropout=0.1, ctx="cuda",
                               dtype=torch.bfloat16, generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"], cfg["max_length"],
            cfg["chunk"]) != (12, 768, 3072, 12, 30522, 512, 5120):
        fail(f"not BERT-base at full width and depth: {cfg}")
    trainer = _lamb_trainer(net, TRAINER_OPT)
    mx.random.seed(SEED)
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    warm = [float(_trainer_step(net, trainer, tok, lab))]
    before = _lamb_state(trainer)
    warm.append(float(_trainer_step(net, trainer, tok, lab)))
    rule = _lamb_rule_excess(trainer, before, tok.numel())
    del before
    warm.append(float(_trainer_step(net, trainer, tok, lab)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, times = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(_trainer_step(net, trainer, tok, lab, times))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + [float(x) for x in timed]
    buckets = _trainer_buckets(trainer)
    per_step = _trainer_per_step(cfg, buckets, 0.1, 0.1, wgmma=True)
    want = {k: v * timed_steps for k, v in per_step.items()}
    samples_s = 32 * timed_steps / wall
    host = np.asarray(times) * 1e3
    with mx.autograd.record():
        loss = net(tok, lab)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    n_leaves = len(mx.autograd._leaves([loss]))
    walk_ms = (time.perf_counter() - tw) * 1e3
    del loss
    out = {"phase": "bert_trainer", "model": "BERTForPretrainFused "
           "(bert_12_768_12)",
           "entry_points": "net.collect_params, gluon.Trainer('lamb'), "
                           "autograd.record, autograd.backward, "
                           "Trainer.step",
           "dtype": "bfloat16, multi-precision lamb",
           "optimizer": TRAINER_OPT, "no_wd": NO_WD,
           "dropout": 0.1, "attn_dropout": 0.1,
           "params": sum(p.numel() for p in net.parameters()),
           "config": cfg, "batch": [32, 512], "steps": timed_steps,
           "ms_per_step": wall * 1e3 / timed_steps,
           "samples_per_s": samples_s,
           "mfu": samples_s * 6 * 110e6 * 512 / 989e12,
           "peak_mem_gib": peak, "losses": losses,
           "update_rule_step2": rule, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           # host ms each part took to return (no synchronise)
           "host_ms_forward": float(np.median(host[:, 0])),
           "host_ms_backward": float(np.median(host[:, 1])),
           "host_ms_trainer_step": float(np.median(host[:, 2])),
           "host_ms_backward_graph_walk": walk_ms,
           "backward_leaves": n_leaves, "buckets": buckets}
    out["step_breakdown"] = _device_breakdown(
        lambda: _trainer_step(net, trainer, tok, lab), 2, n_top=16)
    out["forward_memory"] = _forward_memory(net, tok, lab)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(np.isfinite(losses)) \
            or not losses[0] > losses[1] > losses[2]:
        fail(f"bf16 BERT-base Trainer loss is not finite or did not fall "
             f"over the first three steps: {losses}")
    if rule["worst_excess"] > 1.0 or not rule["bf16_is_master_rounded"]:
        fail(f"BERT-base's second LAMB step broke its update rule: {rule}")
    if launches != want:
        fail(f"BERT-base Trainer launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 12-13. Llama pretraining through TrainStep with AdamW
# ---------------------------------------------------------------------------

# the pretraining tool's optimizer (mxnet_tpu_torch/tools/pretrain_llama.py)
LLAMA_OPT = {"learning_rate": 3e-4, "wd": 0.1, "beta1": 0.9, "beta2": 0.95,
             "multi_precision": True}


# ---------------------------------------------------------------------------
# 12-13. the Gluon core as MXNet users write it
# ---------------------------------------------------------------------------

# GluonNLP's BERT fine-tuning; f32 masters, as mixed-precision fine-tuning
# keeps them (an Adam step of ~lr is below half a bf16 ulp of most weights)
GLUON_OPT = {"learning_rate": 2e-5, "multi_precision": True}


def _gluon_inputs(b, l, ragged, ctx, seed):
    """(tokens, token types[, valid_length]) NDArrays on ``ctx`` drawn
    from ``seed``; ``ragged``: a (b,) valid_length in [1, l]."""
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(seed)
    args = [mx.nd.array(rs.randint(1, 30522, (b, l)), ctx=ctx,
                        dtype="float32"),
            mx.nd.array(rs.randint(0, 2, (b, l)), ctx=ctx, dtype="float32")]
    if ragged:
        args.append(mx.nd.array(rs.randint(1, l + 1, (b,)), ctx=ctx,
                                dtype="float32"))
    return args


def _gluon_kernel_nodes(graph) -> dict:
    """A captured graph's kernel nodes of the LayerNorm, flash and
    bias+GELU forwards, by the wrapper that launches each."""
    from mxnet_tpu_torch.kernels._build import graph_kernel_names

    names = graph_kernel_names(graph)
    return {"fused_layer_norm": sum("ln_vec_kernel" in n
                                    or "ln_scalar_kernel" in n
                                    for n in names),
            "flash_attention": sum("flash_fwd" in n for n in names),
            "fused_bias_gelu": sum("bias_gelu_vec_kernel" in n
                                   or "bias_gelu_scalar_kernel" in n
                                   for n in names),
            "all": len(names)}


def _nd_bits(outs) -> list:
    return [o._data.detach().contiguous().view(torch.uint8).cpu()
            for o in outs]


def _gluon_step(net, trainer, loss_fn, args, labels, times=None):
    """One fine-tuning step as a GluonNLP user writes it: the classifier
    logits' softmax cross-entropy under autograd.record(), loss.backward()
    on the NDArray, trainer.step(batch). Returns the mean loss (a float,
    synchronising); appends the host seconds of the forward, the backward
    and the step to ``times``."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    with mx.autograd.record():
        loss = loss_fn(net(*args)[2], labels)
    t1 = time.perf_counter()
    loss.backward()
    t2 = time.perf_counter()
    trainer.step(labels.shape[0])
    if times is not None:
        times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return float(loss.mean().asscalar())


def phase_gluon_reference() -> None:
    """The Gluon workflow in f32 at BERT-base widths (768 units, 3072 FFN,
    12 heads, vocab 30522), depth cut to 2 layers, pooler and classifier,
    dropout 0.1 / 0.1, TF32 off: the model built through the new API
    (``bert_12_768_12(...)``, ``initialize(mx.init.Normal(0.02), ctx=)``)
    on the card and on the CPU, the card's weights carried to the CPU by
    a ``.params`` file (``save_parameters`` / ``load_parameters``). The
    hybridized predict forward on the card (CUDA graphs, at (4, 128) and
    at (4, 128) with a ragged valid_length) against the eager forward on
    the CPU, which runs every kernel's plain version: each output within
    1e-4 of its largest magnitude. Then three record / loss.backward() /
    Trainer.step Adam steps (lr 1e-4) on each device with the same u32
    dropout seeds (each device's stream seeded alike): each loss within
    1e-5 relative, each parameter's delta within 1e-3 of its norm
    (‖Δcard − Δcpu‖ / ‖Δcpu‖), the key third of each QKV bias, whose true
    gradient is 0, held apart to moving less than lr per step."""
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(num_layers=2, use_pooler=True, use_classifier=True,
              use_decoder=False, dropout=0.1, attn_dropout=0.1)
    mx.random.seed(SEED + 6)
    card_net, cpu_net = bert_12_768_12(**kw), bert_12_768_12(**kw)
    card_net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    cpu_net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.params")
        card_net.save_parameters(path)
        cpu_net.load_parameters(path)
    units = cpu_net.config["units"]
    w0 = {k: p.data().asnumpy() for k, p in
          cpu_net._collect_params_with_prefix().items()}
    card_net.hybridize(static_alloc=True, static_shape=True)
    predict = {}
    for ragged in (False, True):
        cpu_args = _gluon_inputs(4, 128, ragged, mx.cpu(), SEED + 6)
        card_args = [a.as_in_context(mx.gpu(0)) for a in cpu_args]
        got = [o.asnumpy() for o in card_net(*card_args)]
        want = [o.asnumpy() for o in cpu_net(*cpu_args)]
        rel = [float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want)]
        predict["ragged" if ragged else "full"] = rel
    captures = card_net.cached_graph.captures
    losses, launches = {}, None
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for name, net, ctx in (("cpu", cpu_net, mx.cpu()),
                           ("card", card_net, mx.gpu(0))):
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-4})
        args = _gluon_inputs(4, 128, False, ctx, SEED + 7)
        labels = mx.nd.array(np.arange(4) % 2, ctx=ctx)
        mx.random.seed(SEED + 7, ctx=ctx)
        _reset_train_counts()
        losses[name] = [_gluon_step(net, trainer, loss_fn, args, labels)
                        for _ in range(3)]
        launches = _train_counts()            # the card's run, read last
    lr, steps = 1e-4, 3
    ratios, key_bias = {}, []
    card_w = {k: p.data().asnumpy() for k, p in
              card_net._collect_params_with_prefix().items()}
    for key, start in w0.items():
        dc = (cpu_net._collect_params_with_prefix()[key].data().asnumpy()
              - start).ravel()
        dg = (card_w[key] - start).ravel()
        if key.endswith("qkv_proj.bias"):
            part = slice(units, 2 * units)
            key_bias.append(max(float(np.abs(dc[part]).max()),
                                float(np.abs(dg[part]).max())))
            dc, dg = np.delete(dc, part), np.delete(dg, part)
        norm = float(np.linalg.norm(dc))
        if norm > 0:
            ratios[key] = float(np.linalg.norm(dg - dc)) / norm
        elif float(np.linalg.norm(dg)) != 0.0:
            ratios[key] = float("inf")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    out = {"phase": "gluon_reference",
           "model": "bert_12_768_12(num_layers=2, use_decoder=False)",
           "dtype": "float32",
           "entry_points": "bert_12_768_12, initialize(mx.init.Normal(0.02)"
                           ", ctx=), save_parameters/load_parameters, "
                           "hybridize, autograd.record, NDArray.backward, "
                           "gluon.Trainer('adam')",
           "predict_err_over_max_output": predict, "predict_tol": 1e-4,
           "graph_captures": captures, "dropout": 0.1, "attn_dropout": 0.1,
           "batch": [4, 128], "steps": steps, "losses": losses,
           "loss_max_rel_diff": loss_rel, "loss_tol": 1e-5,
           "delta_worst": [worst, ratios[worst]],
           "delta_median": float(np.median(list(ratios.values()))),
           "delta_tol": 1e-3, "key_bias_max_abs_delta": max(key_bias),
           "key_bias_tol": steps * lr, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if max(max(v) for v in predict.values()) > 1e-4:
        fail(f"hybridized f32 BERT on the card disagrees with the CPU: "
             f"{predict}")
    if captures != 2:
        fail(f"{captures} graph captures for 2 signatures")
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 Gluon losses on the card disagree with the CPU's: "
             f"{losses}")
    if ratios[worst] > 1e-3 or max(key_bias) > steps * lr:
        fail(f"f32 Gluon parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}, key bias {max(key_bias)}")
    del cpu_net, card_net
    torch.cuda.empty_cache()


def _gluon_predict_per_forward(layers, ragged) -> dict:
    """Forward launches of bert_12_768_12 without the MLM head: embed_ln
    and two add+norms per layer, the FFN's bias+GELU, one flash attention
    per layer; a valid_length masks keys, which the flash kernels do not
    take, so those calls take the dense route, as the reference's do
    (``sdp_attention``: flash only ``if mask is None``)."""
    return {"fused_layer_norm": 2 * layers + 1,
            "flash_attention": 0 if ragged else layers,
            "fused_bias_gelu": layers}


def phase_gluon() -> dict:
    """bert_12_768_12 with pooler and classifier, no decoder, not cut,
    bf16, every NDArray on mx.gpu(), as a GluonNLP user fine-tunes and
    serves it: ``initialize(mx.init.Normal(0.02), ctx=mx.gpu())``,
    ``cast("bfloat16")``, ``hybridize(static_alloc=True,
    static_shape=True)``.

    predict: first the eager forward, before ``hybridize``, so that no
    block below runs a graph (checked), at (32, 128) and (32, 512) and at
    (32, 128) with a ragged valid_length; then the hybridized forward at
    the same signatures: each graph's output equals the eager forward's
    bit for bit; exactly one capture per signature and none over 20
    replays of each; launches per replay equal to the graph's own kernel
    nodes and to the model's (25 LayerNorm, 12 flash, 12 bias+GELU; 0
    flash with the valid_length); host and device ms per forward,
    hybridized and eager, and the card's idle share.

    train: batch 32 x 128, dropout 0.1 / 0.1, Adam at 2e-5 with f32
    masters, one fixed batch, 3 warm-up and 10 timed steps of record /
    loss.backward() / Trainer.step; the loss finite and falling strictly
    over the first three steps; every trained parameter's gradient an
    NDArray; every trained parameter's f32 master moved; exactly the
    model's launches per step (LayerNorm, bias+GELU and flash forward and
    backward, hash dropout, one Adam sweep per dtype bucket, no other
    training kernel); ms per step, samples/s and the host ms of the
    forward, the backward and Trainer.step.

    save/load: save_parameters, then a fresh bert_12_768_12(...) whose
    load_parameters(ctx=mx.gpu()) reads it back bit for bit, MB/s each
    way."""
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    gpu = mx.gpu(0)
    kw = dict(use_pooler=True, use_classifier=True, use_decoder=False,
              dropout=0.1, attn_dropout=0.1)
    mx.random.seed(SEED + 8)
    net = bert_12_768_12(**kw)
    net.initialize(mx.init.Normal(0.02), ctx=gpu)
    net.cast("bfloat16")
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"]) != (12, 768, 3072, 12,
                                                     30522):
        fail(f"not BERT-base at full width and depth: {cfg}")
    layers = cfg["num_layers"]
    names = ("fused_layer_norm", "flash_attention", "fused_bias_gelu")
    sigs = {"32x128": (32, 128, False), "32x512": (32, 512, False),
            "32x128_valid_length": (32, 128, True)}
    # the eager forward of every signature, before hybridize: every block
    # below runs eagerly
    eager_bits, eager_times = {}, {}
    for key, (b, l, ragged) in sigs.items():
        args = _gluon_inputs(b, l, ragged, gpu, SEED + 8)
        eager_bits[key] = _nd_bits(net(*args))

        def eager_fwd(args=args):
            net(*args)

        eager_times[key] = _device_breakdown(eager_fwd, 10)
    graphs = [blk for blk in net.modules()
              if getattr(blk, "cached_graph", None) is not None]
    if graphs:
        fail(f"gluon: {len(graphs)} blocks ran graphs before hybridize()")
    net.hybridize(static_alloc=True, static_shape=True)
    predict = {}
    for key, (b, l, ragged) in sigs.items():
        args = _gluon_inputs(b, l, ragged, gpu, SEED + 8)
        before = net.cached_graph.captures if net.cached_graph else 0
        graph_out = net(*args)                       # the capture
        entry = list(net.cached_graph._graphs.values())[-1]
        torch.cuda.synchronize()
        _reset_bert_counts()
        replays, issue = 20, []
        for _ in range(replays):
            t = time.perf_counter()
            out = net(*args)
            issue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        launches = _bert_counts()
        captures = net.cached_graph.captures - before
        eager = eager_bits[key]
        same = all(torch.equal(a, b) for a, b in
                   zip(_nd_bits(out), eager)) and all(
            torch.equal(a, b) for a, b in zip(_nd_bits(graph_out), eager))
        per = _gluon_predict_per_forward(layers, ragged)
        nodes = _gluon_kernel_nodes(entry.graph)
        per_replay = {fn.__name__: n for (fn, attr), n in
                      entry.launches.items()
                      if attr == "launches" and fn.__name__ in names}
        per_replay = {n: per_replay.get(n, 0) for n in names}

        def graph_fwd(args=args):
            net(*args)

        hyb = _device_breakdown(graph_fwd, 10)
        eag = eager_times[key]
        predict[key] = {
            "graph_equals_eager_bits": bool(same),
            "captures": captures, "replays": replays,
            "launches": launches,
            "launches_expected": {k: v * replays for k, v in per.items()},
            "launches_per_replay": per_replay,
            "kernel_nodes": nodes,
            "host_issue_ms_per_forward": 1e3 * float(np.mean(issue)),
            "hybridized": {k: hyb[k] for k in (
                "host_ms_per_step", "device_ms_per_step",
                "device_idle_share")},
            "eager": {k: eag[k] for k in (
                "host_ms_per_step", "device_ms_per_step",
                "device_idle_share")}}
        rec = predict[key]
        if not same:
            fail(f"gluon {key}: the graph's output is not the eager "
                 "forward's bit for bit")
        if captures != 1:
            fail(f"gluon {key}: {captures} captures, not 1")
        if launches != rec["launches_expected"] or per_replay != per \
                or any(nodes[n] != per[n] for n in names):
            fail(f"gluon {key}: launches {launches} (per replay "
                 f"{per_replay}, kernel nodes {nodes}) are not "
                 f"{rec['launches_expected']}")
    steady = net.cached_graph.captures
    # --- train ---------------------------------------------------------
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               dict(GLUON_OPT))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    args = _gluon_inputs(32, 128, False, gpu, SEED + 9)
    labels = mx.nd.array(np.arange(32) % 2, ctx=gpu)
    buckets = len({p.dtype for p in trainer._params
                   if p.grad_req != "null"})
    start = {i: p.tensor.detach().float().clone()
             for i, p in enumerate(trainer._params) if p.grad_req != "null"}
    _reset_train_counts()
    first = [_gluon_step(net, trainer, loss_fn, args, labels)
             for _ in range(3)]
    torch.cuda.synchronize()
    warm_launches = _train_counts()
    grads_nd = all(isinstance(p.grad(), mx.nd.NDArray)
                   and p.grad()._data is p.tensor.grad
                   for p in trainer._params if p.grad_req != "null")
    want = {k: v * 3 for k, v in _per_step(
        dict(cfg, num_layers=layers), buckets, 0.1, 0.1,
        wgmma=True).items()}
    # the classifier path has no MLM head: one LayerNorm and one
    # bias+GELU fewer each way than BERTForPretrainFused's
    for k in ("fused_layer_norm", "fused_layer_norm_bwd"):
        want[k] -= 3
    for k in ("fused_bias_gelu", "fused_bias_gelu_bwd"):
        want[k] -= 3
    times = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [_gluon_step(net, trainer, loss_fn, args, labels, times)
              for _ in range(10)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t1) * 1e3 / 10
    host = np.mean(np.asarray(times), axis=0) * 1e3
    # each master against its start; the share of each bf16 weight that
    # changed shows what the masters carry
    masters = {i: trainer._updater.states[i][0] for i in start}
    still = [trainer._params[i].name for i, w in start.items()
             if torch.equal(masters[i], w)]
    moved = {trainer._params[i].name: float(
        (trainer._params[i].tensor.float() != w).float().mean())
        for i, w in start.items()}
    del start, masters
    train = {"batch": [32, 128], "dropout": 0.1, "attn_dropout": 0.1,
             "optimizer": dict(GLUON_OPT, name="adam"),
             "first_losses": first, "losses": losses,
             "ms_per_step": ms_step, "samples_per_s": 32e3 / ms_step,
             "host_ms": {"forward": float(host[0]),
                         "backward": float(host[1]),
                         "trainer_step": float(host[2])},
             "grads_are_ndarrays": bool(grads_nd), "dtype_buckets": buckets,
             "masters_unmoved": still,
             "bf16_share_changed_min": min(moved.values()),
             "bf16_share_changed_median": float(np.median(
                 list(moved.values()))),
             "launches_warmup": warm_launches,
             "launches_expected": want}
    if not all(np.isfinite(first + losses)) or not (
            first[0] > first[1] > first[2]):
        fail(f"gluon train: the loss is not finite and falling: {first}")
    if not grads_nd:
        fail("gluon train: a gradient is not an NDArray over the buffer")
    if still:
        fail(f"gluon train: {len(still)} f32 masters did not move: "
             f"{still[:8]}")
    if warm_launches != want:
        fail(f"gluon train launch counts {warm_launches} are not {want}")
    if net.cached_graph.captures != steady:
        fail("gluon: Trainer.step made the graphs recapture")
    # --- save / load ----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.params")
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.save_parameters(path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        fresh = bert_12_768_12(**kw)
        fresh.cast("bfloat16")
        t = time.perf_counter()
        fresh.load_parameters(path, ctx=gpu)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    mine = net._collect_params_with_prefix()
    theirs = fresh._collect_params_with_prefix()
    bits = sorted(mine) == sorted(theirs) and all(
        torch.equal(mine[k].tensor.view(torch.int16),
                    theirs[k].tensor.view(torch.int16)) for k in mine)
    saveload = {"bytes": size, "params": len(mine),
                "save_s": save_s, "load_s": load_s,
                "save_MB_per_s": size / 1e6 / save_s,
                "load_MB_per_s": size / 1e6 / load_s,
                "bit_for_bit": bool(bits)}
    if not bits:
        fail("gluon: load_parameters did not read save_parameters back "
             "bit for bit")
    out = {"phase": "gluon", "model": "bert_12_768_12(use_pooler=True, "
           "use_classifier=True, use_decoder=False)", "dtype": "bfloat16",
           "predict": predict, "train": train, "save_load": saveload,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del net, fresh, trainer
    torch.cuda.empty_cache()
    return warm_launches


def _llama_per_step(cfg, buckets, wgmma=False) -> dict:
    """Launches of each training kernel in one TrainStep of a Llama with
    the fused CE head: two RMSNorms per layer and the final one, forward
    and backward; one flash attention per layer, forward and backward (on
    the warpgroup route with ``wgmma``: bf16); one AdamW
    scan and sweep per dtype bucket; nothing else."""
    layers = cfg["num_layers"]
    return {**dict.fromkeys(_train_counts(), 0),
            "fused_rms_norm": 2 * layers + 1,
            "fused_rms_norm_bwd": 2 * layers + 1,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "flash_attention[wgmma]": layers if wgmma else 0,
            "flash_attention_bwd[wgmma]": layers if wgmma else 0,
            "fused_adamw_sweep": buckets, "fused_adamw_sweep[scan]": buckets}


def _llama_glue_ms(batch=8, seq=2048, heads=16, kv_heads=8, d=128) -> dict:
    """Device ms of two pieces of plain PyTorch glue around the kernels of
    one proxy1b layer, forward and backward through autograd, event-timed
    with a cold L2: rope on q and k (f32 inside, the JAX op's numerics)
    and the repeat of k and v up to the query heads (GQA). Neither is a
    Pallas site; this says what each costs per layer."""
    from mxnet_tpu_torch.ops.attention import rope

    def leaf(h):
        return torch.randn(batch, seq, h, d, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()

    q, k, v = leaf(heads), leaf(kv_heads), leaf(kv_heads)
    gq, gk = torch.randn_like(q), torch.randn_like(k)
    rep = heads // kv_heads

    def rope_step():
        outs = (rope(q, theta=500000.0), rope(k, theta=500000.0))
        torch.autograd.grad(outs, (q, k), (gq, gk))

    def repeat_step():
        outs = (k.repeat_interleave(rep, dim=2),
                v.repeat_interleave(rep, dim=2))
        torch.autograd.grad(outs, (k, v), (gq, gq))

    flush = _L2Flush()
    return {"rope_q_k_fwd_bwd_ms": time_ms(rope_step, flush),
            "repeat_k_v_fwd_bwd_ms": time_ms(repeat_step, flush)}


def phase_llama_train_reference() -> None:
    """LlamaModel(fused_ce=True) at proxy1b widths (2048 units, 7168 FFN,
    16 heads of 128 over 8 KV heads, vocab 32768, CE chunk 8192), depth
    cut to 2 layers, f32: three TrainStep AdamW steps with the pretraining tool's
    optimizer on a (2, 128) batch on the card against the same weights
    and batch on the CPU, which runs every kernel's plain version.
    Limits, set before the first run: each step's loss within 1e-5
    relative; each parameter's delta over the run within 1e-3 of its
    norm, ||dw_card - dw_cpu|| / ||dw_cpu||."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_proxy1b
    from mxnet_tpu_torch.tools.pretrain_llama import _FusedLossPassthrough

    t0 = time.perf_counter()
    steps = 3
    cpu_net = llama_proxy1b(num_layers=2, fused_ce=True, ctx=mx.cpu(),
                            generator=torch.Generator().manual_seed(SEED + 5))
    card_net = copy.deepcopy(cpu_net).cuda()
    w0 = {k: v.detach().clone() for k, v in cpu_net.state_dict().items()}
    toks = np.random.RandomState(SEED + 5).randint(0, 32768, (2, 129))
    batch = ((toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)),
             ())
    losses, launches = {}, None
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        step = mx.parallel.TrainStep(net, _FusedLossPassthrough(), "adamw",
                                     loss_only=True,
                                     optimizer_params=dict(LLAMA_OPT))
        _reset_train_counts()
        losses[name] = [float(step(*batch)[0]) for _ in range(steps)]
        launches = _train_counts()            # the card's run, read last
        buckets = len(step._buckets)
    ratios = {}
    card_sd = card_net.state_dict()
    for key, start in w0.items():
        dc = (cpu_net.state_dict()[key] - start).flatten()
        dg = (card_sd[key].cpu() - start).flatten()
        ratios[key] = float((dg - dc).norm()) / float(dc.norm())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _llama_per_step(
        {"num_layers": 2}, buckets).items()}
    emit({"phase": "llama_train_reference",
          "model": "llama_proxy1b(num_layers=2, fused_ce=True)",
          "dtype": "float32", "optimizer": LLAMA_OPT, "batch": [2, 128],
          "steps": steps, "losses": losses, "loss_max_rel_diff": loss_rel,
          "loss_tol": 1e-5, "delta_worst": [worst, ratios[worst]],
          "delta_median": float(np.median(list(ratios.values()))),
          "delta_tol": 1e-3, "launches": launches,
          "launches_expected": want, "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 Llama training losses on the card disagree with the "
             f"CPU's: {losses}")
    if not ratios[worst] <= 1e-3:
        fail(f"f32 Llama parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}")
    if launches != want:
        fail(f"Llama training reference launch counts {launches} are not "
             f"{want}")
    del cpu_net, card_net, step
    torch.cuda.empty_cache()


def phase_llama_train() -> dict:
    """The proxy1b Llama (tools/pretrain_llama.py's config: 10 layers,
    2048 units, 7168 FFN, 16 heads of 128 over 8 KV heads, vocab 32768,
    700.5M parameters), not cut, built by the port's pretraining tool: bf16
    weights from seed 0, fused CE head, multi-precision AdamW (lr 3e-4,
    wd 0.1, beta 0.9 / 0.95), one (8, 2048) batch of RandomState(0)
    tokens as the pretraining tool's _make_data draws them (bench_llama.py's
    shape): 3 warm-up and 10 timed TrainStep calls. The loss must be
    finite every step and fall over the run; the launches of every
    training kernel must be exactly its per-step count times 10."""
    import gc

    from mxnet_tpu_torch.tools import pretrain_llama

    # the serving and BERT phases' models may still be held by reference
    # cycles: collect them, or the peak below counts them
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, seq, timed_steps = 8, 2048, 10
    cfg = pretrain_llama.CONFIGS["proxy1b"]
    # --no-remat, as bench_llama.py runs it (phase 13a runs the
    # driver's default, remat on)
    net, step = pretrain_llama.build("proxy1b", ctx="cuda", remat=False)
    if net._decode_cfg["num_layers"] != 10 or net._ce_chunk != 8192:
        fail(f"not proxy1b at full depth: {net._decode_cfg}")
    n_params = pretrain_llama.param_count(cfg)
    tok, lab = next(pretrain_llama._make_data(
        "synthetic", batch, seq, cfg["vocab_size"], torch.device("cuda")))
    warm = [float(step((tok, lab), ())[0]) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step((tok, lab), ())[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    losses = warm + [float(x) for x in timed]
    per_step = _llama_per_step(cfg, len(step._buckets), wgmma=True)
    want = {k: v * timed_steps for k, v in per_step.items()}
    tokens_s = batch * seq * timed_steps / wall
    out = {"phase": "llama_train", "model": "LlamaModel(fused_ce=True), "
           "proxy1b", "dtype": "bfloat16, multi-precision adamw",
           "optimizer": LLAMA_OPT, "params": n_params,
           "params_counted": sum(p.numel() for p in net.parameters()),
           "config": cfg, "batch": [batch, seq], "steps": timed_steps,
           "ms_per_step": wall * 1e3 / timed_steps,
           "tokens_per_s": tokens_s,
           "mfu": 6.0 * n_params * tokens_s / 989e12,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step((tok, lab), ()),
                                              2, n_top=16)
    out["glue_per_layer"] = _llama_glue_ms()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 proxy1b training loss is not finite or did not fall: "
             f"{losses}")
    if launches != want:
        fail(f"proxy1b training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 14-15. ResNet-50 v1 training through TrainStep with SGD momentum
# ---------------------------------------------------------------------------

RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}


class _Decisions:
    """The card's ReLU, ReLU6 and max-pool decisions, recorded in call order
    during its run and replayed on the CPU copy's. A ReLU network's
    gradient jumps where a ReLU input crosses 0 or two inputs of a
    max-pool window swap places; the card and the CPU round differently,
    so an input within f32 rounding of such a point takes one side on
    one device and the other side on the other, and every gradient
    upstream of it moves by that element's share of its layer's, far
    above the f32 noise the limits allow. Replayed, both devices compute
    the same piecewise-linear function and the comparison reads the ops'
    rounding alone; ``disagreements`` counts the elements where the CPU
    would have decided otherwise, out of ``elements`` replayed."""

    def __init__(self):
        import torch.nn.functional as F

        from mxnet_tpu_torch.ops import nn as ops_nn

        self._ops, self._f = ops_nn, F
        self._max_pool2d = F.max_pool2d
        self.log, self.pos, self.mode = [], 0, None
        self.disagreements = self.elements = 0

    def relu(self, x):
        keep = x > 0
        if self.mode == "record":
            self.log.append(keep.cpu())
            return torch.relu(x)
        want = self.log[self.pos].to(x.device)
        self.pos += 1
        self.disagreements += int((keep != want).sum())
        self.elements += want.numel()
        return torch.where(want, x, torch.zeros((), dtype=x.dtype))

    def max_pool2d(self, x, kernel, stride, pad):
        out, idx = self._max_pool2d(x, kernel, stride, pad,
                                    return_indices=True)
        if self.mode == "record":
            self.log.append(idx.cpu())
            return out
        want = self.log[self.pos].to(x.device)
        self.pos += 1
        self.disagreements += int((idx != want).sum())
        self.elements += want.numel()
        n, c = x.shape[:2]
        return x.reshape(n, c, -1).gather(2, want.reshape(n, c, -1)) \
            .view(want.shape)

    def relu6(self, x, real):
        """MobileNet's ReLU6: which side of 0 and of 6 each input takes
        (0 below, 1 between, 2 above), recorded (the block's own
        ``real()`` computing) or replayed."""
        side = (x > 0).to(torch.int8) + (x >= 6).to(torch.int8)
        if self.mode == "record":
            self.log.append(side.cpu())
            return real()
        want = self.log[self.pos].to(x.device)
        self.pos += 1
        self.disagreements += int((side != want).sum())
        self.elements += want.numel()
        return torch.where(want == 1, x, torch.where(
            want == 2, torch.full((), 6.0, dtype=x.dtype, device=x.device),
            torch.zeros((), dtype=x.dtype, device=x.device)))

    def run(self, mode, fn):
        """``fn()`` with the decisions recorded (``"record"``) or
        replayed (``"replay"``)."""
        from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet

        self.mode, self.pos = mode, 0
        relu = self._ops._ACTIVATIONS["relu"]
        self._ops._ACTIVATIONS["relu"] = self.relu
        self._f.max_pool2d = self.max_pool2d
        self._relu6 = mobilenet.ReLU6.hybrid_forward
        relu6 = self._relu6
        mobilenet.ReLU6.hybrid_forward = \
            lambda blk, F, x: self.relu6(x, lambda: relu6(blk, F, x))
        try:
            return fn()
        finally:
            self._ops._ACTIVATIONS["relu"] = relu
            self._f.max_pool2d = self._max_pool2d
            mobilenet.ReLU6.hybrid_forward = self._relu6


def _resnet_per_step(buckets) -> dict:
    """Launches of each training kernel in one TrainStep of a ResNet v1:
    one SGD sweep per dtype bucket and nothing else (convolution,
    BatchNorm, pooling and the loss are library and plain PyTorch
    ops)."""
    return {**dict.fromkeys(_train_counts(), 0), "fused_sgd_sweep": buckets}


def _running_stats(net) -> dict:
    return {k: v.detach().float().cpu().clone()
            for k, v in net.state_dict().items() if "running" in k}


def phase_resnet_train_reference() -> None:
    """resnet18_v1(classes=10, layout="NHWC") at 64x64 (the 7x7 stem, the
    max pool, basic blocks), f32, seeded weights: three TrainStep SGD
    steps (lr 1e-3, momentum 0.9) on a batch of 4 with float labels on
    the card against the same weights and batch on the CPU, which runs
    the plain versions, with TF32 off in cuDNN for the phase (restored
    after it), and the CPU copy taking the card's ReLU and max-pool
    decisions (_Decisions). Limits, set before the first run: each
    step's loss within 1e-5 relative; every running mean and variance
    after each step within 1e-5 + 1e-5 |cpu|; each parameter's delta
    over the run within 1e-3 of its norm; exactly one sweep per step
    and no other training kernel. The replay may cover at most 1e-5 of
    the decisions it replays (about 25 of some 2.5M here; two runs
    found 2), so a fault on the card upstream of a kink, which moves
    many decisions, cannot hide behind it."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1

    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    steps, opt = 3, {"learning_rate": 1e-3, "momentum": 0.9}
    card_net = resnet18_v1(classes=10, layout="NHWC", ctx="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 7))
    cpu_net = copy.deepcopy(card_net).cpu()
    w0 = {k: v.detach().cpu().clone()
          for k, v in card_net.named_parameters()}
    rs = np.random.RandomState(SEED + 7)
    x = rs.randn(4, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    decisions = _Decisions()
    losses, stats = {}, {}
    for name, net in (("card", card_net), ("cpu", cpu_net)):
        step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     optimizer_params=dict(opt))
        _reset_train_counts()

        def run():
            got = []
            for _ in range(steps):
                got.append((float(step(x, y)[0]), _running_stats(net)))
            return got

        got = decisions.run("record" if name == "card" else "replay", run)
        losses[name] = [g[0] for g in got]
        stats[name] = [g[1] for g in got]
        if name == "card":
            launches = _train_counts()
            buckets = len(step._buckets)
    torch.backends.cudnn.allow_tf32 = tf32
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    stat_err = max(float(((a[k] - b[k]).abs()
                          - 1e-5 * b[k].abs()).max())
                   for a, b in zip(stats["card"], stats["cpu"]) for k in a)
    ratios = {}
    cpu_params = dict(cpu_net.named_parameters())
    for key, p in card_net.named_parameters():
        dc = (cpu_params[key].detach() - w0[key]).flatten()
        dg = (p.detach().cpu() - w0[key]).flatten()
        ratios[key] = float((dg - dc).norm()) / float(dc.norm())
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _resnet_per_step(buckets).items()}
    emit({"phase": "resnet_train_reference",
          "model": "resnet18_v1(classes=10, layout='NHWC')",
          "dtype": "float32", "optimizer": opt, "batch": [4, 3, 64, 64],
          "steps": steps, "losses": losses, "loss_max_rel_diff": loss_rel,
          "loss_tol": 1e-5, "running_stats_excess_over_tol": stat_err,
          "running_stats_tol": "1e-5 + 1e-5 |cpu|",
          "delta_worst": [worst, ratios[worst]],
          "delta_median": float(np.median(list(ratios.values()))),
          "delta_tol": 1e-3,
          "decisions_replayed": decisions.elements,
          "decision_disagreements": decisions.disagreements,
          "decision_disagreements_limit": 1e-5 * decisions.elements,
          "launches": launches, "launches_expected": want,
          "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 ResNet training losses on the card disagree with the "
             f"CPU's: {losses}")
    if stat_err > 1e-5:
        fail(f"f32 ResNet running statistics on the card disagree with the "
             f"CPU's by {stat_err} over 1e-5 + 1e-5 |cpu|")
    if not ratios[worst] <= 1e-3:
        fail(f"f32 ResNet parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}")
    if launches != want:
        fail(f"ResNet training reference launch counts {launches} are not "
             f"{want}")
    if decisions.disagreements > 1e-5 * decisions.elements:
        fail(f"the CPU would decide {decisions.disagreements} of "
             f"{decisions.elements} ReLU and max-pool elements otherwise "
             "than the card: more than f32 rounding near a kink explains")
    del cpu_net, card_net, step
    torch.cuda.empty_cache()


def _masters_and_momenta(step) -> list:
    """Each trained parameter's (master, momentum) as f64 copies on the
    card: the f32 master of a bf16 multi-precision parameter, the f32
    parameter itself (BatchNorm's gamma and beta) otherwise."""
    out = []
    for p, st in zip(step._params, step._states):
        w, mom = st if isinstance(st, tuple) else (p.detach(), st)
        out.append((w.double(), mom.double()))
    return out


def _sgd_rule_excess(step, before, opt) -> dict:
    """How far one TrainStep SGD step strayed from its rule, worked by
    hand in f64 from ``before`` (_masters_and_momenta) and each
    parameter's gradient, which the step leaves in ``.grad``: with
    ``g' = g + wd * master`` (wd the optimizer's for that parameter),
    the new momentum ``momentum * mom - lr * g'`` within 1e-6 of its
    largest term, the new master ``master + mom`` within 1e-6 of the
    largest master (f32 rounding of each operation), each bf16 weight its
    master rounded. ``worst_excess`` is the largest error over its limit
    (above 1 breaks the rule); no clipping or rescale, as the benchmark's
    optimizer has none."""
    mu, lr = opt["momentum"], opt["learning_rate"]
    worst, rounded = 0.0, True
    for k, (p, (w0, m0), (w1, m1)) in enumerate(zip(
            step._params, before, _masters_and_momenta(step))):
        wd = float(step.optimizer._get_wd(k))
        g = p.grad.double() + wd * w0
        lim = 1e-6 * float((mu * m0.abs() + lr * g.abs()).max())
        worst = max(worst, float((m1 - (mu * m0 - lr * g)).abs().max())
                    / max(lim, 1e-30))
        lim = 1e-6 * float(w0.abs().max())
        worst = max(worst, float((w1 - (w0 + m1)).abs().max())
                    / max(lim, 1e-30))
        if p.dtype == torch.bfloat16:
            rounded &= torch.equal(p.detach(), w1.to(torch.bfloat16))
    return {"worst_excess": worst, "bf16_is_master_rounded": bool(rounded),
            "tol": "1e-6 of the largest term"}


def _conv_flops_per_image(net, size=224) -> float:
    """Training FLOPs per image from the model's own convolution and
    Dense shapes: 2 x the multiply-adds of the forward (each
    convolution's output elements times its weight's in-channels per
    group and taps, each Dense's in x out), times 3 for the forward and
    the two backward products."""
    return 3.0 * 2.0 * _macs_per_image(net, size)


def _macs_per_image(net, size=224) -> float:
    """The forward's multiply-adds per image, counted by hooks on every
    convolution and Dense of ``net`` over one (1, 3, size, size) bf16
    forward on the card."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    macs = []

    def hook(mod, inp, out):
        k = mod.weight.tensor
        if isinstance(mod, gnn.Dense):
            macs.append(k.numel())
        else:
            macs.append(out.numel() / out.shape[0] * k[0].numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (_Conv, gnn.Dense))]
    with torch.no_grad():
        net(torch.zeros(1, 3, size, size, device="cuda",
                        dtype=torch.bfloat16))
    for h in handles:
        h.remove()
    return float(sum(macs))


def _bn_glue_ms(net, x, timer=None) -> dict:
    """Device ms of the plain BatchNorm forward and backward over one
    step's calls (53 in ResNet-50 and MobileNet v2), by
    :func:`_shape_glue_ms` with ``timer`` (default :func:`time_ms`, five
    calls): bf16 input, f32 gamma and beta. Not a Pallas site; this is
    its share of the step."""
    from mxnet_tpu_torch.gluon import nn as gnn

    return _shape_glue_ms(
        net, x, lambda m: isinstance(m, gnn.BatchNorm), _bn_fwd_bwd,
        timer or functools.partial(time_ms, iters=5, warmup=1))


def _bn_fwd_bwd(mod, xx):
    from mxnet_tpu_torch.ops import nn as ops_nn

    c = xx.shape[-1]
    g = torch.ones(c, device="cuda", requires_grad=True)
    b = torch.zeros(c, device="cuda", requires_grad=True)
    dy = torch.randn_like(xx)

    def run():
        out = ops_nn.batch_norm(xx, g, b, b, g, eps=1e-5, fix_gamma=False,
                                axis=-1, training=True)[0]
        torch.autograd.grad(out, (xx, g, b), dy)

    return run


def _shape_glue_ms(net, x, want, make, timer) -> dict:
    """Device ms of the modules of ``net`` that ``want(module)`` picks,
    forward and backward, over one step: each one's input shape read
    from a forward at the step's batch, each distinct shape timed once
    on bf16 inputs (cold L2) through ``make(module, x)``'s closure by
    ``timer(fn, flush)`` and counted as often as the model has it."""
    shapes, mods = {}, {}

    def hook(mod, inp, out):
        key = tuple(inp[0].shape)
        shapes[key] = shapes.get(key, 0) + 1
        mods[key] = mod

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if want(m)]
    with torch.no_grad():
        net(x)
    for h in handles:
        h.remove()
    flush = _L2Flush()
    total, per = 0.0, {}
    for key, count in shapes.items():
        xx = torch.randn(key, device="cuda",
                         dtype=torch.bfloat16).requires_grad_()
        ms = timer(make(mods[key], xx), flush)
        per[str(list(key))] = {"calls": count, "ms_fwd_bwd": ms}
        total += count * ms
        del xx
    torch.cuda.empty_cache()
    return {"ms_per_step": total, "by_shape": per}


def _resnet_kind(name) -> str:
    """Device events of a ResNet step by kind: the SGD sweep, pooling,
    elementwise and reduction glue (BatchNorm, ReLU, the residual adds,
    the loss), copies, and the rest, which is cuDNN's convolutions (and
    its layout transforms) and the classifier's GEMM."""
    low = name.lower()
    if "sgd_kernel" in name:
        return "sgd_sweep"
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels_other"
    if "memcpy" in low or "memset" in low:
        return "copy_memset"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in ("elementwise", "reduce", "index", "gather",
                              "scatter", "softmax", "fill")):
        return "elementwise_and_reduction_glue"
    return "cudnn_conv_and_gemm"


def phase_resnet_train() -> dict:
    """resnet50_v1(layout="NHWC") at its published widths and depth (1000
    classes, 25.56M parameters), bf16 with f32 BatchNorm, seeded random
    weights, SoftmaxCrossEntropyLoss, SGD at lr 0.1, momentum 0.9,
    multi-precision, as bench.py:221-251 builds it: one (256, 3, 224,
    224) batch of RandomState(0) images with float labels, 3 warm-up and
    20 timed TrainStep calls, cuDNN's autotuner on (torch.backends.cudnn
    .benchmark, restored after). The loss must be finite every step and
    fall strictly over the first three; the second step, the first whose
    momentum is not 0, must follow the update rule by hand
    (_sgd_rule_excess); every running statistic must move, and the
    launches must be exactly one SGD sweep per dtype bucket (2) per step
    and no other training kernel. Past the first steps, at lr 0.1 and
    momentum 0.9 with no warm-up on one repeated batch, the loss
    overshoots and swings, above its first value and back; the JAX
    package's own TrainStep does the same at these settings
    (tests/test_torch_resnet_train.py, run as a script), so where the
    last step lands is not a condition."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, timed_steps = 256, 20
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    net = resnet50_v1(layout="NHWC", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 optimizer_params=dict(RESNET_OPT))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(np.float32)) \
        .cuda()
    stats0 = _running_stats(net)
    warm = [float(step(x, y)[0])]
    before = _masters_and_momenta(step)
    warm.append(float(step(x, y)[0]))
    rule = _sgd_rule_excess(step, before, RESNET_OPT)
    del before
    warm.append(float(step(x, y)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step(x, y)[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + [float(v) for v in timed]
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in _running_stats(net).items())
    per_step = _resnet_per_step(len(step._buckets))
    want = {k: v * timed_steps for k, v in per_step.items()}
    flops = _conv_flops_per_image(net)
    images_s = batch * timed_steps / wall
    out = {"phase": "resnet_train",
           "model": "resnet50_v1(layout='NHWC')",
           "dtype": "bfloat16, f32 BatchNorm, multi-precision sgd",
           "optimizer": RESNET_OPT,
           "params": sum(p.numel() for p in net.parameters()),
           "batch": [batch, 3, 224, 224], "steps": timed_steps,
           "cudnn_benchmark": True,
           "ms_per_step": wall * 1e3 / timed_steps,
           "images_per_s": images_s, "flops_per_image": flops,
           "mfu": flops * images_s / 989e12, "peak_mem_gib": peak,
           "losses": losses, "running_stats_moved": [moved, len(stats0)],
           "update_rule_step2": rule,
           "launches": launches, "launches_expected": want,
           "launches_per_step": per_step,
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step(x, y), 2,
                                              n_top=16, kind=_resnet_kind)
    out["bn_glue"] = _bn_glue_ms(net, x)
    out["seconds"] = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = bench
    emit(out)
    if not all(np.isfinite(losses)) \
            or not losses[0] > losses[1] > losses[2]:
        fail(f"bf16 ResNet-50 training loss is not finite or did not fall "
             f"over the first three steps: {losses}")
    if rule["worst_excess"] > 1.0 or not rule["bf16_is_master_rounded"]:
        fail(f"ResNet-50's second SGD step broke its update rule: {rule}")
    if moved != len(stats0):
        fail(f"only {moved} of {len(stats0)} BatchNorm running statistics "
             "moved")
    if launches != want or per_step["fused_sgd_sweep"] != 2:
        fail(f"ResNet-50 training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 13a. proxy1b under remat: the driver's default and both policies
# ---------------------------------------------------------------------------

def _remat_per_step(cfg, buckets) -> dict:
    """Launches of each training kernel in one TrainStep of a Llama whose
    blocks are rematerialised: the no-remat counts (_llama_per_step) with
    each block's two RMSNorm forwards and its flash forward run again in
    the backward's recompute (the final norm sits outside the blocks);
    the backward kernels run once."""
    layers = cfg["num_layers"]
    out = _llama_per_step(cfg, buckets, wgmma=True)
    out["fused_rms_norm"] += 2 * layers
    out["flash_attention"] += layers
    out["flash_attention[wgmma]"] += layers
    return out


def _step_state_bits(step) -> dict:
    """Each trained parameter's weight and f32 master after a step, on
    the card, keyed by its name."""
    names = {id(p): n for n, p in step.net.named_parameters()}
    out = {}
    for p, st in zip(step._params, step._states):
        out[names[id(p)]] = p.detach().clone()
        if isinstance(st, tuple) and isinstance(st[0], torch.Tensor):
            out[names[id(p)] + "[master]"] = st[0].detach().clone()
    return out


def phase_llama_remat() -> dict:
    """The proxy1b Llama at full width and depth (700.5M parameters),
    built by mxnet_tpu_torch.tools.pretrain_llama as in phase 13 (bf16,
    fused CE head, multi-precision AdamW, weights from seed 0, one (8,
    2048) batch), in three settings from the same weights and batch: no
    remat (the reference), the driver's default (per-block remat,
    "full") and --remat dots. With either policy the first step's loss
    and every parameter's weight and f32 master after it must equal the
    no-remat step's bit for bit (the same kernels run on the same
    inputs; a parameter that differs is named). Then 2 more warm-up and
    6 timed steps each: ms per step, tokens/s, MFU (6 N per token, the
    recompute not counted as useful work), peak memory over the timed
    steps, and exactly the per-step launches: under remat 21 + 20
    RMSNorm and 10 + 10 flash forwards (each block's two norms and one
    flash again in the recompute), 21 and 10 backwards."""
    import gc

    from mxnet_tpu_torch.tools import pretrain_llama

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, seq, timed_steps = 8, 2048, 6
    cfg = pretrain_llama.CONFIGS["proxy1b"]
    n_params = pretrain_llama.param_count(cfg)
    default = pretrain_llama.resolve_remat("proxy1b", None)
    settings = [("no_remat", False), ("driver_default", None),
                ("dots", "dots")]
    ref, out, fails = None, {}, []
    for name, flag in settings:
        net, step = pretrain_llama.build("proxy1b", ctx="cuda", remat=flag)
        tok, lab = next(pretrain_llama._make_data(
            "synthetic", batch, seq, cfg["vocab_size"],
            torch.device("cuda")))
        first = float(step((tok, lab), ())[0])
        bits = _step_state_bits(step)
        rec = {"remat": net._remat, "first_loss": first}
        if ref is None:
            ref = (first, bits)
        else:
            diff = [k for k, v in bits.items()
                    if not torch.equal(v, ref[1][k])]
            rec["first_loss_bits_equal"] = first == ref[0]
            rec["params_differing"] = diff
            rec["params_compared"] = len(bits)
            if first != ref[0] or diff:
                fails.append(f"{name}: loss {first} vs {ref[0]}, "
                             f"differing {diff[:8]}")
        del bits
        losses = [first] + [float(step((tok, lab), ())[0]) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_train_counts()
        t1 = time.perf_counter()
        timed = [step((tok, lab), ())[0] for _ in range(timed_steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _train_counts()
        per = (_remat_per_step if net._remat else
               lambda c, b: _llama_per_step(c, b, wgmma=True))(
                   cfg, len(step._buckets))
        want = {k: v * timed_steps for k, v in per.items()}
        tokens_s = batch * seq * timed_steps / wall
        rec.update({"ms_per_step": wall * 1e3 / timed_steps,
                    "tokens_per_s": tokens_s,
                    "mfu": 6.0 * n_params * tokens_s / 989e12,
                    "peak_mem_gib": torch.cuda.max_memory_allocated()
                    / 2 ** 30,
                    "losses": losses + [float(x) for x in timed],
                    "launches": launches, "launches_per_step": per})
        if launches != want:
            fails.append(f"{name}: launches {launches} are not {want}")
        if not all(np.isfinite(rec["losses"])):
            fails.append(f"{name}: a loss is not finite: {rec['losses']}")
        out[name] = rec
        del step, net, timed
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "llama_remat", "model": "LlamaModel(fused_ce=True), "
          "proxy1b", "dtype": "bfloat16, multi-precision adamw",
          "params": n_params, "batch": [batch, seq], "steps": timed_steps,
          "driver_default_remat": default, "settings": out,
          "seconds": time.perf_counter() - t0})
    if default != "full":
        fails.append(f"the driver's default remat is {default!r}")
    if fails:
        fail("proxy1b under remat: " + "; ".join(fails))
    return out["driver_default"]["launches"]


# ---------------------------------------------------------------------------
# 15a. per-parameter optimizer updates against the fused sweeps
# ---------------------------------------------------------------------------

def phase_optimizer_paths() -> None:
    """For SGD (momentum 0.9), Adam, AdamW and LAMB, in f32 and in bf16
    with f32 masters: three updates of a BERT layer's parameter shapes
    (768 x 768, 3072 x 768, 768 x 3072, 3072, 768) through the fused
    sweep (the family's kernels, plan_eager/apply_eager_plan) and through
    the per-parameter Updater (the optimizer's update over NDArrays, the
    ops' plain PyTorch), from the same weights and gradients, on the
    card. Every weight, master and state must agree bit for bit; each
    fused run launches its family's sweep once a step, and the
    per-parameter LAMB the sweep once a parameter (its norms must be the
    kernel's sums: LAMB.update), the other families none."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import multi_tensor as mt

    t0 = time.perf_counter()
    shapes = [(768, 768), (3072, 768), (768, 3072), (3072,), (768,)]
    kws = {"sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
           "adam": {"learning_rate": 1e-3, "wd": 1e-4},
           "adamw": {"learning_rate": 1e-3, "wd": 0.01, "beta2": 0.95},
           "lamb": {"learning_rate": 1e-3, "wd": 0.01}}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    out, fails = {}, []
    for family, kw in kws.items():
        for dtype in (torch.float32, torch.bfloat16):
            mp = dtype == torch.bfloat16
            w0 = [torch.randn(s, generator=gen, device="cuda").to(dtype)
                  for s in shapes]
            grads = [[torch.randn(s, generator=gen, device="cuda").to(dtype)
                      for s in shapes] for _ in range(3)]
            cls = type(mx.optimizer.create(family))
            fused_opt = cls(multi_precision=mp, **kw)
            per_opt = type("PerParam", (cls,), {})(multi_precision=mp, **kw)
            fu, pu = mx.optimizer.Updater(fused_opt), \
                mx.optimizer.Updater(per_opt)
            wf = [w.clone() for w in w0]
            wp = [w.clone() for w in w0]
            kernel = getattr(mx.kernels, f"fused_{family}_sweep")
            launched = per_launched = 0
            for gs in grads:
                items = [(i, w, g) for i, (w, g) in enumerate(zip(wf, gs))]
                n0 = kernel.launches
                plan = mt.plan_eager(fused_opt, fu, items)
                mt.apply_eager_plan(fused_opt, fu, plan, items)
                n1 = kernel.launches
                for i, (w, g) in enumerate(zip(wp, gs)):
                    pu(i, NDArray(g), NDArray(w))
                launched += n1 - n0
                per_launched += kernel.launches - n1
            torch.cuda.synchronize()

            def leaves(s):
                if s is None:
                    return []
                if isinstance(s, tuple):
                    return [x for v in s for x in leaves(v)]
                return [s._data if isinstance(s, NDArray) else s]

            differ = [f"w{i}" for i in range(len(wf))
                      if not torch.equal(wf[i], wp[i])]
            for i in fu.states:
                for k, (a, b) in enumerate(zip(leaves(fu.states[i]),
                                               leaves(pu.states[i]))):
                    if not torch.equal(a, b):
                        differ.append(f"state{i}.{k}")
            worst = max(float(((a.float() - b.float()).abs()
                               / a.float().abs().max()).max())
                        for a, b in zip(wf, wp))
            key = f"{family}[{'bf16-mp' if mp else 'f32'}]"
            # LAMB's per-parameter update takes the kernels over its one
            # parameter on the card (LAMB.update); the others, the ops
            want_per = 3 * len(shapes) if family == "lamb" else 0
            out[key] = {"bits_equal": not differ, "differing": differ,
                        "max_diff_over_max_abs": worst,
                        "sweep_launches": launched,
                        "per_param_sweep_launches": per_launched}
            if differ:
                fails.append(f"{key}: {differ}")
            if launched != 3 or per_launched != want_per:
                fails.append(f"{key}: {launched} fused and {per_launched} "
                             f"per-parameter sweeps, not 3 and {want_per}")
    emit({"phase": "optimizer_paths", "shapes": shapes, "results": out,
          "seconds": time.perf_counter() - t0})
    if fails:
        fail("per-parameter updates differ from the fused sweeps: "
             + "; ".join(fails))


# ---------------------------------------------------------------------------
# 15b-15c. ResNet v2 through the eager Gluon loop: NAG, a cosine schedule
# ---------------------------------------------------------------------------

V2_NAG = {"momentum": 0.9, "wd": 1e-4}


def _v2_schedule(base_lr, max_update, warmup):
    import mxnet_tpu_torch as mx

    return mx.lr_scheduler.CosineScheduler(
        max_update=max_update, base_lr=base_lr, final_lr=0.0,
        warmup_steps=warmup, warmup_begin_lr=0.0, warmup_mode="linear")


def _cosine_by_hand(n, base_lr, max_update, warmup):
    """The cosine schedule with its linear warmup at update ``n``, worked
    from its definition."""
    import math

    if n < warmup:
        return base_lr * n / warmup
    if n <= max_update:
        return base_lr * (1 + math.cos(math.pi * (n - warmup)
                                       / (max_update - warmup))) / 2
    return 0.0


def _eager_step(net, loss_fn, trainer, x, y, times=None):
    """One step of the eager Gluon loop: the loss under record(),
    autograd.backward, trainer.step(batch). Returns the mean loss on the
    device; appends the host seconds of the three parts to ``times``."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    t1 = time.perf_counter()
    mx.autograd.backward(loss)
    t2 = time.perf_counter()
    trainer.step(x.shape[0])
    if times is not None:
        times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return loss.detach().float().mean()


def phase_resnet_v2_trainer_reference() -> None:
    """resnet18_v2(classes=10) at 64x64, batch 4, f32 with TF32 off:
    three eager steps (_eager_step) with Trainer('nag', momentum 0.9, wd
    1e-4, a cosine schedule with a linear warmup of 2 over 10 updates
    from lr 0.01) on the card against the same weights and batch on the
    CPU, which replays the card's ReLU and max-pool decisions
    (_Decisions). Limits as phase 14's: each loss within 1e-5 relative,
    every running statistic after each step within 1e-5 + 1e-5 |cpu|,
    each parameter's delta within 1e-3 of its norm, at most 1e-5 of the
    replayed decisions disagreeing; no fused sweep launches. Then, on the
    card: save_parameters and save_states after step 2, a fresh model
    load_parameters and a fresh Trainer load_states, and its step 3
    equal to the uninterrupted step 3 bit for bit (weights, running
    statistics, momenta). cuDNN runs its deterministic algorithms in the
    phase (restored after it)."""
    import copy
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v2

    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default convolution backward algorithms may sum with
    # atomics, and then no two runs of a step agree bit for bit: the
    # resume check below needs the deterministic ones
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    steps, sched = 3, (0.01, 10, 2)

    def trainer_of(net):
        return mx.gluon.Trainer(net.collect_params(), "nag", dict(
            V2_NAG, lr_scheduler=_v2_schedule(*sched)))

    card_net = resnet18_v2(classes=10, ctx="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 13))
    cpu_net = copy.deepcopy(card_net).cpu()
    w0 = {k: v.detach().cpu().clone()
          for k, v in card_net.named_parameters()}
    rs = np.random.RandomState(SEED + 13)
    x = torch.from_numpy(rs.randn(4, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (4,)).astype(np.float32))
    loss_fn = SoftmaxCrossEntropyLoss()
    decisions = _Decisions()
    losses, stats, resume = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, net in (("card", card_net), ("cpu", cpu_net)):
            dev = next(net.parameters()).device
            trainer = trainer_of(net)
            _reset_train_counts()

            def run():
                got = []
                for k in range(steps):
                    if name == "card" and k == 2:
                        net.save_parameters(os.path.join(tmp, "w.params"))
                        trainer.save_states(os.path.join(tmp, "t.states"))
                    got.append((float(_eager_step(net, loss_fn, trainer,
                                                  x.to(dev), y.to(dev))),
                                _running_stats(net)))
                return got

            got = decisions.run("record" if name == "card" else "replay",
                                run)
            losses[name] = [g[0] for g in got]
            stats[name] = [g[1] for g in got]
            if name == "card":
                launches = _train_counts()
                card_states = {i: [t.clone() for t in _state_leaves(s)]
                               for i, s in trainer._updater.states.items()}
                lrs = trainer.learning_rate
        fresh = resnet18_v2(classes=10, ctx="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(SEED + 99))
        fresh.load_parameters(os.path.join(tmp, "w.params"))
        tr2 = trainer_of(fresh)
        tr2.load_states(os.path.join(tmp, "t.states"))
        replay = _Decisions()
        replay.run("record", lambda: _eager_step(
            fresh, loss_fn, tr2, x.cuda(), y.cuda()))
        diff = [k for k, v in fresh.state_dict().items()
                if not torch.equal(v, card_net.state_dict()[k])]
        for i, s in tr2._updater.states.items():
            for j, (a, b) in enumerate(zip(_state_leaves(s),
                                           card_states[i])):
                if not torch.equal(a, b):
                    diff.append(f"state{i}.{j}")
        resume = {"bits_equal": not diff, "differing": diff[:8],
                  "n_differing": len(diff),
                  "n_compared": len(fresh.state_dict()) + sum(
                      len(card_states[i]) for i in card_states),
                  "num_update": tr2.optimizer.num_update,
                  "learning_rate": tr2.learning_rate,
                  "uninterrupted_learning_rate": lrs}
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = deterministic
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    stat_err = max(float(((a[k] - b[k]).abs()
                          - 1e-5 * b[k].abs()).max())
                   for a, b in zip(stats["card"], stats["cpu"]) for k in a)
    ratios = {}
    cpu_params = dict(cpu_net.named_parameters())
    for key, p in card_net.named_parameters():
        dc = (cpu_params[key].detach() - w0[key]).flatten()
        dg = (p.detach().cpu() - w0[key]).flatten()
        ratios[key] = float((dg - dc).norm()) / float(dc.norm())
    worst = max(ratios, key=ratios.get)
    sweeps = {k: v for k, v in launches.items() if "sweep" in k and v}
    emit({"phase": "resnet_v2_trainer_reference",
          "model": "resnet18_v2(classes=10)", "dtype": "float32",
          "entry_points": "autograd.record, autograd.backward, "
                          "gluon.Trainer('nag', lr_scheduler="
                          "CosineScheduler)",
          "optimizer": dict(V2_NAG, schedule=sched), "batch": [4, 3, 64, 64],
          "steps": steps, "losses": losses, "loss_max_rel_diff": loss_rel,
          "loss_tol": 1e-5, "running_stats_excess_over_tol": stat_err,
          "running_stats_tol": "1e-5 + 1e-5 |cpu|",
          "delta_worst": [worst, ratios[worst]],
          "delta_median": float(np.median(list(ratios.values()))),
          "delta_tol": 1e-3, "decisions_replayed": decisions.elements,
          "decision_disagreements": decisions.disagreements,
          "sweep_launches": sweeps, "resume_step3": resume,
          "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 ResNet v2 Trainer losses on the card disagree with the "
             f"CPU's: {losses}")
    if stat_err > 1e-5:
        fail(f"ResNet v2 running statistics on the card disagree with the "
             f"CPU's by {stat_err} over 1e-5 + 1e-5 |cpu|")
    if not ratios[worst] <= 1e-3:
        fail(f"ResNet v2 parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}")
    if decisions.disagreements > 1e-5 * decisions.elements:
        fail(f"the CPU would decide {decisions.disagreements} of "
             f"{decisions.elements} ReLU and max-pool elements otherwise")
    if sweeps:
        fail(f"the NAG Trainer launched sweep kernels: {sweeps}")
    if not resume["bits_equal"]:
        fail(f"step 3 after save_states/load_states differs from the "
             f"uninterrupted step 3: {resume}")
    del cpu_net, card_net, fresh
    torch.cuda.empty_cache()


def _state_leaves(state) -> list:
    from mxnet_tpu_torch.ndarray import NDArray

    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _state_leaves(s)]
    return [state._data if isinstance(state, NDArray) else state]


def _master_and_momentum(p, state) -> tuple:
    """A Trainer parameter's (f32 master, momentum) as f64 copies: the
    master of a bf16 weight under multi_precision, the f32 weight itself
    (BatchNorm's gamma and beta) otherwise."""
    if isinstance(state, tuple):
        return state[0]._data.double(), state[1]._data.double()
    return p._var.detach().double(), state._data.double()


def _nag_rule_excess(trainer, before, opt, lr) -> dict:
    """How far one Trainer NAG step strayed from its rule, worked by hand
    in f64 from ``before`` (each parameter's f32 master and momentum) and
    the gradients the step read: g' = rescale * g + wd * w, mom' =
    momentum * mom + g', w' = w - lr * (g' + momentum * mom'), each
    within 1e-6 of its largest term (f32 rounding of each operation);
    each bf16 weight its master rounded."""
    mu, wd = opt["momentum"], opt["wd"]
    rescale = trainer.optimizer.rescale_grad
    worst, rounded = 0.0, True
    for i, p in enumerate(trainer._params):
        if p.grad_req == "null":
            continue
        w0, m0 = before[i]
        st = trainer._updater.states[i]
        w1, m1 = _master_and_momentum(p, st)
        g = p._var.grad.double() * rescale + wd * w0
        lim = 1e-6 * float((mu * m0.abs() + g.abs()).max())
        worst = max(worst, float((m1 - (mu * m0 + g)).abs().max())
                    / max(lim, 1e-30))
        lim = 1e-6 * float((w0.abs() + lr * (g.abs() + mu * m1.abs()))
                           .max())
        worst = max(worst, float((w1 - (w0 - lr * (g + mu * m1)))
                                 .abs().max()) / max(lim, 1e-30))
        if p._var.dtype == torch.bfloat16:
            rounded &= torch.equal(p._var.detach(), st[0]._data.to(
                torch.bfloat16))
    return {"worst_excess": worst, "bf16_is_master_rounded": bool(rounded),
            "tol": "1e-6 of the largest term"}


def phase_resnet_v2_trainer() -> dict:
    """resnet50_v2(layout="NHWC") at its published widths and depth (1000
    classes), bf16 with f32 BatchNorm, seeded random weights, at
    GluonCV's per-device batch, 128 x 224, through the eager Gluon loop
    of GluonCV's ImageNet recipe (train_imagenet.py): Trainer('nag',
    momentum 0.9, wd 1e-4, multi_precision) with a cosine schedule from
    lr 0.05 after a linear warmup of 3 updates, over 20 updates so that
    the rate moves in the phase, cuDNN's autotuner on. 3 warm-up and 12
    timed steps on one RandomState(0) batch. Checks: the loss finite and
    falling over the first three steps; each step's learning rate the
    schedule's worked by hand; step 2 (the first with a momentum) against
    NAG's rule by hand in f64, each bf16 weight its master rounded; no
    sweep kernel launched; exactly one per_param dispatch per trainable
    parameter per step. Numbers: ms per step, images/s, host ms of the
    forward, backward and Trainer.step, save_states and load_states MB/s
    and peak memory."""
    import gc
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v2

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, timed_steps, sched = 128, 12, (0.05, 20, 3)
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    net = resnet50_v2(layout="NHWC", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    opt = dict(V2_NAG, multi_precision=True)
    trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                               dict(opt, lr_scheduler=_v2_schedule(*sched)))
    n_train = sum(p.grad_req != "null" for p in trainer._params)
    loss_fn = SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(np.float32)) \
        .cuda()
    lr_err, lrs = 0.0, []

    def step(times=None):
        loss = _eager_step(net, loss_fn, trainer, x, y, times)
        n = trainer.optimizer.num_update
        lrs.append(trainer.learning_rate)
        nonlocal lr_err
        lr_err = max(lr_err, abs(trainer.learning_rate
                                 - _cosine_by_hand(n, *sched)))
        return loss

    warm = [float(step())]
    before = {i: _master_and_momentum(trainer._params[i], s)
              for i, s in trainer._updater.states.items()}
    warm.append(float(step()))
    rule = _nag_rule_excess(trainer, before, opt, lrs[-1])
    del before
    warm.append(float(step()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    mx.telemetry.reset()
    mx.telemetry.enable()
    timed, times = [], []
    t1 = time.perf_counter()
    try:
        for _ in range(timed_steps):
            timed.append(step(times))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        snap = mx.telemetry.snapshot()["metrics"]
    finally:
        mx.telemetry.disable()
        mx.telemetry.reset()
    dispatch = {s["labels"]["path"]: s["value"] for s in snap.get(
        "mxnet_optimizer_dispatch_total", {"samples": []})["samples"]}
    launches = _train_counts()
    sweeps = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + [float(v) for v in timed]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.states")
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        trainer.save_states(path)
        save_s = time.perf_counter() - s0
        mb = os.path.getsize(path) / 1e6
        s0 = time.perf_counter()
        trainer.load_states(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - s0
    host = np.asarray(times) * 1e3
    images_s = batch * timed_steps / wall
    out = {"phase": "resnet_v2_trainer",
           "model": "resnet50_v2(layout='NHWC')",
           "dtype": "bfloat16, f32 BatchNorm, multi-precision nag",
           "entry_points": "autograd.record, autograd.backward, "
                           "gluon.Trainer('nag', lr_scheduler="
                           "CosineScheduler)",
           "optimizer": opt, "schedule": {"base_lr": sched[0],
                                          "max_update": sched[1],
                                          "warmup_steps": sched[2]},
           "params": sum(p.numel() for p in net.parameters()),
           "trainable_params": n_train, "batch": [batch, 3, 224, 224],
           "steps": timed_steps, "ms_per_step": wall * 1e3 / timed_steps,
           "images_per_s": images_s, "peak_mem_gib": peak,
           "host_ms_median": {"forward": float(np.median(host[:, 0])),
                              "backward": float(np.median(host[:, 1])),
                              "trainer_step": float(np.median(host[:, 2]))},
           "losses": losses, "learning_rates": lrs,
           "lr_max_abs_err_vs_hand": lr_err, "update_rule_step2": rule,
           "per_param_dispatches": dispatch,
           "per_param_expected": n_train * timed_steps,
           "sweep_launches": sweeps,
           "states_mb": mb, "save_states_mb_s": mb / save_s,
           "load_states_mb_s": mb / load_s,
           "seconds": time.perf_counter() - t0}
    torch.backends.cudnn.benchmark = bench
    emit(out)
    if not all(np.isfinite(losses)) \
            or not losses[0] > losses[1] > losses[2]:
        fail(f"bf16 ResNet-50 v2 Trainer loss is not finite or did not "
             f"fall over the first three steps: {losses}")
    if lr_err > 1e-12 or len(set(lrs)) < 3:
        fail(f"the Trainer's learning rates {lrs} are not the schedule's "
             f"(max error {lr_err})")
    if rule["worst_excess"] > 1.0 or not rule["bf16_is_master_rounded"]:
        fail(f"ResNet-50 v2's second NAG step broke its update rule: {rule}")
    if sweeps:
        fail(f"the NAG Trainer launched training kernels: {sweeps}")
    if dispatch != {"per_param": float(n_train * timed_steps)}:
        fail(f"per_param dispatches {dispatch}, not {n_train} a step")
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 16-17. mx.rtc over NVRTC, and the imperative mx.nd path
# ---------------------------------------------------------------------------

def _rtc_cases():
    """The user kernels and their plain versions, one copy shared with
    the card tests (tests/test_torch_cuda_rtc.py)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / \
        "test_torch_cuda_rtc.py"
    spec = importlib.util.spec_from_file_location("_cuda_rtc_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled_kernel_ms(fn, flush, kernel, iters=20, warmup=3) -> float:
    """Mean device ms of the kernel named ``kernel`` over ``iters`` calls
    of ``fn``, each after an L2 flush, from torch.profiler's device
    events: the kernel's own time, without the host's time to launch it
    (an event pair around a launch whose Python checks take longer than
    the flush before it times those too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # torch.profiler now and then drops a whole window's device events in
    # a long process (the rtc phase's row_sum, PR 18 F and PR 23 F):
    # such a window is profiled again, up to three in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.key == kernel:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                return us / 1e3 / e.count
    fail(f"torch.profiler recorded no device event named {kernel} in "
         "three windows")


def _raises_mxnet_error(fn) -> str:
    """The message of the MXNetError ``fn`` raises; fails if it raises
    none."""
    from mxnet_tpu_torch.base import MXNetError

    try:
        fn()
    except MXNetError as e:
        return str(e)
    fail(f"expected an MXNetError from {fn}")


def _empty_nvrtc_tier() -> None:
    """Remove the NVRTC disk tier's CUBINs (an earlier run's), so the next
    module made compiles."""
    import shutil

    from mxnet_tpu_torch.compiler import persistent

    shutil.rmtree(persistent.base_dir() / "nvrtc", ignore_errors=True)


def phase_rtc(card: str) -> dict:
    """mx.rtc.CudaModule on the card: each module compiled by NVRTC to an
    sm_90a CUBIN; upstream MXNet's axpy as a template (axpy<float>,
    axpy<double>, axpy<__half>) over (16, 128), and its shared-memory
    saxpy; the JAX package's two tests/test_rtc.py kernels in CUDA (axpy
    at alpha 2.5 over (16, 128), the grid band-scale over (8, 128));
    row sums of a (16384, 768) f32 matrix through dynamic shared memory
    (one block per row, and again above 48 KiB), to 1e-6 relative of an
    f64 sum; a user axpy over a (32, 512, 768) activation in bf16 and
    f32, compiled with --fmad=false and bit-identical to its plain
    version (two roundings), timed with a cold L2 beside its byte bound
    and torch.add(y, x, alpha=a); the NVRTC compile ms per module, a
    cached get_kernel's ms and the host us per launch; and the refusals
    (a syntax error with NVRTC's log, a dtype mismatch, a strided view,
    a 2048-thread block, a CPU NDArray, a CPU launch), each an
    MXNetError. The NVRTC disk tier is emptied first, so each module's
    ``compile_ms`` is an NVRTC compile (its ``image_source`` says so), as
    is that of ``imperative``'s module after it."""
    import mxnet_tpu_torch as mx

    C = _rtc_cases()
    gpu = mx.gpu(0)
    flush = _L2Flush()
    t0 = time.perf_counter()
    out = {"phase": "rtc", "card": card}
    _empty_nvrtc_tier()
    mods = {
        "upstream": mx.rtc.CudaModule(C.UPSTREAM_SRC, options=C.FMAD_OFF,
                                      exports=C.UPSTREAM_EXPORTS),
        "jax_tests": mx.rtc.CudaModule(C.JAX_TESTS_SRC, options=C.FMAD_OFF),
        "row_sum": mx.rtc.CudaModule(C.ROW_SUM_SRC),
        "bert_axpy": mx.rtc.CudaModule(C.BERT_AXPY_SRC, options=C.FMAD_OFF)}
    out["compile_ms"] = {k: m.compile_ms for k, m in mods.items()}
    out["image_source"] = {k: m.image_source for k, m in mods.items()}
    if set(out["image_source"].values()) != {"nvrtc"}:
        fail(f"rtc: an image came from elsewhere than NVRTC: "
             f"{out['image_source']}")
    sig = "const float *x, float *y, float alpha, int n"
    tg = time.perf_counter()
    for _ in range(1000):
        mods["upstream"].get_kernel("axpy<float>", sig)
    out["get_kernel_ms"] = (time.perf_counter() - tg)
    checks = {}
    rs = np.random.RandomState(0)
    for export in C.UPSTREAM_EXPORTS:
        ctype, dtype = C.UPSTREAM_TYPES[export]
        k = mods["upstream"].get_kernel(
            export, f"const {ctype} *x, {ctype} *y, {ctype} alpha, int n")
        x = mx.nd.array(rs.randn(*C.AXPY_SHAPE), ctx=gpu, dtype=dtype)
        y = mx.nd.array(rs.randn(*C.AXPY_SHAPE), ctx=gpu, dtype=dtype)
        want = C.axpy_plain(x._data, y._data,
                            torch.tensor(C.AXPY_ALPHA, dtype=dtype).item())
        k.launch([x, y, C.AXPY_ALPHA, x.size], gpu, (C.grid_for(x.size),),
                 (C.THREADS,))
        checks[export] = torch.equal(y._data, want)
    k = mods["upstream"].get_kernel("saxpy", "const float *x, float *y, "
                                             "float alpha")
    x, y = mx.nd.ones((10,), ctx=gpu), mx.nd.zeros((10,), ctx=gpu)
    k.launch([x, y, 3.0], gpu, (1, 1, 1), (10, 1, 1), 40)
    checks["saxpy"] = bool((y.asnumpy() == 3).all())
    x = mx.nd.array(rs.randn(*C.AXPY_SHAPE), ctx=gpu)
    y = mx.nd.array(rs.randn(*C.AXPY_SHAPE), ctx=gpu)
    o = mx.nd.zeros(C.AXPY_SHAPE, ctx=gpu)
    mods["jax_tests"].get_kernel(
        "axpy_out", "const float *x, const float *y, float *o, float alpha, "
                    "int n").launch([x, y, o, C.AXPY_ALPHA, x.size], gpu,
                                    (C.grid_for(x.size),), (C.THREADS,))
    checks["axpy_out"] = torch.equal(
        o._data, C.axpy_plain(x._data, y._data, C.AXPY_ALPHA))
    xb = mx.nd.array(rs.randn(*C.BLOCKY_SHAPE), ctx=gpu)
    ob = mx.nd.zeros(C.BLOCKY_SHAPE, ctx=gpu)
    mods["jax_tests"].get_kernel(
        "blocky", "const float *x, float *o, int cols").launch(
        [xb, ob, C.BLOCKY_SHAPE[1]], gpu, (C.BLOCKY_GRID,), (128,))
    checks["blocky"] = torch.equal(ob._data, C.blocky_plain(xb._data))
    rows, cols = C.ROW_SUM_SHAPE
    k = mods["row_sum"].get_kernel("row_sum",
                                   "const float *x, float *out, int cols")
    x = mx.nd.array(np.random.RandomState(1).rand(rows, cols), ctx=gpu)
    want = C.row_sum_plain(x._data)
    row_sum = {}
    for label, smem in (("smem", C.row_sum_smem(cols)),
                        ("smem_above_48k", C.row_sum_smem(cols) + (100 << 10))):
        s = mx.nd.zeros((rows,), ctx=gpu)
        k.launch([x, s, cols], gpu, (rows,), (C.ROW_SUM_THREADS,), smem)
        rel = ((s._data.double() - want).abs() / want.abs()).max().item()
        row_sum[label] = {"shared_mem": smem, "max_rel_err": rel}
        checks["row_sum_" + label] = rel <= C.ROW_SUM_RTOL
    s = mx.nd.zeros((rows,), ctx=gpu)
    row_sum["ms"] = _profiled_kernel_ms(lambda: k.launch(
        [x, s, cols], gpu, (rows,), (C.ROW_SUM_THREADS,),
        C.row_sum_smem(cols)), flush, "row_sum")
    row_sum["bound_ms"] = (rows * cols + rows) * 4 / HBM_BYTES_PER_S * 1e3
    out["row_sum"] = row_sum
    axpy = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, dtype in (("axpy_bf16", torch.bfloat16),
                        ("axpy_f32", torch.float32)):
        k = mods["bert_axpy"].get_kernel(name, C.BERT_AXPY_SIGS[name])
        xt = torch.randn(C.BERT_AXPY_SHAPE, generator=gen,
                         device="cuda").to(dtype)
        yt = torch.randn(C.BERT_AXPY_SHAPE, generator=gen,
                         device="cuda").to(dtype)
        a = torch.tensor(C.BERT_AXPY_ALPHA, dtype=dtype).item()
        want = C.axpy_plain(xt, yt, a)
        x, y = mx.nd.NDArray(xt), mx.nd.NDArray(yt.clone())
        n = x.size
        grid = (C.grid_for(n, vec=C.BERT_AXPY_VEC[name]),)
        k.launch([x, y, C.BERT_AXPY_ALPHA, n], gpu, grid, (C.THREADS,))
        err = (y._data.float() - want.float()).abs().max().item()
        checks[name] = torch.equal(_bits(y._data), _bits(want))
        bound_ms, by = bound(3 * n * _size(dtype), 2 * n, dtype)

        def run():
            k.launch([x, y, C.BERT_AXPY_ALPHA, n], gpu, grid, (C.THREADS,))

        axpy[name] = {
            "shape": list(C.BERT_AXPY_SHAPE), "dtype": _dname(dtype),
            "bit_identical": checks[name], "max_abs_err": err,
            "ms": _profiled_kernel_ms(run, flush, name),
            # events around each launch: the host's launch time included
            "event_ms": time_ms(run, flush),
            "plain_ms": time_ms(lambda: C.axpy_plain(xt, yt, a), flush),
            "library_ms": time_ms(lambda: torch.add(yt, xt, alpha=a),
                                  flush),
            "bound_ms": bound_ms, "bound_by": by, "grid": grid,
            "block": C.THREADS}
    out["bert_axpy"] = axpy
    k = mods["upstream"].get_kernel("axpy<float>", sig)
    x = mx.nd.ones(C.AXPY_SHAPE, ctx=gpu)
    y = mx.nd.zeros(C.AXPY_SHAPE, ctx=gpu)
    torch.cuda.synchronize()
    th = time.perf_counter()
    for _ in range(1000):
        k.launch([x, y, 1.0, x.size], gpu, (8,), (C.THREADS,))
    out["host_us_per_launch"] = (time.perf_counter() - th) * 1e3
    torch.cuda.synchronize()
    checks["host_launch_loop"] = bool((y.asnumpy() == 1000).all())
    bad = mods["jax_tests"].get_kernel("blocky",
                                       "const float *x, float *o, int cols")
    xb = mx.nd.ones(C.BLOCKY_SHAPE, ctx=gpu)
    ob = mx.nd.zeros(C.BLOCKY_SHAPE, ctx=gpu)
    errors = {
        "syntax": _raises_mxnet_error(lambda: mx.rtc.CudaModule(
            'extern "C" __global__ void k( { }')),
        "dtype": _raises_mxnet_error(lambda: bad.launch(
            [xb.astype("float64"), ob, 128], gpu, (4,), (128,))),
        "strided_view": _raises_mxnet_error(lambda: bad.launch(
            [xb[:, 1:3], ob, 2], gpu, (4,), (128,))),
        "block_2048": _raises_mxnet_error(lambda: bad.launch(
            [xb, ob, 128], gpu, (4,), (2048,))),
        "cpu_ndarray": _raises_mxnet_error(lambda: bad.launch(
            [mx.nd.ones(C.BLOCKY_SHAPE, ctx=mx.cpu()), ob, 128], gpu, (4,),
            (128,))),
        "cpu_launch": _raises_mxnet_error(lambda: bad.launch(
            [xb, ob, 128], mx.cpu(), (4,), (128,)))}
    checks["syntax_error_has_log"] = "error" in errors["syntax"] and \
        "NVRTC" in errors["syntax"]
    checks["no_refused_launch_ran"] = bad.launches == 0
    out["errors"] = {k: v[:200] for k, v in errors.items()}
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(checks.values()):
        fail(f"mx.rtc checks failed: {checks}")
    return out


def _route_ms(fn, reset, sleep_cycles=int(2e8)) -> tuple:
    """(device ms, host ms) of ``fn``; ``reset()`` restores its inputs
    before each of two runs. The first gives the host ms ``fn`` takes to
    queue its work (no synchronise inside) and warms the allocator; the
    second is queued behind a sleep kernel of ``sleep_cycles`` (~0.1 s),
    so the events around it time the device's work back to back, not
    the host's queueing (torch.profiler drops device events in a long
    process, so it does not sum a route)."""
    reset()
    torch.cuda.synchronize()
    th = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - th) * 1e3
    torch.cuda.synchronize()
    reset()
    pre, start, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    torch.cuda.synchronize()
    pre.record()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    tq = time.perf_counter()
    fn()
    queue_ms = (time.perf_counter() - tq) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queue_ms >= pre.elapsed_time(start):
        fail(f"the host took {queue_ms} ms to queue the work, longer than "
             f"the sleep before it ({pre.elapsed_time(start)} ms)")
    return start.elapsed_time(end), host_ms


def _queued_ms(fn, flush, iters=20, warmup=3,
               sleep_cycles=int(2e8)) -> float:
    """Median device ms of ``fn`` over ``iters`` calls, each after an L2
    flush and bracketed by CUDA events, all queued behind a sleep kernel
    of ``sleep_cycles`` (~0.1 s). The card reaches each event pair only
    after the host has queued every call, so a pair times the device's
    work and not the host's launch (time_ms's pairs time an mx.rtc
    launch's Python checks too, which outlast the flush before them)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    pre, go = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    pre.record()
    torch.cuda._sleep(sleep_cycles)
    go.record()
    tq = time.perf_counter()
    for s, e in zip(starts, ends):
        flush()
        s.record()
        fn()
        e.record()
    queue_ms = (time.perf_counter() - tq) * 1e3
    torch.cuda.synchronize()
    if queue_ms >= pre.elapsed_time(go):
        fail(f"the host took {queue_ms} ms to queue the calls, longer than "
             f"the sleep before them ({pre.elapsed_time(go)} ms)")
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_launch_counts() -> dict:
    """Kernels per call of the norm wrappers at the main paths' shapes,
    bf16, counted in a CUDA graph capture of one call: exactly one each
    (the memset that zeroes the backward's arrival counter is not a
    kernel)."""
    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_rms_norm, fused_rms_norm_bwd)
    from mxnet_tpu_torch.kernels._build import kernels_per_call
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    x, r, dy = randn(32 * 512, 768) + 2, randn(32 * 512, 768), \
        randn(32 * 512, 768)
    g, b = randn(768) * 0.1 + 1, randn(768) * 0.1
    x2, dy2, w2 = randn(8 * 2048, 2048), randn(8 * 2048, 2048), \
        randn(2048) * 0.1 + 1
    x3, w3 = randn(8, 4096), randn(4096) * 0.1 + 1
    _, rstd2 = _rms_norm_fwd(x2, w2, 1e-5, True)
    calls = {"fused_rms_norm": lambda: fused_rms_norm(x3, w3, eps=1e-5),
             "fused_rms_norm[16384x2048,rstd]":
                 lambda: _rms_norm_fwd(x2, w2, 1e-5, True),
             "fused_rms_norm_bwd":
                 lambda: fused_rms_norm_bwd(x2, w2, rstd2, dy2)}
    for name, res, p, seed in (
            ("fused_layer_norm_bwd", r, 0.0, None),
            ("fused_layer_norm_bwd[no residual]", None, 0.0, None),
            ("fused_layer_norm_bwd[dropout]", r, DROP_P, 0xD0D1),
            ("fused_layer_norm_bwd[dropout, no residual]", None, DROP_P,
             0xD0D0)):
        _, mean, rstd = fused_layer_norm(x, g, b, res, dropout=p, seed=seed,
                                         return_stats=True)
        calls[name] = (lambda res=res, p=p, seed=seed, mean=mean,
                       rstd=rstd: fused_layer_norm_bwd(x, g, mean, rstd, dy,
                                                       res, p, seed))
    for fn in calls.values():
        fn()
    counts = {name: kernels_per_call(fn) for name, fn in calls.items()}
    emit({"phase": "launch_counts", "kernels_per_call": counts})
    if any(n != 1 for n in counts.values()):
        fail(f"a norm wrapper launched other than one kernel: {counts}")
    return counts


IMPERATIVE_LR = 1e-3


def phase_imperative(card: str) -> dict:
    """The slice's path at full width: BERTForPretrainFused at
    bert_12_768_12, bf16, seeded random weights, at 0.1 / 0.1, one eager
    step's gradients (record(), autograd.backward; the kernels' launches
    exactly the model's per step), each of the 153 reached parameters
    and its gradient wrapped as an NDArray with no copy; mx.nd.save of
    the parameter dict (109.5M bf16 elements) and mx.nd.load onto gpu(0),
    bit-identical, seconds and MB/s each way; then a manual SGD update
    at lr 1e-3 (bf16) by two routes from the same weights: the NDArray
    ops w -= lr * g, and a user's CudaModule kernel (sgd_bf16,
    --fmad=false) launched on the same NDArrays once per parameter. The
    two must agree bit for bit and the kernel route launch exactly once
    per parameter; each route's device ms (queued behind a sleep kernel,
    so the host's queueing is not timed), host ms and launches, beside
    the byte bound (6 B per element) and torch._foreach_add_ over the
    same lists as the library call; then the user kernel alone on the
    largest parameter (the word embedding, 30522 x 768): its device ms,
    its plain version's and torch.sub's (cold L2, events queued behind a
    sleep kernel), its byte bound and its error against the plain
    version."""
    import gc
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    C = _rtc_cases()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpu = mx.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = BERTForPretrainFused(dropout=0.1, attn_dropout=0.1, ctx=gpu,
                               dtype=torch.bfloat16, generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"]) != (12, 768, 3072, 12,
                                                     30522):
        fail(f"not BERT-base at full width and depth: {cfg}")
    mx.random.seed(SEED)
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    _reset_train_counts()
    with mx.autograd.record():
        loss = net(tok, lab)
    reached = {id(t) for t in mx.autograd._leaves([loss])}
    mx.autograd.backward(loss)
    torch.cuda.synchronize()
    step_launches = _train_counts()
    step_want = _per_step(cfg, 0, 0.1, 0.1, wgmma=True)
    loss = float(loss.detach().float().mean())
    weights, grads = {}, {}
    for name, p in net.collect_params().items():
        if id(p._var) in reached:
            weights[name] = mx.nd.NDArray(p.data()._data)
            grads[name] = mx.nd.NDArray(p.grad()._data)
    n_elem = sum(w.size for w in weights.values())
    no_copy = all(weights[k]._data.data_ptr() == p.tensor.data_ptr()
                  for k, p in net.collect_params().items() if k in weights)
    out = {"phase": "imperative", "card": card,
           "model": "BERTForPretrainFused (bert_12_768_12), bf16",
           "batch": [32, 512], "loss": loss, "params": len(weights),
           "elements": n_elem, "wrapped_without_copy": no_copy,
           "step_launches": step_launches,
           "step_launches_expected": step_want}
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "bert_12_768_12.params")
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mx.nd.save(fname, weights)
        save_s = time.perf_counter() - ts
        size = os.path.getsize(fname)
        tl = time.perf_counter()
        back = mx.nd.load(fname, ctx=gpu)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - tl
    round_trip = list(back) == list(weights) and all(
        back[k].context == gpu and back[k].dtype == weights[k].dtype and
        torch.equal(_bits(back[k]._data), _bits(weights[k]._data))
        for k in weights)
    del back
    out["params_file"] = {"bytes": size, "save_s": save_s,
                          "save_mb_s": size / save_s / 1e6,
                          "load_s": load_s, "load_mb_s": size / load_s / 1e6,
                          "bit_identical": round_trip}
    names = list(weights)
    w0 = {k: weights[k]._data.clone() for k in names}
    wa = {k: mx.nd.NDArray(w0[k].clone()) for k in names}
    wb = {k: mx.nd.NDArray(w0[k].clone()) for k in names}
    mod = mx.rtc.CudaModule(C.SGD_SRC, options=C.FMAD_OFF)
    kern = mod.get_kernel("sgd_bf16", C.SGD_SIG)
    # compile, load and warm both routes on a throwaway copy of one member
    first = names[0]
    scratch = mx.nd.NDArray(w0[first].clone())
    scratch -= IMPERATIVE_LR * grads[first]
    kern.launch([scratch, grads[first], IMPERATIVE_LR, scratch.size], gpu,
                (C.grid_for(scratch.size, vec=C.SGD_VEC),), (C.THREADS,))

    def ops_route():
        for k in names:
            wa[k] -= IMPERATIVE_LR * grads[k]

    def kernel_route():
        for k in names:
            w = wb[k]
            kern.launch([w, grads[k], IMPERATIVE_LR, w.size], gpu,
                        (C.grid_for(w.size, vec=C.SGD_VEC),), (C.THREADS,))

    def restore(ws):
        def reset():
            for k in names:
                ws[k]._data.copy_(w0[k])
        return reset

    dev_a, host_a = _route_ms(ops_route, restore(wa))
    # the main path's launches: counted from 0 over the route's first
    # (unprofiled) run
    counted = []

    def counted_kernel_route():
        kernel_route()
        counted.append(kern.launches)

    kern.launches = 0
    dev_b, host_b = _route_ms(counted_kernel_route, restore(wb))
    sgd_launches = counted[0]
    identical = all(torch.equal(_bits(wa[k]._data), _bits(wb[k]._data))
                    for k in names)
    plain = all(torch.equal(_bits(wa[k]._data), _bits(C.sgd_plain(
        w0[k], grads[k]._data, IMPERATIVE_LR))) for k in names[:8])
    moved = sum(int((wb[k]._data != w0[k]).sum()) for k in names)
    lib_w = [w0[k].clone() for k in names]
    lib_g = [grads[k]._data for k in names]
    lr_bf16 = torch.tensor(IMPERATIVE_LR, dtype=torch.bfloat16).item()
    dev_lib, host_lib = _route_ms(
        lambda: torch._foreach_add_(lib_w, lib_g, alpha=-lr_bf16),
        lambda: [w.copy_(w0[k]) for w, k in zip(lib_w, names)])
    bound_ms, by = bound(6 * n_elem, 2 * n_elem, torch.bfloat16)
    # the kernel alone at the path's largest launch
    big = max(names, key=lambda k: w0[k].numel())
    wt, gt, nb = wb[big], grads[big], w0[big].numel()
    grid = (C.grid_for(nb, vec=C.SGD_VEC),)
    want = C.sgd_plain(w0[big], gt._data, IMPERATIVE_LR)
    wt._data.copy_(w0[big])
    kern.launch([wt, gt, IMPERATIVE_LR, nb], gpu, grid, (C.THREADS,))
    big_err = (wt._data.float() - want.float()).abs().max().item()
    big_identical = torch.equal(_bits(wt._data), _bits(want))
    flush = _L2Flush()
    big_bound, big_by = bound(6 * nb, 2 * nb, torch.bfloat16)
    kernel = {
        "param": big, "shape": list(w0[big].shape), "dtype": "bfloat16",
        "bit_identical": big_identical, "max_abs_err": big_err,
        "ms": _queued_ms(lambda: kern.launch(
            [wt, gt, IMPERATIVE_LR, nb], gpu, grid, (C.THREADS,)), flush),
        "plain_ms": _queued_ms(lambda: C.sgd_plain(
            w0[big], gt._data, IMPERATIVE_LR), flush),
        "library_ms": _queued_ms(lambda: torch.sub(
            w0[big], gt._data, alpha=lr_bf16), flush),
        "bound_ms": big_bound, "bound_by": big_by, "grid": grid,
        "block": C.THREADS}
    out["sgd"] = {
        "lr": IMPERATIVE_LR, "bit_identical": identical,
        "ndarray_ops_equal_plain": plain, "elements_moved": moved,
        "ndarray_ops": {"device_ms": dev_a, "host_ms": host_a,
                        "launches": 3 * len(names)},
        "user_kernel": {"device_ms": dev_b, "host_ms": host_b,
                        "launches": sgd_launches,
                        "host_us_per_launch": host_b * 1e3 / len(names)},
        "library_foreach_add": {"device_ms": dev_lib, "host_ms": host_lib},
        "bound_ms": bound_ms, "bound_by": by,
        "compile_ms": mod.compile_ms, "image_source": mod.image_source,
        "kernel": kernel}
    if mod.image_source != "nvrtc":
        fail(f"imperative: the SGD module's image came from "
             f"{mod.image_source}, not NVRTC")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if step_launches != step_want:
        fail(f"the eager step's launches {step_launches} are not "
             f"{step_want}")
    if len(weights) != 153 or not no_copy or not round_trip:
        fail(f"imperative .params round trip failed: {len(weights)} params, "
             f"no copy {no_copy}, bit-identical {round_trip}")
    if not (identical and plain and big_identical and
            sgd_launches == len(names) and moved):
        fail(f"the two SGD routes disagree or the kernel route did not "
             f"launch once per parameter: {out['sgd']}")
    del net, weights, grads, w0, wa, wb, lib_w
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 16-17. data-parallel comms: the kvstore, overlap, 2-bit compression, ZeRO
# ---------------------------------------------------------------------------

DP_OPT = {"learning_rate": 1e-4}


def _dp_step(net, trainer, tok, lab, halves=1, times=None):
    """One eager step as a user writes it, over ``halves`` equal slices of
    the batch, each its own forward under one record() (the CPU copy's
    two contexts see the same slices, so both draw the same dropout
    masks); one backward of every slice's loss, Trainer.step over all
    positions. Returns the slices' mean losses (on the device)."""
    import mxnet_tpu_torch as mx

    n = tok.shape[0] // halves
    t0 = time.perf_counter()
    with mx.autograd.record():
        losses = [net(tok[i * n:(i + 1) * n], lab[i * n:(i + 1) * n])
                  for i in range(halves)]
    t1 = time.perf_counter()
    mx.autograd.backward(losses)
    t2 = time.perf_counter()
    trainer.step(sum(int(l.numel()) for l in losses))
    if times is not None:
        times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return [l.detach().float().mean() for l in losses]


def _sd_bits(net) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def phase_dp_reference() -> None:
    """BERTForPretrainFused at BERT-base widths, depth cut to 2 layers,
    f32 (TF32 off), dropout 0.1 / 0.1, Adam lr 1e-4 (multi-precision off:
    f32 weights), the eager Gluon path over a (4, 128) batch fed as two
    (2, 128) slices, three steps each way. On the card, each held bit for
    bit against Trainer(kvstore=None) (losses and every weight):
    Trainer(kvstore='nccl') (one worker, one copy: the buckets packed and
    unpacked only), the same with overlap_comms on, and partition='zero1'
    (world 1: the sharded sweep over one shard). Against the CPU with
    two contexts cpu(0) and cpu(1), one slice each, kvstore 'device'
    (split_and_load's layout): each loss within 1e-5 relative, each
    parameter's delta within 1e-3 of its norm (the key third of each
    QKV bias, whose true gradient is 0, moving less than lr per step),
    as phases 10 and 12 hold theirs. Last, a one-rank NCCL group runs
    comm.py's reduce_scatter, allreduce and all_gather over the card's
    gradient buckets: the bits come back unchanged."""
    import copy

    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused
    from mxnet_tpu_torch.kvstore import bucketing, comm

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, lr = 3, DP_OPT["learning_rate"]
    base = BERTForPretrainFused(
        num_layers=2, dropout=0.1, attn_dropout=0.1, ctx=mx.cpu(),
        generator=torch.Generator().manual_seed(SEED + 7))
    units = base.config["units"]
    w0 = _sd_bits(base)
    rs = np.random.RandomState(SEED + 7)
    tok = torch.from_numpy(rs.randint(0, 30000, (4, 128)).astype(np.int32))
    lab = torch.from_numpy(rs.randint(0, 30000, (4, 128)).astype(np.int32))

    def card_run(**kw):
        """Three steps; also the Adam sweep's launches in them and the
        optimizer's dispatches by path (telemetry)."""
        net = copy.deepcopy(base).cuda()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   dict(DP_OPT), **kw)
        mx.random.seed(SEED + 7, ctx=torch.device("cuda"))
        _reset_train_counts()
        mx.telemetry.reset()
        mx.telemetry.enable()
        try:
            losses = [[float(x) for x in _dp_step(net, trainer, tok.cuda(),
                                                  lab.cuda(), halves=2)]
                      for _ in range(steps)]
            snap = mx.telemetry.snapshot()["metrics"]
        finally:
            mx.telemetry.disable()
            mx.telemetry.reset()
        dispatch = {s["labels"]["path"]: s["value"] for s in snap.get(
            "mxnet_optimizer_dispatch_total", {"samples": []})["samples"]}
        return net, trainer, losses, {
            "adam_sweeps": _train_counts()["fused_adam_sweep"],
            "optimizer_dispatch": dispatch}

    ref_net, _, ref_losses, _ = card_run(kvstore=None)
    ref_w = _sd_bits(ref_net)
    checks = {}
    for name, kw in (("nccl", {"kvstore": "nccl"}),
                     ("nccl_overlap", {"kvstore": "nccl",
                                       "overlap_comms": True}),
                     ("zero1_world1", {"kvstore": "nccl",
                                       "partition": "zero1"})):
        net, trainer, losses, counts = card_run(**kw)
        w = _sd_bits(net)
        checks[name] = {
            "losses_equal": losses == ref_losses,
            "weights_bit_identical": all(torch.equal(w[k], ref_w[k])
                                         for k in ref_w),
            "overlap_stats": trainer.last_overlap_stats,
            "partition": trainer.partition, **counts}
        if trainer._zero is not None:
            # the sharded sweep ran for every trainable parameter: none
            # fell back, and each step's sweeps were the engine's, one
            # per ZeRO bucket (no Trainer sweep dispatched)
            zero = trainer._zero
            trainable = [i for i, p in enumerate(trainer._params)
                         if p.grad_req != "null"]
            checks[name].update(
                fallback=dict(zero.fallback_reasons),
                eligible_all=zero.eligible_indices() == trainable,
                zero_buckets=len(zero._buckets))
        del net, trainer
    # the CPU copy on two contexts, one slice each
    cpu_net = copy.deepcopy(base)
    ctxs = [mx.cpu(0), mx.cpu(1)]
    cpu_net.collect_params().reset_ctx(ctxs)
    trainer = mx.gluon.Trainer(cpu_net.collect_params(), "adam",
                               dict(DP_OPT), kvstore="device")
    mx.random.seed(SEED + 7, ctx=torch.device("cpu"))
    cpu_losses = []
    for _ in range(steps):
        toks = mx.gluon.utils.split_and_load(tok.numpy(), ctxs)
        labs = mx.gluon.utils.split_and_load(lab.numpy(), ctxs)
        with mx.autograd.record():
            ls = [cpu_net(a.astype("int32"), b.astype("int32"))
                  for a, b in zip(toks, labs)]
        mx.autograd.backward(ls)
        trainer.step(sum(int(np.prod(l.shape)) for l in ls))
        cpu_losses.append([float(l.asnumpy().mean()) for l in ls])
    copies_equal = all(
        torch.equal(p.list_data()[0]._data, p.list_data()[1]._data)
        for p in cpu_net.collect_params().values())
    cpu_sd = cpu_net.state_dict()
    ratios, key_bias = {}, []
    for key, start in w0.items():
        dc = (cpu_sd[key] - start).flatten()
        dg = (ref_w[key].cpu() - start).flatten()
        if key.endswith("qkv_proj.bias"):
            k_part = torch.arange(units, 2 * units)
            key_bias.append(max(float(dc[k_part].abs().max()),
                                float(dg[k_part].abs().max())))
            keep = torch.ones_like(dc, dtype=torch.bool)
            keep[k_part] = False
            dc, dg = dc[keep], dg[keep]
        norm = float(dc.norm())
        if norm > 0:
            ratios[key] = float((dg - dc).norm()) / norm
        elif float(dg.norm()) != 0.0:
            ratios[key] = float("inf")
    loss_rel = max(abs(a - b) / abs(b) for ra, rb in zip(ref_losses,
                                                         cpu_losses)
                   for a, b in zip(ra, rb))
    worst = max(ratios, key=ratios.get)
    # one-rank NCCL: comm.py's primitives over the card's gradient buckets
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        grads = [p.grad for p in ref_net.parameters() if p.grad is not None]
        flat = bucketing.pack(grads)
        rs_out = comm.reduce_scatter(flat)
        ar_out = comm.allreduce(flat)
        ag_out = comm.all_gather(rs_out, flat.numel())
        torch.cuda.synchronize()
        nccl = {"elements": flat.numel(), "world": comm.world(),
                "reduce_scatter_same_bits": torch.equal(rs_out, flat),
                "allreduce_same_bits": torch.equal(ar_out, flat),
                "all_gather_same_bits": torch.equal(ag_out, flat),
                "backend": dist.get_backend()}
    finally:
        dist.destroy_process_group()
    out = {"phase": "dp_reference",
           "model": "BERTForPretrainFused(num_layers=2)", "dtype": "float32",
           "entry_points": "gluon.Trainer(kvstore=None|'nccl'|'device', "
                           "overlap_comms, partition='zero1'), "
                           "autograd.record, autograd.backward, "
                           "gluon.utils.split_and_load",
           "dropout": 0.1, "attn_dropout": 0.1, "batch": [4, 128],
           "slices": 2, "steps": steps, "optimizer": ["adam", DP_OPT],
           "card_losses": ref_losses, "card_checks": checks,
           "cpu_two_contexts": {"losses": cpu_losses,
                                "loss_max_rel_diff": loss_rel,
                                "loss_tol": 1e-5,
                                "delta_worst": [worst, ratios[worst]],
                                "delta_median": float(np.median(
                                    list(ratios.values()))),
                                "delta_tol": 1e-3,
                                "key_bias_max_abs_delta": max(key_bias),
                                "key_bias_tol": steps * lr,
                                "copies_bit_identical": copies_equal},
           "nccl_one_rank": nccl, "seconds": time.perf_counter() - t0}
    emit(out)
    for name, c in checks.items():
        if not (c["losses_equal"] and c["weights_bit_identical"]):
            fail(f"dp_reference: {name} is not bit for bit with "
                 f"kvstore=None: {c}")
    if not checks["nccl_overlap"]["overlap_stats"] or \
            checks["nccl_overlap"]["overlap_stats"][
                "dispatched_in_backward"] < 1:
        fail(f"dp_reference: overlap_comms exchanged nothing inside the "
             f"backward: {checks['nccl_overlap']}")
    z = checks["zero1_world1"]
    if z["partition"] != "zero1" or z["fallback"] or not z["eligible_all"] \
            or z["adam_sweeps"] != steps * z["zero_buckets"] \
            or z["optimizer_dispatch"] != {
                "zero_sweep": steps * z["zero_buckets"]}:
        fail(f"dp_reference: partition='zero1' did not run the sharded "
             f"sweep over every trainable parameter: {z}")
    if not all(np.isfinite(sum(ref_losses, []))) or loss_rel > 1e-5:
        fail(f"dp_reference: card losses {ref_losses} disagree with the "
             f"two CPU contexts' {cpu_losses}")
    if ratios[worst] > 1e-3 or max(key_bias) > steps * lr \
            or not copies_equal:
        fail(f"dp_reference: deltas disagree with the CPU's: {worst} "
             f"{ratios[worst]}, key bias {max(key_bias)}, copies equal "
             f"{copies_equal}")
    if not all(v for k, v in nccl.items() if k.endswith("same_bits")):
        fail(f"dp_reference: a one-rank NCCL primitive changed the bits: "
             f"{nccl}")
    del ref_net, cpu_net, base
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


DP_TRAIN_OPT = {"learning_rate": 1e-4, "multi_precision": True}
DP_CONFIGS = (
    ("nccl_overlap", {"kvstore": "nccl", "overlap_comms": True}),
    ("no_store", {"kvstore": None}),
    ("nccl_overlap_2", {"kvstore": "nccl", "overlap_comms": True}),
    ("no_store_2", {"kvstore": None}),
    ("nccl_2bit", {"kvstore": "nccl", "overlap_comms": True,
                   "compression_params": {"type": "2bit",
                                          "threshold": 0.5}}),
    ("nccl_zero1", {"kvstore": "nccl", "partition": "zero1"}))


def _dp_train_one(name, kw, tok, lab, timed_steps) -> dict:
    import gc
    import warnings

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused
    from mxnet_tpu_torch.kvstore import bucketing

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = BERTForPretrainFused(dropout=0.1, attn_dropout=0.1, ctx="cuda",
                               dtype=torch.bfloat16, generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"], cfg["max_length"]) != (
                12, 768, 3072, 12, 30522, 512):
        fail(f"dp_train: not BERT-base at full width and depth: {cfg}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   dict(DP_TRAIN_OPT), **kw)
        mx.random.seed(SEED)
        warm = [float(_dp_step(net, trainer, tok, lab)[0])
                for _ in range(3)]
    store = trainer._kvstore
    kv_buckets = len(store.plan_pushpull(*trainer._grad_exchange_args())) \
        if store is not None else 0
    kv_bytes = sum(g._data.numel() * g._data.element_size()
                   for gs in trainer._grad_exchange_args()[1] for g in gs) \
        if store is not None else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, times = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(_dp_step(net, trainer, tok, lab, times=times)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    buckets = _trainer_buckets(trainer)
    per_step = _per_step(cfg, buckets, 0.1, 0.1, wgmma=True)
    if "compression_params" in kw:
        per_step["twobit_quantize"] = kv_buckets
    want = {k: v * timed_steps for k, v in per_step.items()}
    host = np.asarray(times) * 1e3

    losses = warm + [float(x) for x in timed]
    rec = {"config": name, "trainer_kwargs": {k: v for k, v in kw.items()},
           "ms_per_step": wall * 1e3 / timed_steps,
           "samples_per_s": 32 * timed_steps / wall,
           "peak_mem_gib": peak,
           "host_ms_forward": float(np.median(host[:, 0])),
           "host_ms_backward": float(np.median(host[:, 1])),
           "host_ms_trainer_step": float(np.median(host[:, 2])),
           "kv_buckets_per_step": kv_buckets,
           "kv_bucket_bytes_per_step": kv_bytes,
           "last_overlap_stats": trainer.last_overlap_stats,
           "partition": trainer.partition,
           "zero_fallback": (None if trainer._zero is None else
                             dict(collections.Counter(
                                 trainer._zero.fallback_reasons.values()))),
           "warnings": sorted({str(w.message)[:120] for w in caught}),
           "losses": losses, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           "dtype_buckets": buckets}
    del trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_dp_train() -> dict:
    """BERTForPretrainFused(bert_12_768_12), not cut (12 layers, 768
    units, 3072 FFN, 12 heads, vocab 30522), bf16 with seeded random
    weights, multi-precision Adam lr 1e-4, dropout 0.1 / 0.1, one (32,
    512) batch of RandomState(0) tokens and labels, on the eager Gluon
    path: Trainer(kvstore='nccl', overlap_comms=True) in turns with
    kvstore=None (twice each, so the two are read on one card in one
    process), then with compression_params={'type': '2bit', 'threshold':
    0.5}, then partition='zero1' (BERT-base's bf16 members with f32
    masters fall outside the sharded sweep, as in the reference, and
    update replicated); 3 warm-up and 20 timed steps each. Reports ms per
    step, samples/s, peak memory, host ms of the forward, backward and
    Trainer.step, the kvstore's buckets, bytes and collectives per step,
    last_overlap_stats, and the launches: exactly the model's per step,
    one Adam sweep per dtype bucket, and exactly one twobit_quantize per
    gradient bucket per step with compression and none without. Every
    loss must be finite, and the last timed loss below the first warm-up
    loss."""
    t0 = time.perf_counter()
    timed_steps = 20
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    runs = [_dp_train_one(name, kw, tok, lab, timed_steps)
            for name, kw in DP_CONFIGS]
    by = {r["config"]: r for r in runs}
    out = {"phase": "dp_train", "model": "BERTForPretrainFused "
           "(bert_12_768_12)", "dtype": "bfloat16, multi-precision adam",
           "optimizer": DP_TRAIN_OPT, "dropout": 0.1, "attn_dropout": 0.1,
           "batch": [32, 512], "steps": timed_steps, "warmup": 3,
           "runs": runs,
           "overlap_vs_no_store_ms": [
               by["nccl_overlap"]["ms_per_step"] - by["no_store"]["ms_per_step"],
               by["nccl_overlap_2"]["ms_per_step"]
               - by["no_store_2"]["ms_per_step"]],
           "seconds": time.perf_counter() - t0}
    emit(out)
    for r in runs:
        losses = r["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"dp_train {r['config']}: loss not finite or not falling: "
                 f"{losses}")
        if r["launches"] != r["launches_expected"]:
            fail(f"dp_train {r['config']}: launch counts {r['launches']} "
                 f"are not {r['launches_expected']}")
        if r["trainer_kwargs"].get("overlap_comms") and \
                r["last_overlap_stats"]["dispatched_in_backward"] < 1:
            fail(f"dp_train {r['config']}: overlap exchanged nothing inside "
                 f"the backward: {r['last_overlap_stats']}")
    return {"twobit_quantize": by["nccl_2bit"]["launches"]["twobit_quantize"],
            "fused_adam_sweep": by["nccl_overlap"]["launches"][
                "fused_adam_sweep"],
            "ms_per_step": {k: v["ms_per_step"] for k, v in by.items()}}


# ---------------------------------------------------------------------------
# 17c-17e. training fed from files: record files, mx.io with the device
# feed, gluon.data with metric and callback
# ---------------------------------------------------------------------------

IMAGENET_MEAN_STD = ([123.68, 116.78, 103.94], [58.4, 57.1, 57.4])


class _StepSpy:
    """A ``TrainStep`` seen through: each call's batch kept (a device
    clone, no sync) and everything else passed on."""

    def __init__(self, step):
        self._step = step
        self.batches = []

    def __call__(self, data, label):
        self.batches.append(tuple(t.clone() for t in data))
        return self._step(data, label)

    def __getattr__(self, name):
        return getattr(self._step, name)


def phase_data_llama(card: str) -> dict:
    """The proxy1b Llama (700.5M parameters, full depth and width,
    --no-remat as phase 13) through the driver's own main() with --data
    <tmp>/tokens.rec --save-dir <tmp>/ckpt --steps 4 --save-every 4, the
    record file written here with mx.recordio: 32 records of 2049
    RandomState(0) int32 ids, the first 8 the rows _make_data("synthetic")
    draws. Checks: the first step's loss equals the synthetic path's
    first loss from the same seed-0 weights bit for bit; every step's
    batch is its 8 records' ids (tokens arr[:2048], labels arr[1:]);
    exactly 21/21 RMSNorm, 10/10 flash, one AdamW scan and one sweep per
    step; the .params reloads into a fresh build("proxy1b") net bit for
    bit; the .states leaves equal the step's states byte for byte.
    Prints the bytes written, the save's MB/s and the synced span's
    tokens/s. <tmp> (about 10 GB) is removed at the end."""
    import contextlib
    import gc
    import io
    import os
    import pickle
    import shutil
    import tempfile

    from mxnet_tpu_torch.recordio import MXRecordIO
    from mxnet_tpu_torch.tools import pretrain_llama as pl

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, seq, steps = 8, 2048, 4
    cfg = pl.CONFIGS["proxy1b"]
    dev = torch.device("cuda")
    toks = np.random.RandomState(0).randint(
        0, cfg["vocab_size"], (32, seq + 1)).astype(np.int32)
    synth = np.random.RandomState(0).randint(0, cfg["vocab_size"],
                                             (batch, seq + 1))
    if not np.array_equal(toks[:batch], synth):
        fail("data_llama: the records' first rows are not the synthetic "
             "batch")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_llama_")
    try:
        rec = os.path.join(tmp, "tokens.rec")
        w = MXRecordIO(rec, "w")
        for row in toks:
            w.write(row.tobytes())
        w.close()
        # the synthetic path's first loss, from the same seed-0 weights
        net, step = pl.build("proxy1b", ctx="cuda", remat=False)
        tok, lab = next(pl._make_data("synthetic", batch, seq,
                                      cfg["vocab_size"], dev))
        synth_loss = float(step((tok, lab), ())[0])
        del net, step, tok, lab
        gc.collect()
        torch.cuda.empty_cache()

        built, saves = [], []
        build, save = pl.build, pl._save

        def spy_build(*a, **kw):
            net, step = build(*a, **kw)
            built.append((net, _StepSpy(step)))
            return built[-1]

        def timed_save(*a, **kw):
            t = time.perf_counter()
            paths = save(*a, **kw)
            saves.append((time.perf_counter() - t, paths))
            return paths

        ckpt = os.path.join(tmp, "ckpt")
        out = io.StringIO()
        pl.build, pl._save = spy_build, timed_save
        _reset_train_counts()
        try:
            with contextlib.redirect_stdout(out):
                rc = pl.main(["--config", "proxy1b", "--no-remat",
                              "--batch", str(batch), "--seq", str(seq),
                              "--steps", str(steps), "--data", rec,
                              "--save-dir", ckpt, "--save-every", "4"])
        finally:
            pl.build, pl._save = build, save
        launches = _train_counts()
        lines = out.getvalue().strip().splitlines()
        run = json.loads(lines[-1])
        net, spy = built[0]
        per_step = _llama_per_step(cfg, len(spy._buckets), wgmma=True)
        want = {k: v * steps for k, v in per_step.items()}
        batches_ok = all(
            np.array_equal(tk.cpu().numpy(), toks[8 * k:8 * k + 8, :seq])
            and np.array_equal(lb.cpu().numpy(),
                               toks[8 * k:8 * k + 8, 1:])
            for k, (tk, lb) in enumerate(spy.batches))
        save_s, paths = saves[0]
        nbytes = sum(os.path.getsize(p) for p in paths)
        # the .params into a fresh seed-0 net, bit for bit
        fresh, _ = build("proxy1b", ctx="cuda", remat=False)
        fresh.load_parameters(paths[0])
        params_equal = all(
            torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                              net.parameters()))
        del fresh
        # the .states leaves against the step's states, byte for byte
        with open(paths[1], "rb") as f:
            saved = pickle.load(f)
        leaves = [leaf for st in spy._states for leaf in
                  pl._state_leaves(st)]
        states_equal = (len(leaves) == len(saved["leaves"]) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes()
            for a, b in zip(leaves, saved["leaves"])))
        del leaves, saved
        rec_out = {
            "phase": "data_llama", "card": card,
            "model": "LlamaModel(fused_ce=True), proxy1b, no remat",
            "driver": "mxnet_tpu_torch.tools.pretrain_llama.main",
            "records": [int(toks.shape[0]), seq + 1], "rc": rc,
            "batch": [batch, seq], "steps": steps,
            "losses": run["losses"], "synthetic_first_loss": synth_loss,
            "first_loss_bits_equal": run["losses"][0] == synth_loss,
            "batches_are_the_records": batches_ok,
            "tokens_per_s_synced_span": run["tokens_per_sec"],
            "mfu": run["mfu"], "save_s": save_s, "bytes_written": nbytes,
            "save_mb_per_s": nbytes / save_s / 1e6,
            "params_reload_bit_equal": params_equal,
            "states_byte_equal": states_equal,
            "num_update": spy.optimizer.num_update,
            "launches": launches, "launches_expected": want,
            "saved_lines": [s for s in lines if s.startswith("saved ")]}
        del built, net, spy
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rec_out["tmp_removed"] = not os.path.exists(tmp)
    rec_out["seconds"] = time.perf_counter() - t0
    emit(rec_out)
    losses = rec_out["losses"]
    if rc != 0 or len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"data_llama: the driver's run failed: rc {rc}, {losses}")
    if not rec_out["first_loss_bits_equal"]:
        fail(f"data_llama: the first loss from records {losses[0]!r} is "
             f"not the synthetic path's {synth_loss!r}")
    if not batches_ok or len(rec_out["saved_lines"]) != 1:
        fail(f"data_llama: batches from the records {batches_ok}, saved "
             f"lines {rec_out['saved_lines']}")
    if launches != want:
        fail(f"data_llama launch counts {launches} are not {want}")
    if not (params_equal and states_equal and rec_out["tmp_removed"]):
        fail(f"data_llama: params reload {params_equal}, states "
             f"{states_equal}, tmp removed {rec_out['tmp_removed']}")
    return launches


def _learnable_images(n, classes, seed):
    """uint8 NCHW images, each its class's fixed random prototype plus
    noise (as the vision datasets' surrogate), and float labels."""
    rs = np.random.RandomState(seed)
    protos = rs.randint(0, 256, (classes, 3, 224, 224)).astype(np.int16)
    labels = rs.randint(0, classes, (n,))
    noise = rs.randint(-48, 49, (n, 3, 224, 224)).astype(np.int16)
    imgs = np.clip(protos[labels] * 0.6 + noise, 0, 255).astype(np.uint8)
    return imgs, labels.astype(np.float32)


def phase_data_resnet(card: str) -> dict:
    """resnet50_v1(layout="NHWC") at phase 15's cell (bf16, 256 x 224,
    SGD lr 0.1, momentum 0.9, multi-precision, cuDNN autotuner on), fed
    as examples/train_resnet_imagenet.py feeds it: an mx.io.NDArrayIter
    over 4 batches of seeded uint8 NCHW images (8 classes' prototypes
    plus noise) → DeviceFeedIter(step=step, depth=2, device_transform=
    make_normalize_transform(ImageNet mean/std, "bfloat16")), two passes
    after two warm-up steps on the staged batch.
    Checks: each staged batch equals the CPU transform of its source bit
    for bit; the loss finite and lower at the last step than the first;
    exactly 2 SGD sweeps a step. In turns with the same steps on a staged
    synthetic batch (feed, staged, feed, staged): images/s of each and
    the data wait per step (the time next() blocks)."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, nb = 256, 4
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    net = resnet50_v1(layout="NHWC", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 optimizer_params=dict(RESNET_OPT))
    imgs, labels = _learnable_images(batch * nb, 8, 1)
    tf = mx.io.make_normalize_transform(*IMAGENET_MEAN_STD, "bfloat16")
    src = mx.io.NDArrayIter(imgs, labels, batch_size=batch)
    feed = mx.io.DeviceFeedIter(src, step=step, depth=2,
                                device_transform=tf)
    x_syn = tf(torch.from_numpy(imgs[:batch]).cuda())[0]
    y_syn = torch.from_numpy(labels[:batch]).cuda()
    for _ in range(2):              # cuDNN's autotuner, out of the turns
        step(x_syn, y_syn)
    losses, staged, waits = [], [], []
    feed_s, syn_s = [], []
    _reset_train_counts()
    n_steps = 0
    for turn in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if turn % 2 == 0:                       # the feed: one pass
            feed.reset()
            while True:
                tw = time.perf_counter()
                try:
                    b = feed.next()
                except StopIteration:
                    break
                waits.append(time.perf_counter() - tw)
                staged.append(b.data[0]._data.clone())
                losses.append(step(b.data[0], b.label[0])[0])
                n_steps += 1
            torch.cuda.synchronize()
            feed_s.append(time.perf_counter() - t1)
        else:                                   # the staged batch
            for _ in range(nb):
                step(x_syn, y_syn)
                n_steps += 1
            torch.cuda.synchronize()
            syn_s.append(time.perf_counter() - t1)
    launches = _train_counts()
    feed.close()
    losses = [float(v) for v in losses]
    bits = []
    for k, t in enumerate(staged):
        j = k % nb
        want = tf(torch.from_numpy(imgs[j * batch:(j + 1) * batch]))[0]
        bits.append(torch.equal(t.cpu().view(torch.int16),
                                want.view(torch.int16)))
    per_step = _resnet_per_step(len(step._buckets))
    want = {k: v * n_steps for k, v in per_step.items()}
    out = {"phase": "data_resnet", "card": card, "warmup_steps": 2,
           "model": "resnet50_v1(layout='NHWC')",
           "dtype": "bfloat16, multi-precision sgd", "optimizer": RESNET_OPT,
           "feed": "NDArrayIter(uint8 NCHW) -> DeviceFeedIter(step, depth=2, "
                   "make_normalize_transform(ImageNet, bfloat16))",
           "batch": [batch, 3, 224, 224], "batches_per_pass": nb,
           "steps": n_steps, "losses_fed": losses,
           "staged_bits_equal": bits,
           "images_per_s_fed": [batch * nb / s for s in feed_s],
           "images_per_s_staged": [batch * nb / s for s in syn_s],
           "data_wait_ms_per_step": [1e3 * w for w in waits],
           "data_wait_ms_mean": 1e3 * float(np.mean(waits)),
           "h2d_mb_per_batch": imgs[:batch].nbytes / 1e6,
           "launches": launches, "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    torch.backends.cudnn.benchmark = bench
    emit(out)
    if not all(bits) or len(bits) != 2 * nb:
        fail(f"data_resnet: staged batches differ from the CPU transform "
             f"of their sources: {bits}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"data_resnet: the fed loss is not finite or did not fall: "
             f"{losses}")
    if launches != want or per_step["fused_sgd_sweep"] != 2:
        fail(f"data_resnet launch counts {launches} are not {want}")
    del step, net, feed, staged, x_syn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _lenet(mx):
    """examples/train_mnist_gluon.py's LeNet."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, kernel_size=5, activation="relu"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Conv2D(50, kernel_size=5, activation="relu"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Flatten(), nn.Dense(500, activation="relu"), nn.Dense(10))
    return net


def _shm_blocks() -> set:
    import os

    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def phase_data_gluon(card: str) -> dict:
    """The eager Gluon loop examples/train_mnist_gluon.py writes, at its
    widths (LeNet, batch 64): gluon.data.vision.MNIST (local files, else
    the seeded surrogate) with transform_first(ToTensor()), through
    DataLoader(shuffle=True, num_workers=4, pin_memory=True), two passes
    of autograd.record / backward / Trainer('sgd', lr 0.02, momentum
    0.9), mx.metric.Accuracy and callback.Speedometer. Checks: thread and
    fork workers (MXNET_TPU_FORK_WORKERS=1, shared memory) give the
    batches num_workers=0 gives from one sampler seed, bit for bit; the
    training accuracy rises from the first pass to the second; the SGD
    sweep launches once a step; no /dev/shm block is left after an
    early break out of a fork loader."""
    import logging
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    t0 = time.perf_counter()
    bs = 64
    ctx = mx.gpu()
    mnist = gluon.data.vision.MNIST(train=True)
    train = mnist.transform_first(gluon.data.vision.transforms.ToTensor())
    n = len(train)

    def loader(workers, fork=False, **kw):
        old = os.environ.get("MXNET_TPU_FORK_WORKERS")
        if fork:
            os.environ["MXNET_TPU_FORK_WORKERS"] = "1"
        try:
            return gluon.data.DataLoader(train, bs, num_workers=workers,
                                         pin_memory=True, **kw)
        finally:
            if fork and old is None:
                del os.environ["MXNET_TPU_FORK_WORKERS"]

    def first(ld, k=6):
        out = []
        for i, (x, y) in enumerate(ld):
            if i == k:
                break
            out.append((x._data.clone(), y._data.clone()))
        return out

    sampler = lambda: gluon.data.RandomSampler(  # noqa: E731
        n, rng=np.random.RandomState(7))
    ref = first(loader(0, sampler=sampler()))
    same = {}
    for mode, kw in (("threads", {}), ("fork", {"fork": True})):
        got = first(loader(4, sampler=sampler(), **kw))
        same[mode] = len(got) == len(ref) and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(got, ref))
    on_card = all(x.is_cuda for x, _ in ref)
    shm_before = _shm_blocks()
    for i, _ in enumerate(loader(4, fork=True, sampler=sampler(),
                                 prefetch=8)):
        if i == 1:
            break
    _ = None
    import gc

    gc.collect()
    shm_left = sorted(_shm_blocks() - shm_before)

    net = _lenet(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.02, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    train_loader = loader(4, shuffle=True)
    speed_lines = []

    class _Keep(logging.Handler):
        def emit(self, record):
            speed_lines.append(record.getMessage())

    handler = _Keep()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    Param = collections.namedtuple("BatchEndParam",
                                   "epoch nbatch eval_metric locals")
    speedometer = mx.callback.Speedometer(bs, frequent=50)
    accs, epoch_s, waits, steps = [], [], [], 0
    _reset_train_counts()
    try:
        for epoch in range(2):
            metric = mx.metric.Accuracy()
            te = time.perf_counter()
            batches = iter(train_loader)
            for i in itertools.count():
                tw = time.perf_counter()
                try:
                    x, y = next(batches)
                except StopIteration:
                    break
                waits.append(time.perf_counter() - tw)
                x, y = x.as_in_context(ctx), y.as_in_context(ctx)
                with autograd.record():
                    out = net(x)
                    loss = loss_fn(out, y)
                loss.backward()
                trainer.step(x.shape[0])
                metric.update([y], [out])
                speedometer(Param(epoch, i, metric, None))
                steps += 1
            epoch_s.append(time.perf_counter() - te)
            accs.append(metric.get()[1])
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    launches = _train_counts()
    want = {**dict.fromkeys(_train_counts(), 0), "fused_sgd_sweep": steps}
    # the loader alone, one pass: what the workers deliver without a step
    tl = time.perf_counter()
    for _ in loader(4, shuffle=True):
        pass
    loader_only = n / (time.perf_counter() - tl)
    out = {"phase": "data_gluon", "card": card,
           "model": "LeNet (examples/train_mnist_gluon.py)",
           "data": "MNIST -> transform_first(ToTensor()) -> DataLoader("
                   "64, shuffle, num_workers=4, pin_memory)",
           "mnist": {"synthetic": mnist.synthetic, "samples": n},
           "batches_equal_to_num_workers_0": same,
           "pinned_batches_on_card": on_card,
           "shm_blocks_left_after_break": shm_left,
           "train_accuracy": accs, "steps": steps,
           "samples_per_s": [n / s for s in epoch_s],
           "ms_per_step": [1e3 * s / (steps // 2) for s in epoch_s],
           "data_wait_ms_per_step_mean": 1e3 * float(np.mean(waits)),
           "data_wait_share": float(np.sum(waits)) / sum(epoch_s),
           "loader_only_samples_per_s": loader_only,
           "speedometer": speed_lines[-2:],
           "launches": launches, "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not all(same.values()) or not on_card:
        fail(f"data_gluon: worker batches differ from num_workers=0 "
             f"{same}, on card {on_card}")
    if shm_left:
        fail(f"data_gluon: /dev/shm blocks left after an early break: "
             f"{shm_left}")
    if not accs[1] > accs[0]:
        fail(f"data_gluon: the training accuracy did not rise: {accs}")
    if launches != want:
        fail(f"data_gluon launch counts {launches} are not {want}")
    return launches


# ---------------------------------------------------------------------------
# 17f. data_image: ResNet-50 v1 from JPEG records, decoded on the card
# ---------------------------------------------------------------------------

IMAGE_RECORDS = 1024
IMAGE_CLASSES = 8
IMAGENET_CHW_MEAN_STD = ((123.68, 116.28, 103.53), (58.395, 57.12, 57.375))


def _photo(h, w, rs, base, gen):
    """A seeded (h, w, 3) uint8 image on the card: smooth gradients, a
    fine texture, hard-edged rectangles and discs, noise; at quality 90
    such a file is 30-110 KB, as photographs of this size are."""
    y = torch.arange(h, dtype=torch.float32, device="cuda")[:, None]
    x = torch.arange(w, dtype=torch.float32, device="cuda")[None, :]
    chans = []
    for c in range(3):
        fx, fy = rs.uniform(0.005, 0.06, 2)
        ph = rs.uniform(0, 6.28)
        gx, gy = rs.uniform(0.15, 0.6, 2)
        chans.append(float(base[c])
                     + 70 * torch.sin(fx * x + ph) * torch.cos(fy * y + ph)
                     + 25 * torch.sin(gx * x + 2 * ph) * torch.sin(gy * y))
    img = torch.stack(chans, -1)
    for _ in range(6):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        hh, ww = rs.randint(h // 10, h // 3), rs.randint(w // 10, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] = torch.from_numpy(
            rs.uniform(0, 255, 3).astype(np.float32)).cuda()
    for _ in range(3):
        cy, cx, r = rs.randint(0, h), rs.randint(0, w), rs.randint(10, 60)
        disc = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[disc] = torch.from_numpy(
            rs.uniform(0, 255, 3).astype(np.float32)).cuda()
    img = img + 12 * torch.randn(img.shape, generator=gen, device="cuda")
    return img.clamp_(0, 255).to(torch.uint8)


def _write_jpeg_records(rec, idx, n, seed) -> dict:
    """n seeded JPEG records (sizes 320-500 x 240-375, quality 90, each
    class a colour cast the net can learn) written by recordio.pack_img
    on the card (nvJPEG's encoder), with their .idx."""
    from mxnet_tpu_torch import recordio

    rs = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    labels = rs.randint(0, IMAGE_CLASSES, n)
    casts = rs.uniform(60, 195, (IMAGE_CLASSES, 3))
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    sizes, enc_s = [], 0.0
    for k in range(n):
        h, wd = rs.randint(240, 376), rs.randint(320, 501)
        img = _photo(h, wd, rs, casts[labels[k]], gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = recordio.pack_img(recordio.IRHeader(0, float(labels[k]), k, 0),
                                img, quality=90)
        enc_s += time.perf_counter() - t0
        w.write_idx(k, buf)
        sizes.append(len(buf))
    w.close()
    return {"records": n, "quality": 90, "mean_kb": float(np.mean(sizes)) / 1e3,
            "min_kb": min(sizes) / 1e3, "max_kb": max(sizes) / 1e3,
            "file_mb": sum(sizes) / 1e6,
            "encode_ms_per_image": 1e3 * enc_s / n}


def _fixture_fidelity() -> dict:
    """nvJPEG's decode of tests/torch_image_fixtures against Pillow's
    pixels kept beside each file, one file at a time and in a batch, held
    to the limits of tests/torch_image_fixtures/fidelity.py (the card
    test's)."""
    import importlib.util
    import os

    from mxnet_tpu_torch.kernels import jpeg

    spec = importlib.util.spec_from_file_location(
        "fidelity", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "torch_image_fixtures",
                                 "fidelity.py"))
    fidelity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fidelity)
    files = fidelity.load()
    out, misses = {}, []

    def judge(name, got, route):
        rec, ok = fidelity.judge(got, files[name][1], files[name][2])
        if not ok:
            misses.append((name, route, rec))
        out.setdefault(name, {})[route] = rec

    for name, (data, _, kind) in files.items():
        judge(name, jpeg.decode(data, fmt="Y" if kind == "gray" else "RGB")
              .cpu().numpy(), "single")
    color = [n for n in files if files[n][2] != "gray"]
    for n, t in zip(color, jpeg.decode_batch([files[n][0] for n in color])):
        judge(n, t.cpu().numpy(), "batch[" + jpeg.last_backend + "]")
    return {"fixtures": out, "misses": misses,
            "limits": {"max_diff": fidelity.MAX_DIFF,
                       "min_psnr_db": fidelity.MIN_PSNR_DB,
                       "max_mean_diff": fidelity.MAX_MEAN_DIFF}}


def _chain_card_vs_cpu(it, rec, idx) -> dict:
    """The iterator's first batch on the card, data and labels, against
    the same chain on the CPU fed the card's decode of the batch's files
    (one batched nvJPEG call, as the iterator's) with each sample's seed:
    the uint8 steps (resize, crop, flip) on the card and on the CPU bit
    for bit, the batch's normalized float32 within 1e-6 of the CPU
    chain's, its labels the records'."""
    from mxnet_tpu_torch import image, recordio
    from mxnet_tpu_torch.kernels import jpeg
    from mxnet_tpu_torch.ndarray import NDArray

    n = it.batch_size
    order = list(it._order[:n])
    seeds = [it._sample_seed(k) for k in range(n)]
    batch = it.next()
    data = batch.data[0]._data.cpu()
    labels = batch.label[0]._data.cpu()
    reader = recordio.MXIndexedRecordIO(idx, rec, "r")
    records = [recordio.unpack(reader.read_idx(k)) for k in order]
    reader.close()
    decoded = jpeg.decode_batch([p for _, p in records])
    cast = next(i for i, a in enumerate(it.auglist)
                if isinstance(a, image.CastAug))
    geometry = it.auglist[:cast]
    uint8_equal, max_err, shapes = 0, 0.0, set()
    for j, (img, seed) in enumerate(zip(decoded, seeds)):
        u8 = []
        for dev_img in (img, img.cpu()):
            with image._sample_draws(seed):
                x = NDArray(dev_img)
                for aug in geometry:
                    x = aug(x)
            u8.append(x._data.cpu())
        uint8_equal += int(torch.equal(*u8))
        cpu_f = image._decode_augment(None, it.auglist, 3, it._dtype, seed,
                                      image=NDArray(img.cpu()))
        max_err = max(max_err, float((data[j] - cpu_f).abs().max()))
        shapes.add(tuple(img.shape))
    want_labels = torch.tensor([float(h.label) for h, _ in records])
    return {"samples": n, "distinct_source_sizes": len(shapes),
            "chain": [type(a).__name__ for a in it.auglist],
            "uint8_bit_equal": uint8_equal, "float32_max_abs_err": max_err,
            "labels_equal": bool(torch.equal(labels, want_labels)),
            "pad": batch.pad}


def phase_data_image(card: str) -> dict:
    """ResNet-50 v1 trained from a JPEG record file, decoded and augmented
    on the card: the reference's ImageNet pipeline (im2rec records ->
    ImageRecordIter -> ResNet) with nvJPEG for Pillow.

    A record file of 1024 seeded images (320-500 x 240-375, 8 classes,
    quality 90) written by recordio.pack_img on the card, with its .idx;
    nvJPEG against the committed Pillow fixtures; the iterator's first
    batch (256) against the same chain on the CPU; then
    resnet50_v1(layout="NHWC") at phase 15's cell (bf16, 256 x 224, SGD
    lr 0.1, momentum 0.9, multi-precision) through
    mx.io.ImageRecordIter(shuffle, resize=256, rand_crop, rand_mirror,
    ImageNet mean/std, seed) on the card: a
    warm-up pass and two cuDNN warm-up steps, then four passes in turns
    with the same steps on a staged batch (fed, staged, fed, staged).
    Checks: the loss finite, exactly 2 SGD sweeps a step, one batched
    nvJPEG call per fed batch; then a profiler round (set_state('run')
    around two fed steps) whose table names mx_sgd_sweep and whose
    chrome trace parses. Reports images/s fed and staged, the data wait
    per step, nvJPEG's decode ms per batch and image and its backend."""
    import gc
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.kernels import jpeg

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mx_data_image_")
    bench = torch.backends.cudnn.benchmark
    try:
        rec, idx = os.path.join(tmp, "img.rec"), os.path.join(tmp, "img.idx")
        written = _write_jpeg_records(rec, idx, IMAGE_RECORDS, SEED)
        fidelity = _fixture_fidelity()
        batch = 256
        nb = IMAGE_RECORDS // batch
        (mr, mg, mb), (sr, sg, sb) = IMAGENET_CHW_MEAN_STD
        it = mx.io.ImageRecordIter(
            path_imgrec=rec, path_imgidx=idx, data_shape=(3, 224, 224),
            batch_size=batch, shuffle=True, resize=256, rand_crop=True,
            rand_mirror=True, mean_r=mr, mean_g=mg, mean_b=mb, std_r=sr,
            std_g=sg, std_b=sb, seed=SEED, ctx=mx.gpu(0))
        chain = _chain_card_vs_cpu(it, rec, idx)
        # nvJPEG alone on one batch's files, three times
        reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
        payloads = [mx.recordio.unpack(reader.read_idx(k))[1]
                    for k in range(batch)]
        reader.close()
        decode_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            jpeg.decode_batch(payloads)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t1))
        # the iterator alone: a warm-up pass (coefficient tables, states),
        # then one pass timed, each batch synchronised
        for _ in it:
            pass
        it.reset()
        iter_ms = []
        while True:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            try:
                b = it.next()
            except StopIteration:
                break
            torch.cuda.synchronize()
            iter_ms.append(1e3 * (time.perf_counter() - t1))
        del b

        torch.backends.cudnn.benchmark = True
        net = resnet50_v1(layout="NHWC", dtype=torch.bfloat16,
                          generator=torch.Generator(device="cuda")
                          .manual_seed(SEED))
        step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     optimizer_params=dict(RESNET_OPT))
        it.reset()
        first = it.next()
        x_syn = first.data[0]._data.to(torch.bfloat16)
        y_syn = first.label[0]._data.clone()
        del first
        for _ in range(2):            # cuDNN's autotuner, out of the turns
            step(x_syn, y_syn)
        losses, waits, feed_s, syn_s = [], [], [], []
        _reset_train_counts()
        jpeg.decode_batch.launches = 0
        n_steps = fed_batches = 0
        for turn in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if turn % 2 == 0:                   # fed from the records
                it.reset()
                while True:
                    tw = time.perf_counter()
                    try:
                        b = it.next()
                    except StopIteration:
                        break
                    waits.append(time.perf_counter() - tw)
                    losses.append(step(b.data[0]._data.to(torch.bfloat16),
                                       b.label[0]._data)[0])
                    fed_batches += 1
                    n_steps += 1
                torch.cuda.synchronize()
                feed_s.append(time.perf_counter() - t1)
            else:                               # the staged batch
                for _ in range(nb):
                    step(x_syn, y_syn)
                    n_steps += 1
                torch.cuda.synchronize()
                syn_s.append(time.perf_counter() - t1)
        launches = _train_counts()
        decodes = jpeg.decode_batch.launches
        losses = [float(v) for v in losses]
        per_step = _resnet_per_step(len(step._buckets))
        want = {k: v * n_steps for k, v in per_step.items()}
        # a profiler round on the card: two fed steps
        profiler.set_config(filename=os.path.join(tmp, "profile.json"))
        it.reset()
        profiler.set_state("run")
        for _ in range(2):
            b = it.next()
            step(b.data[0]._data.to(torch.bfloat16), b.label[0]._data)
        profiler.set_state("stop")
        trace = json.loads(profiler.dumps(format="chrome_trace"))
        table = profiler.dumps(reset=True)
        device_rows = table.split("Device kernels:", 1)[-1].split(
            "Kernel entry points:", 1)[0]
        sweep_row = [ln for ln in table.splitlines()
                     if ln.startswith("mx_sgd_sweep")]
        prof = {"table_names_mx_sgd_sweep": bool(sweep_row),
                "mx_sgd_sweep_row": sweep_row[0] if sweep_row else None,
                "sgd_kernel_in_device_section": "sgd_kernel" in device_rows,
                "device_kernel_rows": len(device_rows.strip().splitlines())
                - 1,
                "chrome_trace_events": len(trace["traceEvents"]),
                "table_head": table.splitlines()[:3]}
        it.close()
        out = {"phase": "data_image", "card": card,
               "model": "resnet50_v1(layout='NHWC')",
               "dtype": "bfloat16, multi-precision sgd",
               "optimizer": RESNET_OPT,
               "feed": "mx.io.ImageRecordIter(shuffle, resize=256, rand_crop, "
                       "rand_mirror, ImageNet mean/std, seed, ctx=gpu(0)): "
                       "nvJPEG batched decode + augmenters on the card",
               "record_file": written, "fidelity": fidelity,
               "nvjpeg": {"version": jpeg.version(),
                          "backend": jpeg.last_backend,
                          "hardware_refusal": jpeg.hardware_refusal,
                          "decode_ms_per_batch": decode_ms,
                          "decode_ms_per_image":
                              [v / batch for v in decode_ms],
                          "batch": batch},
               "chain_card_vs_cpu": chain,
               "iterator_ms_per_batch": iter_ms,
               "batch": [batch, 3, 224, 224], "batches_per_pass": nb,
               "steps": n_steps, "warmup_steps": 2, "losses_fed": losses,
               "images_per_s_fed": [batch * nb / t for t in feed_s],
               "images_per_s_staged": [batch * nb / t for t in syn_s],
               "data_wait_ms_per_step": [1e3 * w for w in waits],
               "data_wait_ms_mean": 1e3 * float(np.mean(waits)),
               "decode_batched_calls": decodes, "fed_batches": fed_batches,
               "launches": launches, "launches_expected": want,
               "profiler": prof,
               "seconds": time.perf_counter() - t0}
        emit(out)
    finally:
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(tmp, ignore_errors=True)
    if fidelity["misses"]:
        fail(f"data_image: nvJPEG misses the fixture limits: "
             f"{fidelity['misses']}")
    if chain["uint8_bit_equal"] != chain["samples"] or \
            not chain["float32_max_abs_err"] <= 1e-6 or \
            not chain["labels_equal"] or chain["pad"]:
        fail(f"data_image: the card's augmenter chain differs from the "
             f"CPU's: {chain}")
    if not all(np.isfinite(losses)):
        fail(f"data_image: the fed loss is not finite: {losses}")
    if launches != want or per_step["fused_sgd_sweep"] != 2:
        fail(f"data_image launch counts {launches} are not {want}")
    if decodes != fed_batches or fed_batches != 2 * nb:
        fail(f"data_image: {decodes} batched nvJPEG calls for "
             f"{fed_batches} fed batches")
    if not (prof["table_names_mx_sgd_sweep"]
            and prof["sgd_kernel_in_device_section"]):
        fail(f"data_image: the profiler table does not name the SGD sweep: "
             f"{prof}")
    del step, net, x_syn, y_syn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 17g-17h. the compilation service
# ---------------------------------------------------------------------------

def _repo():
    import pathlib

    return pathlib.Path(__file__).resolve().parent


def phase_coldstart(card: str) -> dict:
    """The cold-start meter (see 17g and the tool's docstring), in its
    own processes; returns the warm-manifest serving run's launches by
    kernel (counted from just after warm_start)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.coldstart_bench",
         "--seed", str(SEED)], cwd=_repo(), capture_output=True, text=True,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"coldstart: no result (rc={proc.returncode}):\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    runs = rec["coldstart"]
    summary = {}
    for regime, paths in runs.items():
        summary[regime] = {
            "events_s": {**paths["serve"]["events"],
                         **{k: v for k, v in paths["train"]["events"].items()
                            if k == "first_train_step"}},
            "import_s": paths["serve"]["import_s"],
            "first_generate_ms": paths["serve"]["first_dispatch_ms"],
            "first_bert_ms": {k: v for k, v in
                              paths["serve"]["latency"].items()
                              if k.startswith("bert")},
            "first_train_step_ms": paths["train"]["first_dispatch_ms"],
            "misses_after_warmup": {**paths["serve"]["misses_after_warmup"],
                                    **paths["train"]["misses_after_warmup"]},
            "nvrtc": paths["serve"]["nvrtc"],
            "warm_report": {p: paths[p]["warm_report"]
                            for p in ("serve", "train")},
            "process_s": {p: paths[p]["process_s"]
                          for p in ("serve", "train")}}
    warm = runs["warm_manifest"]["serve"]
    emit({"phase": "coldstart", "card": card, "build": rec["build"],
          "regimes": summary, "gates": rec["gates"],
          "warm_manifest_launches": warm["launches"],
          "warm_manifest_graph_launches": warm["graph_launches"],
          "tokens_cold": runs["cold"]["serve"]["tokens"],
          "loss_cold": runs["cold"]["train"]["loss"],
          "seconds": time.perf_counter() - t0})
    if proc.returncode != 0 or not rec["gates"]["ok"]:
        fail(f"coldstart: gates failed: {rec['gates']}")
    return warm["launches"]


def _llama_flops(cfg, batch, seq) -> float:
    """6·N·tokens (N: the parameters outside the embedding table) plus
    the causal attention's 6·L·B·S²·units."""
    from mxnet_tpu_torch.tools.pretrain_llama import param_count

    n = param_count(cfg) - cfg["vocab_size"] * cfg["units"]
    return (6.0 * n * batch * seq
            + 6.0 * cfg["num_layers"] * batch * seq * seq * cfg["units"])


def phase_compile_only(card: str) -> dict:
    """17h: the 8b recipe without its weights, then proxy1b AOT against
    live on the card."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.tools import pretrain_llama as pl

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.pretrain_llama",
         "--config", "8b", "--compile-only"], cwd=_repo(),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"compile_only: 8b --compile-only failed:\n"
             f"{proc.stderr[-6000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg8 = pl.CONFIGS["8b"]
    n8 = pl.param_count(cfg8)
    b8, s8 = rec["batch"], rec["seq"]
    want8 = _llama_flops(cfg8, b8, s8)
    emit({"phase": "compile_only", "config": "8b", "card": card, **rec,
          "analytic_argument_bytes": n8 * 14 + 2 * b8 * s8 * 4,
          "analytic_flops": want8,
          "flops_over_analytic": rec["flops_per_step"] / want8,
          "process_s": time.perf_counter() - t0})
    if not rec["device_max_allocated_bytes"] < 2 ** 30:
        fail(f"compile_only: 8b allocated {rec['device_max_allocated_bytes']}"
             " bytes on the card")
    if not rec["params"] == rec["params_in_net"] == n8:
        fail(f"compile_only: params {rec['params']} / "
             f"{rec['params_in_net']} are not param_count's {n8}")
    if rec["argument_bytes_per_device"] != n8 * 14 + 2 * b8 * s8 * 4:
        fail(f"compile_only: 8b argument bytes "
             f"{rec['argument_bytes_per_device']} are not the analytic "
             f"{n8 * 14 + 2 * b8 * s8 * 4}")
    if rec["fits"] is not False:
        fail(f"compile_only: 8b fits={rec['fits']} on an 80 GB card")
    if abs(rec["flops_per_step"] / want8 - 1) > 0.01:
        fail(f"compile_only: 8b FLOPs {rec['flops_per_step']} are not "
             f"within 1% of {want8}")

    # proxy1b: AOT on meta, then live, at llama_train's cell
    batch, seq = 8, 2048
    cfg = pl.CONFIGS["proxy1b"]
    tok = (torch.Size([batch, seq]), torch.int32)
    t1 = time.perf_counter()
    _, aot_step = pl.build("proxy1b", ctx=mx.gpu(0), remat=False,
                           abstract=True)
    compiled = aot_step.aot_compile((tok, tok), ())
    aot_s = time.perf_counter() - t1
    mem = compiled.memory_analysis()
    flops = compiled.cost_analysis()["flops"]
    want = _llama_flops(cfg, batch, seq)
    net, step = pl.build("proxy1b", ctx=mx.gpu(0), remat=False)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, cfg["vocab_size"], (batch, seq + 1))
    data = (torch.from_numpy(toks[:, :-1].astype(np.int32)).cuda(),
            torch.from_numpy(toks[:, 1:].astype(np.int32)).cuda())
    live_args = step.argument_bytes(data, ())
    meta_flops = telemetry.xla_cost_analysis(step, (data, ()))["flops"]
    for _ in range(3):
        step(data, ())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = 5
    t2 = time.perf_counter()
    for _ in range(timed):
        loss = step(data, ())[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t2) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "compile_only", "config": "proxy1b", "card": card,
           "batch": [batch, seq], "remat": False, "aot_s": aot_s,
           "aot_argument_bytes": mem.argument_size_in_bytes,
           "live_argument_bytes": live_args,
           "aot_temp_bytes": mem.temp_size_in_bytes,
           "live_peak_bytes": peak,
           "live_peak_less_arguments_bytes": peak - live_args,
           "aot_output_bytes": mem.output_size_in_bytes,
           "flops_per_step": flops, "xla_cost_analysis_flops": meta_flops,
           "analytic_flops": want, "flops_over_analytic": flops / want,
           "ms_per_step": ms, "steps": timed, "loss": float(loss),
           "mfu": flops / (ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16],
           "mfu_6n": 6.0 * pl.param_count(cfg) * batch * seq
           / (ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16]}
    emit(out)
    if mem.argument_size_in_bytes != live_args:
        fail(f"compile_only: proxy1b AOT argument bytes "
             f"{mem.argument_size_in_bytes} are not the live step's "
             f"{live_args}")
    if abs(flops / want - 1) > 0.01 or meta_flops != flops:
        fail(f"compile_only: proxy1b FLOPs {flops} (live step's count "
             f"{meta_flops}) are not within 1% of {want}")
    if not np.isfinite(out["loss"]):
        fail(f"compile_only: proxy1b loss {out['loss']}")
    del net, step, aot_step, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 17i-17j. the recurrent stack: the RNN op's cuDNN route, MXNet's word LM
# ---------------------------------------------------------------------------

RNN_MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
# the card route against the f32 step loop, relative to the largest
# magnitude: cuDNN's sigmoid and tanh read up to 2.0e-5 against an f64
# step loop on the H100 (the f32 loop 1.1e-6), relu, which calls neither,
# 2.5e-7
RNN_F32_LIMIT = {"rnn_relu": 1e-5, "rnn_tanh": 5e-5, "lstm": 5e-5,
                 "gru": 5e-5}
# MXNet's example/gluon/word_language_model at its 650-wide line (the
# medium model of Zaremba et al. 2014) over WikiText-2's vocabulary
WORD_LM = dict(vocab=33278, emb=650, hidden=650, layers=2, dropout=0.5,
               batch=32, bptt=35, lr=1.0, clip=0.25)


def _tf32(on: bool) -> tuple:
    """Set both TF32 switches; returns the previous (matmul, cudnn)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return prev


def _restore_tf32(prev) -> None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _rnn_case(mode, bidirectional, layers, seq, batch, width, seed,
              p=0.0, train=False, dtype=torch.float32):
    """The RNN op on the card and on the CPU (the step loop) over the
    same inputs in ``dtype``, forward and backward for a random head
    gradient, and the step loop in f64; returns ({"card_vs_cpu", "card_vs_f64",
    "cpu_vs_f64"}: the worst error of outputs, states and gradients
    relative to each one's largest magnitude, the cuDNN route's calls on
    the card, the seeds each device drew)."""
    from mxnet_tpu_torch import autograd, random_state
    from mxnet_tpu_torch.ops import rnn as prnn

    rs = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    n = prnn.rnn_param_size(mode, layers, width, width, bidirectional)
    arrays = [rs.randn(seq, batch, width), rs.randn(n) * 0.1,
              rs.randn(layers * dirs, batch, width),
              rs.randn(layers * dirs, batch, width)][:4 if mode == "lstm"
                                                     else 3]
    heads = [rs.randn(seq, batch, width * dirs),
             rs.randn(layers * dirs, batch, width),
             rs.randn(layers * dirs, batch, width)]
    kw = dict(state_size=width, num_layers=layers, mode=mode,
              bidirectional=bidirectional, p=p)
    got = {}
    # every route starts from the same values: dtype's rounding of them
    arrays = [torch.from_numpy(a).to(dtype) for a in arrays]
    for dev, dt in (("cuda", dtype), ("cpu", dtype),
                    ("f64", torch.float64)):
        ts = [a.to("cpu" if dev == "f64" else dev, dt, copy=True)
              .requires_grad_() for a in arrays]
        before = prnn.cudnn_rnn_layer.launches
        with autograd.train_mode() if train else autograd.predict_mode(), \
                random_state.scoped_seed(SEED + seed), \
                random_state.seed_tape() as seeds:
            outs = prnn.rnn(*ts, **kw)
        calls = prnn.cudnn_rnn_layer.launches - before
        torch.autograd.backward(outs, [
            torch.from_numpy(h).to(dtype).to(ts[0].device, dt)
            for h in heads[:len(outs)]])
        got[dev] = ([o.detach().double().cpu() for o in outs]
                    + [t.grad.double().cpu() for t in ts], calls,
                    list(seeds))

    def worst(a, b):
        return max(float((x - y).abs().max()
                         / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(got[a][0], got[b][0]))

    if got["cpu"][1] != 0 or got["f64"][1] != 0:
        fail(f"rnn: the CPU route called cuDNN ({got['cpu'][1]})")
    errs = {"card_vs_cpu": worst("cuda", "cpu"),
            "card_vs_f64": worst("cuda", "f64"),
            "cpu_vs_f64": worst("cpu", "f64")}
    return errs, got["cuda"][1], got["cuda"][2], got["cpu"][2]


def _rnn_kind(name) -> str:
    """_kind, with cuDNN's RNN kernels apart (torch's own fused LSTM/GRU
    cell kernels, ``at::native``, are not cuDNN's)."""
    low = name.lower()
    if any(k in low for k in ("rnn", "lstm", "gru")) \
            and "at::native" not in name:
        return "cudnn_rnn"
    return _kind(name)


def _layer_ms(fn, iters=20) -> float:
    """fn's ms per call on the card from CUDA events, after 3 calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_rnn(card: str) -> dict:
    """The RNN op's card route (one cuDNN call per layer) against the
    plain step loop on the CPU: f32, TF32 off, every mode and direction
    at 2 layers, seq 35, batch 8, width 64; outputs, states and every
    gradient to RNN_F32_LIMIT of the largest magnitude (each route's
    distance from the step loop in f64 beside it); in bf16 the card no
    farther from the f64 loop than 2^-7 of the largest magnitude or 1.5
    times the bf16 step loop's distance; the route's counter
    moved by exactly 2 a call; the profiler naming cuDNN's RNN kernels;
    at p = 0.5 in training both devices draw the same inter-layer seeds
    and the kernel's masks at that shape are the plain version's bit for
    bit.
    Record: cuDNN's ms per layer and the step loop's ms on the card at
    the word LM's (35, 32, 650), forward and forward + backward."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.kernels import hash_dropout, hash_dropout_reference
    from mxnet_tpu_torch.ops import rnn as prnn

    gc.collect()
    t0 = time.perf_counter()
    prev = _tf32(False)
    errs, over = {}, []
    for mode in RNN_MODES:
        for bi in (False, True):
            err, calls, _, _ = _rnn_case(mode, bi, 2, 35, 8, 64, seed=1)
            errs[f"{mode}{'_bi' if bi else ''}"] = err
            if calls != 2:
                fail(f"rnn: {mode} bidirectional={bi}: {calls} cuDNN "
                     "calls for 2 layers")
            if not err["card_vs_cpu"] <= RNN_F32_LIMIT[mode]:
                over.append(mode)
    if over:
        fail(f"rnn: card against the step loop {errs} (limits "
             f"{RNN_F32_LIMIT})")
    # bf16: each route's distance from the f64 step loop; the card may be
    # no farther than 2^-7 or 1.5x the bf16 step loop's distance
    bf16 = {}
    for mode in RNN_MODES:
        for bi in (False, True):
            err, _, _, _ = _rnn_case(mode, bi, 2, 35, 8, 64, seed=3,
                                     dtype=torch.bfloat16)
            bf16[f"{mode}{'_bi' if bi else ''}"] = err
    if any(e["card_vs_f64"] > max(BF16_ULP, 1.5 * e["cpu_vs_f64"])
           for e in bf16.values()):
        fail(f"rnn: bf16 card against the f64 step loop {bf16}")
    drop_errs, masks_equal = {}, True
    for mode in ("lstm", "gru"):
        err, _, card_seeds, cpu_seeds = _rnn_case(
            mode, True, 3, 35, 8, 64, seed=2, p=0.5, train=True)
        drop_errs[mode] = err
        if card_seeds != cpu_seeds or len(card_seeds) != 2:
            fail(f"rnn: inter-layer seeds {card_seeds} on the card, "
                 f"{cpu_seeds} on the CPU")
        for s in card_seeds:
            ones = torch.ones(35, 8, 128)
            masks_equal &= torch.equal(
                hash_dropout(ones.cuda(), 0.5, s).cpu(),
                hash_dropout_reference(ones, 0.5, s))
    if not masks_equal or any(e["card_vs_cpu"] > RNN_F32_LIMIT[m]
                              for m, e in drop_errs.items()):
        fail(f"rnn: dropout between layers: masks equal {masks_equal}, "
             f"errors {drop_errs}")
    # the profiler names cuDNN's kernels, forward and backward
    x = torch.randn(35, 8, 64, device="cuda", requires_grad=True)
    w = (torch.randn(prnn.rnn_param_size("lstm", 2, 64, 64, True),
                     device="cuda") * 0.1).requires_grad_()
    h = torch.zeros(4, 8, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = prnn.rnn(x, w, h, h, state_size=64, num_layers=2,
                       mode="lstm", bidirectional=True)
        out[0].sum().backward()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if _rnn_kind(e.key) == "cudnn_rnn"})
    if not names:
        fail("rnn: the profiler saw no cuDNN RNN kernel: "
             f"{sorted({e.key[:60] for e in prof.key_averages()})}")
    # the word LM's layer: cuDNN against the step loop on the card
    _restore_tf32(prev)
    seq, batch, width = WORD_LM["bptt"], WORD_LM["batch"], WORD_LM["hidden"]
    xs = torch.randn(seq, batch, width, device="cuda", requires_grad=True)
    ws = (torch.randn(prnn.rnn_param_size("lstm", 1, width, width, False),
                      device="cuda") * 0.04).requires_grad_()
    h0 = torch.zeros(1, batch, width, device="cuda")
    layer_ws = prnn._slice_params(ws, "lstm", 1, width, width, 1)[0]
    timing = {}
    for route, call in (
            ("cudnn", lambda: prnn.cudnn_rnn_layer("lstm", xs, h0, h0,
                                                   layer_ws)[0]),
            ("step_loop", lambda: prnn._plain_layer("lstm", xs, h0, h0,
                                                    layer_ws)[0])):
        with torch.no_grad():
            fwd = _layer_ms(call)
        timing[route] = {"fwd_ms": fwd,
                         "fwd_bwd_ms": _layer_ms(
                             lambda: call().sum().backward())}
    emit({"phase": "rnn", "card": card, "tf32": False,
          "max_rel_err": errs, "limits": RNN_F32_LIMIT,
          "bf16_max_rel_err": bf16,
          "dropout_max_rel_err": drop_errs, "masks_bit_equal": masks_equal,
          "cudnn_calls_per_call": 2, "cudnn_kernels": [n[:80] for n in names],
          "lm_layer_shape": [seq, batch, width],
          "lm_layer_ms": timing,
          "lm_layer_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                            "cudnn": torch.backends.cudnn.allow_tf32},
          "seconds": time.perf_counter() - t0})
    return errs


def _word_lm_model(mx, vocab, cfg):
    """``example/gluon/word_language_model``'s RNNModel: the embedding,
    dropout, the LSTM with dropout between its layers, dropout, and the
    decoder tied to the embedding through ``params=``."""
    gl = mx.gluon

    class RNNModel(gl.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = gl.nn.Dropout(cfg["dropout"])
                self.encoder = gl.nn.Embedding(vocab, cfg["emb"])
                self.rnn = gl.rnn.LSTM(cfg["hidden"], cfg["layers"],
                                       dropout=cfg["dropout"],
                                       input_size=cfg["emb"])
                self.decoder = gl.nn.Dense(vocab, in_units=cfg["hidden"],
                                           params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return (self.decoder(output.reshape((-1, cfg["hidden"]))),
                    hidden)

    return RNNModel()


def _zipf_stream(vocab, n_tokens, batch, seed):
    """A Zipf(1)-distributed token stream over ``vocab`` ids (ranks
    mapped to ids by a permutation), laid out (length, batch) as the
    example's batchify does."""
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rs.permutation(vocab)[rs.choice(vocab, size=n_tokens, p=p / p.sum())]
    n = n_tokens // batch
    return ids[:n * batch].reshape(batch, n).T.astype(np.float32)


class _WordLMLoop:
    """The example's training loop over segments of ``stream``: the state
    detached between segments, mean token cross-entropy under
    ``autograd.record()``, ``loss.backward()``, ``clip_global_norm`` of
    the gradients, ``trainer.step(1)``. ``seed_base``: each step runs
    under ``random_state.scoped_seed(seed_base + step)``, so two devices
    draw the same dropout seeds."""

    def __init__(self, mx, model, stream, ctx, seed_base):
        self.mx, self.model, self.ctx = mx, model, ctx
        self.stream, self.seed_base = stream, seed_base
        self.params = model.collect_params()
        self.trainer = mx.gluon.Trainer(self.params, "sgd",
                                        {"learning_rate": WORD_LM["lr"]})
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.hidden = model.rnn.begin_state(stream.shape[1], ctx=ctx)
        self.step_no = 0
        self.segments = []
        bptt = WORD_LM["bptt"]
        for i in range(0, stream.shape[0] - 1 - bptt + 1, bptt):
            self.segments.append((mx.nd.array(stream[i:i + bptt], ctx=ctx),
                                  mx.nd.array(stream[i + 1:i + 1 + bptt]
                                              .reshape(-1), ctx=ctx)))

    def step(self):
        from mxnet_tpu_torch import random_state

        mx = self.mx
        data, target = self.segments[self.step_no % len(self.segments)]
        self.hidden = [h.detach() for h in self.hidden]
        with random_state.scoped_seed(self.seed_base + self.step_no):
            with mx.autograd.record():
                out, self.hidden = self.model(data, self.hidden)
                loss = self.loss_fn(out, target).mean()
            loss.backward()
        mx.gluon.utils.clip_global_norm(
            [p.grad() for p in self.params.values()], WORD_LM["clip"])
        self.trainer.step(1)
        self.step_no += 1
        return loss


def _wlm_values(model) -> dict:
    return {k: p.data()._data.detach().float().cpu().clone()
            for k, p in model._collect_params_with_prefix().items()}


def _word_lm_counts() -> dict:
    from mxnet_tpu_torch.ops import rnn as prnn

    out = {k: v for k, v in _train_counts().items()
           if k in ("hash_dropout", "hash_dropout_bwd", "fused_sgd_sweep")}
    out["cudnn_rnn_layer"] = prnn.cudnn_rnn_layer.launches
    return out


def _reset_word_lm_counts() -> None:
    from mxnet_tpu_torch.ops import rnn as prnn

    _reset_train_counts()
    prnn.cudnn_rnn_layer.launches = 0


def phase_word_lm(card: str) -> dict:
    """MXNet's word language model at its 650-wide line, not cut (the
    vocabulary WikiText-2's 33278, ~28M f32 parameters), over a Zipf
    token stream from SEED. Gate 1: two steps on the card against the
    same two on the CPU, f32 with TF32 off, the same weights (a .params
    file) and dropout seeds: each loss within 1e-5 relative, every
    parameter's delta within 1e-3 by norm ratio. Gate 2: 25 steps on the
    card at the process's TF32 settings (printed: off since the kernels
    phase in a whole run, torch's defaults when the phase runs alone),
    the loss finite and
    each of steps 2-5 below step 1's; over the 20 timed steps exactly 3
    hash_dropout and 3 hash_dropout_bwd launches, one SGD sweep and two
    cuDNN layer calls per step. Record: tokens/s, ms per step, host
    against device ms and the idle share, device ms by kind, the CE
    head's own device ms, peak memory. Gate 3: predict through the
    hybridized LSTM: four segments through the graph equal to the eager
    forward bit for bit, one capture, none after, two cuDNN calls per
    replay."""
    import gc
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as prnn

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, vocab = WORD_LM, WORD_LM["vocab"]
    batch, bptt = cfg["batch"], cfg["bptt"]
    gpu = mx.gpu(0)
    stream = _zipf_stream(vocab, batch * (bptt * 40 + 1), batch, SEED + 19)
    mx.random.seed(SEED + 19)
    model = _word_lm_model(mx, vocab, cfg)
    model.initialize(mx.init.Uniform(0.1), ctx=gpu)
    model(mx.nd.array(stream[:bptt], ctx=gpu),
          model.rnn.begin_state(batch, ctx=gpu))
    n_params = sum(int(np.prod(p.shape))
                   for p in model.collect_params().values())
    # gate 1: card against CPU, f32, TF32 off
    prev = _tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wlm.params")
        model.save_parameters(path)
        cpu_model = _word_lm_model(mx, vocab, cfg)
        cpu_model.load_parameters(path, ctx=mx.cpu())
        card_ref = _word_lm_model(mx, vocab, cfg)
        card_ref.load_parameters(path, ctx=gpu)
    w0 = _wlm_values(card_ref)
    runs, cpu_s = {}, 0.0
    for name, net, ctx in (("card", card_ref, gpu),
                           ("cpu", cpu_model, mx.cpu())):
        loop = _WordLMLoop(mx, net, stream, ctx, SEED + 190)
        t1 = time.perf_counter()
        losses = [float(loop.step().asnumpy()) for _ in range(2)]
        if name == "cpu":
            cpu_s = time.perf_counter() - t1
        runs[name] = (losses, _wlm_values(net))
    _restore_tf32(prev)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(runs["card"][0], runs["cpu"][0]))
    delta_err = {}
    for k, w in w0.items():
        d_card, d_cpu = runs["card"][1][k] - w, runs["cpu"][1][k] - w
        delta_err[k] = float((d_card - d_cpu).norm()
                             / d_cpu.norm().clamp_min(1e-30))
    del card_ref, cpu_model, runs
    gc.collect()
    emit({"phase": "word_lm_reference", "card": card, "tf32": False,
          "vocab": vocab, "params": n_params, "cpu_seconds_2_steps": cpu_s,
          "loss_max_rel_err": loss_err, "delta_max_rel_err":
          max(delta_err.values()), "delta_rel_err": delta_err})
    if not loss_err <= 1e-5 or not max(delta_err.values()) <= 1e-3:
        fail(f"word_lm: card against CPU: loss {loss_err}, deltas "
             f"{delta_err}")
    # gate 2: 25 steps at the process's TF32 settings
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    loop = _WordLMLoop(mx, model, stream, gpu, SEED + 191)
    losses = [float(loop.step().asnumpy()) for _ in range(5)]
    if not all(np.isfinite(losses)) or not max(losses[1:]) < losses[0]:
        fail(f"word_lm: the loss over the first 5 steps: {losses}")
    timed = 20
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_word_lm_counts()
    t1 = time.perf_counter()
    for _ in range(timed):
        last = loop.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / timed
    counts = _word_lm_counts()
    peak = torch.cuda.max_memory_allocated()
    losses.append(float(last.asnumpy()))
    want = {"hash_dropout": 3 * timed, "hash_dropout_bwd": 3 * timed,
            "fused_sgd_sweep": timed, "cudnn_rnn_layer": 2 * timed}
    if counts != want:
        fail(f"word_lm: launches over {timed} steps {counts}, want {want}")
    breakdown = _device_breakdown(loop.step, 5, n_top=10, kind=_rnn_kind)
    # the CE head alone: the loss forward and backward on the step's logits
    logits = torch.randn(batch * bptt, vocab, device="cuda",
                         requires_grad=True)
    labels = torch.from_numpy(stream[1:bptt + 1].reshape(-1)).cuda()

    def ce():
        loop.loss_fn(logits, labels).mean().backward()

    ce_ms = _layer_ms(ce)
    # gate 3: predict through the hybridized LSTM
    hidden = model.rnn.begin_state(batch, ctx=gpu)
    evals = loop.segments[:4]

    def evaluate():
        h, outs = hidden, []
        for data, _ in evals:
            out, h = model(data, h)
            outs += [out] + list(h)
        return [o._data.detach().float().cpu() for o in outs]

    eager = evaluate()
    model.rnn.hybridize()
    before = prnn.cudnn_rnn_layer.launches
    first = evaluate()
    graph = model.rnn.cached_graph
    captures = graph.captures
    mid = prnn.cudnn_rnn_layer.launches
    again = evaluate()
    per_replay = (prnn.cudnn_rnn_layer.launches - mid) / len(evals)
    same = all(torch.equal(a, b) for a, b in zip(eager, first)) and all(
        torch.equal(a, b) for a, b in zip(eager, again))
    model.rnn.hybridize(False)
    tokens = batch * bptt
    emit({"phase": "word_lm", "card": card, "config": cfg,
          "reduced": [], "data": "Zipf(1) token stream over the vocabulary "
          "from SEED (no dataset in the repo)", "params": n_params,
          "tf32": tf32, "losses_first_5_and_last": losses,
          "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
          "launches_per_step": {k: v / timed for k, v in counts.items()},
          "peak_memory_bytes": peak, "ce_head_fwd_bwd_ms": ce_ms,
          **breakdown,
          "eval_graph_equals_eager": same, "eval_captures": captures,
          "eval_captures_after": graph.captures,
          "eval_cudnn_calls_first_pass": mid - before,
          "eval_cudnn_calls_per_replay": per_replay,
          "seconds": time.perf_counter() - t0})
    if not same or captures != 1 or graph.captures != 1 \
            or per_replay != 2:
        fail(f"word_lm: hybridized eval: equal {same}, captures "
             f"{captures} then {graph.captures}, {per_replay} cuDNN calls "
             "per replay")
    return {k: counts[k] for k in ("hash_dropout", "hash_dropout_bwd",
                                   "fused_sgd_sweep")}


# ---------------------------------------------------------------------------
# 17k-17m. the vision zoo: the new ops and families against the CPU,
# MobileNet v2 training at full width, Inception v3 serving
# ---------------------------------------------------------------------------

# get_model's families at batch 2 and their published input sizes
VISION_FAMILIES = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
                   ("densenet121", 224), ("inceptionv3", 299),
                   ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
                   ("mobilenetv3_large", 224))
# SGD for mobilenetv2_1.0 (the batch and rate are the issue's choice, the
# widths and depth the published model's)
MOBILENET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 4e-5,
                 "multi_precision": True}


def _redraw(net, gen) -> None:
    """Every parameter of ``net`` drawn anew from ``gen`` on its device:
    gammas near 1, positive running variances, small betas, means and
    biases, He-scaled weights, so activations stay of order 1 through
    any depth."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            _fill(name, p, gen)
        for name, b in net.named_buffers():
            _fill(name, b, gen)


def _fill(name, t, gen) -> None:
    r = torch.randn(t.shape, generator=gen, device=t.device)
    if name.endswith("gamma"):
        v = 1.0 + 0.1 * r
    elif name.endswith("running_var"):
        v = 1.0 + 0.5 * torch.rand(t.shape, generator=gen, device=t.device)
    elif name.endswith(("beta", "running_mean", "bias")):
        v = 0.1 * r
    else:
        v = r * (2.0 / max(t[0].numel(), 1)) ** 0.5
    t.copy_(v.to(t.dtype))


def _rel(a, b) -> float:
    """max |a - b| over max |b|, in f64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _vision_family(mx, name, size, rs, tmp) -> dict:
    """One family: built NHWC on the card from the seed, its weights
    written to a .params file and read by an NCHW build on the CPU; the
    card's forward of a batch of 2 against the CPU's, then the
    hybridized graph of the card's NDArray call against its eager call,
    bit for bit, with one capture and no recapture on a second call."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    net = get_model(name, layout="NHWC", ctx=mx.gpu(0))
    with torch.no_grad():
        net(torch.zeros(1, 3, size, size, device="cuda"))
    _redraw(net, gen)
    path = f"{tmp}/{name}.params"
    net.save_parameters(path)
    cpu_net = get_model(name, ctx=mx.cpu())
    cpu_net.load_parameters(path, ctx=mx.cpu())
    x = rs.rand(2, 3, size, size).astype(np.float32)
    with torch.no_grad():
        ref = cpu_net(torch.from_numpy(x))
        got = net(torch.from_numpy(x).cuda())
    xn = mx.nd.array(x, ctx=mx.gpu(0))
    eager = net(xn)._data.clone()
    net.hybridize()
    first = net(xn)._data.clone()
    second = net(xn)._data.clone()
    captures = net.cached_graph.captures
    rec = {"input": [2, 3, size, size], "card_vs_cpu": _rel(got, ref),
           "graph_equals_eager_bits": bool(torch.equal(first, eager)
                                           and torch.equal(second, eager)),
           "captures": captures,
           "params": sum(p.numel() for p in net.parameters())}
    del net, cpu_net
    return rec


def _op_cases(mx) -> dict:
    """The new ops on the card against the CPU, f32, each output and
    gradient's error relative to its largest magnitude: 1-D/3-D,
    grouped, depthwise and dilated convolutions and Deconvolution with
    their data, weight and bias gradients, every pooling convention and
    type, UpSampling (nearest and bilinear), BilinearResize2D
    (antialiased downscale and upscale), AdaptiveAvgPooling2D."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import spatial

    rs = np.random.RandomState(SEED + 12)

    def arr(*shape):
        return rs.randn(*shape).astype(np.float32)

    conv = ops_nn.convolution
    deconv = ops_nn.deconvolution
    cases = {
        "conv1d_dilated_NWC": (conv, [arr(4, 50, 16), arr(32, 16, 5),
                                      arr(32)],
                               dict(kernel=(5,), pad=(4,), dilate=(2,),
                                    num_filter=32, layout="NWC")),
        "conv2d_grouped_dilated": (conv, [arr(4, 32, 20, 20),
                                          arr(32, 8, 3, 3), arr(32)],
                                   dict(kernel=(3, 3), pad=(2, 2),
                                        dilate=(2, 2), num_group=4,
                                        num_filter=32)),
        "conv2d_depthwise_NHWC": (conv, [arr(4, 28, 28, 96),
                                         arr(96, 1, 3, 3), arr(96)],
                                  dict(kernel=(3, 3), stride=(2, 2),
                                       pad=(1, 1), num_group=96,
                                       num_filter=96, layout="NHWC")),
        "conv3d_NCDHW": (conv, [arr(2, 8, 8, 16, 16), arr(16, 8, 3, 3, 3),
                                arr(16)],
                         dict(kernel=(3, 3, 3), pad=(1, 1, 1),
                              num_filter=16)),
        "conv3d_grouped_NDHWC": (conv, [arr(2, 8, 16, 16, 8),
                                        arr(16, 4, 1, 3, 3), arr(16)],
                                 dict(kernel=(1, 3, 3), stride=(1, 2, 2),
                                      pad=(0, 1, 1), num_group=2,
                                      num_filter=16, layout="NDHWC")),
        "deconv1d": (deconv, [arr(4, 16, 30), arr(16, 8, 4), arr(8)],
                     dict(kernel=(4,), stride=(2,), pad=(1,), adj=(1,),
                          num_filter=8, no_bias=False)),
        "deconv2d_grouped_NHWC": (deconv, [arr(2, 12, 13, 16),
                                           arr(16, 4, 3, 4), arr(8)],
                                  dict(kernel=(3, 4), stride=(2, 2),
                                       pad=(1, 1), num_group=2,
                                       num_filter=8, no_bias=False,
                                       layout="NHWC")),
        "deconv3d_dilated": (deconv, [arr(2, 4, 5, 6, 6),
                                      arr(4, 6, 3, 3, 3), arr(6)],
                             dict(kernel=(3, 3, 3), stride=(1, 2, 2),
                                  dilate=(2, 1, 1), num_filter=6,
                                  no_bias=False)),
        "upsampling_nearest_concat": (
            spatial.upsampling, [arr(2, 8, 14, 14), arr(2, 8, 7, 7)],
            dict(scale=2, num_args=2)),
        "upsampling_bilinear": (
            spatial.upsampling, [arr(2, 8, 14, 14),
                                 np.abs(arr(8, 1, 4, 4))],
            dict(scale=2, sample_type="bilinear", num_args=2)),
        "bilinear_resize_down": (spatial.bilinear_resize_2d,
                                 [arr(2, 8, 64, 64)],
                                 dict(height=23, width=37)),
        "bilinear_resize_up": (spatial.bilinear_resize_2d,
                               [arr(2, 8, 16, 16)],
                               dict(height=45, width=40)),
        "adaptive_avg_pool": (spatial.adaptive_avg_pooling_2d,
                              [arr(2, 8, 29, 31)],
                              dict(output_size=(7, 5))),
    }
    pools = {
        "max_valid_NHWC": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               layout="NHWC"),
        "max_full": dict(kernel=(3, 3), stride=(2, 2),
                         pooling_convention="full"),
        "max_same_1d": dict(kernel=(3,), stride=(2,),
                            pooling_convention="same"),
        "avg_full": dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                         pooling_convention="full"),
        "avg_exclude_pad_3d": dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                   pad=(1, 1, 1), pool_type="avg",
                                   count_include_pad=False),
        "sum_same": dict(kernel=(2, 3), stride=(2, 2), pool_type="sum",
                         pooling_convention="same"),
        "lp2_NDHWC": dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                          pool_type="lp", p_value=2, layout="NDHWC"),
        "global_lp3": dict(kernel=(1, 1), pool_type="lp", p_value=3,
                           global_pool=True),
    }
    for key, kw in pools.items():
        nd = len(kw["kernel"])
        shape = {1: (4, 16, 33), 2: (4, 16, 33, 35),
                 3: (2, 8, 9, 12, 13)}[nd]
        if kw.get("layout", "").endswith("C"):
            shape = (shape[0],) + shape[2:] + (shape[1],)
        cases["pool_" + key] = (ops_nn.pooling, [arr(*shape)],
                                dict(pool_type=kw.pop("pool_type", "max"),
                                     **kw))
    out = {}
    for key, (fn, arrays, kw) in cases.items():
        got = {}
        for dev in ("cuda", "cpu"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in arrays]
            y = fn(*ts, **kw)
            dy = torch.from_numpy(np.random.RandomState(1).randn(
                *y.shape).astype(np.float32)).to(dev)
            y.backward(dy)
            got[dev] = [y] + [t.grad for t in ts]
        out[key] = max(_rel(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    return out


def _conv_lstm_case(mx) -> dict:
    """A Conv2DLSTMCell (hidden 32, 5x5 kernels, i2h padded to keep the
    64x64 frame) unrolled 10 steps over a batch of 4 one-channel frames,
    card against CPU from the same weights: the outputs, the last states
    and every parameter's gradient of a weighted sum of the outputs,
    relative to each one's largest magnitude."""
    from mxnet_tpu_torch.gluon.contrib.rnn import Conv2DLSTMCell

    rs = np.random.RandomState(SEED + 13)
    xs = rs.rand(10, 4, 1, 64, 64).astype(np.float32)
    head = rs.randn(10, 4, 32, 64, 64).astype(np.float32)
    got = {}
    weights = None
    for dev, ctx in (("cuda", mx.gpu(0)), ("cpu", mx.cpu())):
        cell = Conv2DLSTMCell((1, 64, 64), 32, i2h_kernel=5, h2h_kernel=5,
                              i2h_pad=2)
        cell.initialize(ctx=ctx)
        params = cell.collect_params()
        if weights is None:
            weights = [0.1 * rs.randn(*p.shape).astype(np.float32)
                       for p in params.values()]
        for p, w in zip(params.values(), weights):
            p.set_data(w)
        with mx.autograd.record():
            outs, states = cell.unroll(
                10, mx.nd.array(xs, ctx=ctx), layout="TNC",
                merge_outputs=True)
            loss = (outs * mx.nd.array(head, ctx=ctx)).sum()
        loss.backward()
        got[dev] = ([outs._data] + [s._data for s in states],
                    [p.grad()._data for p in params.values()])
    return {"outputs_and_states": max(_rel(a, b) for a, b in zip(
                got["cuda"][0], got["cpu"][0])),
            "gradients": max(_rel(a, b) for a, b in zip(
                got["cuda"][1], got["cpu"][1]))}


def _mobilenet_reference(mx) -> dict:
    """Three TrainStep SGD steps (lr 1e-3, momentum 0.9) of
    mobilenet_v2_0_25(classes=10, layout="NHWC") at 64x64, batch 4, from
    one set of weights: in f64 on the CPU, which records its ReLU6
    decisions (_Decisions), then in f32 on the card and in f32 on the
    CPU, both replaying them. Each f32 run's distance from the f64 one
    (each step's loss, relative; every running statistic after each
    step, as a multiple of 1e-5 + 1e-5 |f64|; each parameter's delta by
    norm ratio; the replayed decisions it would have taken otherwise),
    and the card's distance from the CPU's f32 run beside them."""
    import copy

    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet_v2_0_25

    steps, opt = 3, {"learning_rate": 1e-3, "momentum": 0.9}
    card_net = mobilenet_v2_0_25(classes=10, layout="NHWC", ctx=mx.gpu(0))
    with torch.no_grad():
        card_net(torch.zeros(1, 3, 64, 64, device="cuda"))
    _redraw(card_net, torch.Generator(device="cuda").manual_seed(SEED + 9))
    cpu_net = copy.deepcopy(card_net).cpu()
    f64_net = copy.deepcopy(cpu_net).double()
    w0 = {k: v.detach().double().cpu().clone()
          for k, v in card_net.named_parameters()}
    rs = np.random.RandomState(SEED + 9)
    x = rs.rand(4, 3, 64, 64)
    y = rs.randint(0, 10, (4,)).astype(np.float64)
    decisions = _Decisions()
    losses, stats, nets, disagree = {}, {}, {}, {}
    for name, net, dt in (("f64", f64_net, np.float64),
                          ("card", card_net, np.float32),
                          ("cpu", cpu_net, np.float32)):
        step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     optimizer_params=dict(opt))
        _reset_train_counts()
        decisions.disagreements = decisions.elements = 0

        def run():
            return [(float(step(x.astype(dt), y.astype(dt))[0]),
                     _running_stats(net)) for _ in range(steps)]

        got = decisions.run("record" if name == "f64" else "replay", run)
        losses[name] = [g[0] for g in got]
        stats[name] = [{k: v.double() for k, v in g[1].items()}
                       for g in got]
        nets[name] = {k: v.detach().double().cpu()
                      for k, v in net.named_parameters()}
        disagree[name] = decisions.disagreements
        if name == "card":
            launches = _train_counts()
            buckets = len(step._buckets)
    replayed = decisions.elements

    def distance(a, b) -> dict:
        loss = max(abs(p - q) / abs(q) for p, q in zip(losses[a],
                                                       losses[b]))
        stat = max(float(((u[k] - v[k]).abs()
                          / (1e-5 + 1e-5 * v[k].abs())).max())
                   for u, v in zip(stats[a], stats[b]) for k in u)
        ratios, still = {}, 0.0
        for key, start in w0.items():
            da = (nets[a][key] - start).flatten()
            db = (nets[b][key] - start).flatten()
            if key.endswith(".out.7.beta"):
                # feeds a 1x1 convolution and a train-mode BatchNorm,
                # which removes any per-channel shift: its true gradient
                # is 0, and both move by rounding alone
                still = max(still, float(da.abs().max()))
                continue
            ratios[key] = float((da - db).norm()) / float(db.norm())
        worst = max(ratios, key=ratios.get)
        return {"loss_max_rel": loss, "running_stats_over_limit": stat,
                "delta_worst": [worst, ratios[worst]],
                "delta_median": float(np.median(list(ratios.values()))),
                "zero_gradient_betas_max_move": still}

    want = {k: v * steps for k, v in _resnet_per_step(buckets).items()}
    return {"model": "mobilenet_v2_0_25(classes=10, layout='NHWC')",
            "batch": [4, 3, 64, 64], "optimizer": opt, "losses": losses,
            "card_vs_f64": distance("card", "f64"),
            "cpu_vs_f64": distance("cpu", "f64"),
            "card_vs_cpu": distance("card", "cpu"),
            "decisions_replayed": replayed,
            "decision_disagreements": {k: disagree[k]
                                       for k in ("card", "cpu")},
            "launches": launches, "launches_expected": want}


def _within_twice_the_cpus(t) -> list:
    """The limits the card's f32 run misses: each distance from the f64
    run at most phase 14's limit (loss 1e-5, statistics 1e-5 + 1e-5
    |ref|, deltas 1e-3, disagreements 1e-5 of those replayed) or twice
    the CPU f32 run's own, whichever is larger; the zero-gradient betas
    under 1e-5."""
    card, cpu = t["card_vs_f64"], t["cpu_vs_f64"]
    missed = []
    if card["loss_max_rel"] > max(1e-5, 2 * cpu["loss_max_rel"]):
        missed.append("loss")
    if card["running_stats_over_limit"] > max(
            1.0, 2 * cpu["running_stats_over_limit"]):
        missed.append("running statistics")
    if card["delta_worst"][1] > max(1e-3, 2 * cpu["delta_worst"][1]):
        missed.append("deltas")
    if card["zero_gradient_betas_max_move"] >= 1e-5:
        missed.append("zero-gradient betas")
    dis = t["decision_disagreements"]
    if dis["card"] > max(1e-5 * t["decisions_replayed"], 2 * dis["cpu"]):
        missed.append("decisions")
    if not all(np.isfinite(t["losses"]["card"])):
        missed.append("finite loss")
    if t["launches"] != t["launches_expected"]:
        missed.append("launches")
    return missed


def _alexnet_dropout(mx) -> dict:
    """One train-mode TrainStep of alexnet(classes=10) at 224 (batch 2)
    on the card and on the CPU from one seed: each Dropout's seed and p
    recorded; the card's kernel and the CPU's plain version give the
    same mask at each site's shape and seed, bit for bit; the card's
    step launches exactly 2 hash_dropout and 2 hash_dropout_bwd."""
    import copy

    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import alexnet
    from mxnet_tpu_torch.kernels import hash_dropout
    from mxnet_tpu_torch.ops import nn as ops_nn

    card_net = alexnet(classes=10, layout="NHWC", ctx=mx.gpu(0))
    with torch.no_grad():
        card_net(torch.zeros(1, 3, 224, 224, device="cuda"))
    _redraw(card_net, torch.Generator(device="cuda").manual_seed(SEED + 14))
    cpu_net = copy.deepcopy(card_net).cpu()
    rs = np.random.RandomState(SEED + 14)
    x = rs.rand(2, 3, 224, 224).astype(np.float32)
    y = rs.randint(0, 10, (2,)).astype(np.float32)
    sites, orig = {}, ops_nn.hash_dropout
    losses = {}
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        calls = sites.setdefault(name, [])

        def recording(data, p, seed, axes=(), calls=calls):
            calls.append((tuple(data.shape), float(p), int(seed)))
            return orig(data, p, seed, axes)

        step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     optimizer_params={"learning_rate": 0.01})
        mx.random.seed(SEED + 14, ctx=step._device)
        ops_nn.hash_dropout = recording
        _reset_train_counts()
        try:
            losses[name] = float(step(x, y)[0])
        finally:
            ops_nn.hash_dropout = orig
        launches = _train_counts()             # the card's, read last
    same_masks = len(sites["card"]) == 2 and sites["card"] == sites["cpu"]
    for shape, p, seed in sites["card"]:
        ones = torch.ones(shape)
        a = hash_dropout(ones.cuda(), p, seed).cpu()
        b = hash_dropout(ones, p, seed)
        same_masks &= bool(torch.equal(a, b))
    return {"sites": sites["card"], "masks_equal_bits": bool(same_masks),
            "losses": losses,
            "launches": {k: launches[k] for k in (
                "hash_dropout", "hash_dropout_bwd", "fused_sgd_sweep")}}


def phase_vision_reference(card: str) -> dict:
    """The vision zoo in f32 with TF32 off (restored after): every
    family through get_model at batch 2 and its published input (224;
    299 for inceptionv3), card (NHWC) against the CPU (NCHW, the same
    .params), to 1e-4 of the largest logit, and the hybridized graph
    against eager bit for bit with one capture; three TrainStep SGD steps
    of mobilenet_v2_0_25 in f32 on the card and on the CPU, both
    replaying the ReLU6 decisions of the same steps in f64 on the CPU,
    the card no farther from the f64 run than phase 14's limits or twice
    the CPU's f32 run, whichever is larger (_within_twice_the_cpus: the
    17 bottlenecks' train-mode BatchNorms over 16 values a channel at
    the last stages carry f32 rounding far past phase 14's limits on
    either device); one AlexNet training step with
    the CPU's dropout seeds (2 + 2 hash-dropout launches, masks bit for
    bit); the new ops card against CPU to 1e-5 of the largest magnitude;
    a Conv2DLSTMCell over 10 steps, outputs to 1e-5 and gradients to
    1e-4."""
    import tempfile

    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    prev = _tf32(False)
    rs = np.random.RandomState(SEED + 10)
    families = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, size in VISION_FAMILIES:
            t1 = time.perf_counter()
            families[name] = _vision_family(mx, name, size, rs, tmp)
            families[name]["seconds"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
    ops = _op_cases(mx)
    lstm = _conv_lstm_case(mx)
    train = _mobilenet_reference(mx)
    drop = _alexnet_dropout(mx)
    _restore_tf32(prev)
    out = {"phase": "vision_reference", "card": card, "dtype": "float32",
           "families": families, "family_tol": 1e-4, "ops": ops,
           "ops_tol": 1e-5, "conv2d_lstm": lstm,
           "conv2d_lstm_tol": {"outputs_and_states": 1e-5,
                               "gradients": 1e-4},
           "mobilenet_v2_train": train, "alexnet_dropout": drop,
           "seconds": time.perf_counter() - t0}
    emit(out)
    for name, rec in families.items():
        if not rec["card_vs_cpu"] <= 1e-4:
            fail(f"vision_reference: {name} on the card is "
                 f"{rec['card_vs_cpu']} of its largest logit from the CPU")
        if not rec["graph_equals_eager_bits"] or rec["captures"] != 1:
            fail(f"vision_reference: {name}'s graph ({rec['captures']} "
                 "captures) does not give the eager forward bit for bit")
    bad = {k: v for k, v in ops.items() if not v <= 1e-5}
    if bad:
        fail(f"vision_reference: ops on the card miss the CPU: {bad}")
    if not (lstm["outputs_and_states"] <= 1e-5
            and lstm["gradients"] <= 1e-4):
        fail(f"vision_reference: Conv2DLSTMCell on the card: {lstm}")
    missed = _within_twice_the_cpus(train)
    if missed:
        fail(f"vision_reference: MobileNet v2 training on the card misses "
             f"{missed}: {train}")
    if not drop["masks_equal_bits"] or drop["launches"]["hash_dropout"] != 2 \
            or drop["launches"]["hash_dropout_bwd"] != 2:
        fail(f"vision_reference: AlexNet's dropout: {drop}")
    torch.cuda.empty_cache()
    return drop["launches"]


def _queued_glue_ms(fn, flush):
    """_queued_ms over 10 calls: the calls queued behind a sleep kernel,
    so a small shape's event pair times the card, not the host's
    autograd."""
    return _queued_ms(fn, flush, iters=10, warmup=2)


def _depthwise(m) -> bool:
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    return isinstance(m, _Conv) and m._kwargs["num_group"] > 1


def _conv_fwd_bwd(mod, x):
    from mxnet_tpu_torch.ops import nn as ops_nn

    w = mod.weight.tensor.detach().clone().requires_grad_()
    kw = dict(mod._kwargs)

    def run():
        out = ops_nn.convolution(x, w, None, no_bias=True, **kw)
        torch.autograd.grad(out, (x, w), torch.ones_like(out))

    return run


def _relu6_fwd_bwd(mod, x):
    from mxnet_tpu_torch.ops.elemwise import clip

    def run():
        out = clip(x, a_min=0, a_max=6)
        torch.autograd.grad(out, x, torch.ones_like(out))

    return run


def _mobilenet_kind(name) -> str:
    """_resnet_kind, with cuDNN's depthwise convolution kernels apart
    (``conv2d_c1_k1_nhwc``, ``dgrad2d_c1_k1_nhwc``, ``wgrad2d_c1_k1_nhwc``:
    one input channel and one filter a group)."""
    low = name.lower()
    if "c1_k1" in low or "depthwise" in low:
        return "depthwise_conv"
    return _resnet_kind(name)


def phase_mobilenet_train(card: str) -> dict:
    """mobilenetv2_1.0(layout="NHWC") at its published widths and depth
    (1000 classes, 3.50M parameters), bf16 with f32 BatchNorm, seeded
    random weights, SoftmaxCrossEntropyLoss, SGD at lr 0.1, momentum 0.9,
    wd 4e-5, multi-precision: one (128, 3, 224, 224) batch of
    RandomState(0) images with float labels, 3 warm-up and 20 timed
    TrainStep calls, cuDNN's autotuner on (restored after). The loss
    must be finite and fall strictly over the first three steps; the
    second step must follow the update rule by hand (_sgd_rule_excess);
    every running statistic must move; exactly one SGD sweep per dtype
    bucket (2) per step and no other training kernel; the counted
    multiply-adds within 5% of Sandler et al.'s 300M per image. Printed:
    ms per step, images/s, MFU, peak memory, host and device ms and the
    idle share, device ms by kind, and the depthwise convolutions',
    BatchNorms' and ReLU6s' own device ms per step."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet as mnet

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, timed_steps = 128, 20
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    mx.random.seed(SEED)
    net = mnet.mobilenet_v2_1_0(layout="NHWC", dtype=torch.bfloat16,
                                ctx=mx.gpu(0))
    macs = _macs_per_image(net)
    step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 optimizer_params=dict(MOBILENET_OPT))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(np.float32)) \
        .cuda()
    stats0 = _running_stats(net)
    warm = [float(step(x, y)[0])]
    before = _masters_and_momenta(step)
    warm.append(float(step(x, y)[0]))
    rule = _sgd_rule_excess(step, before, MOBILENET_OPT)
    del before
    warm.append(float(step(x, y)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step(x, y)[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + [float(v) for v in timed]
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in _running_stats(net).items())
    per_step = _resnet_per_step(len(step._buckets))
    want = {k: v * timed_steps for k, v in per_step.items()}
    flops = 6.0 * macs
    images_s = batch * timed_steps / wall
    out = {"phase": "mobilenet_train", "card": card,
           "model": "mobilenetv2_1.0(layout='NHWC')",
           "dtype": "bfloat16, f32 BatchNorm, multi-precision sgd",
           "optimizer": MOBILENET_OPT,
           "params": sum(p.numel() for p in net.parameters()),
           "batch": [batch, 3, 224, 224], "steps": timed_steps,
           "cudnn_benchmark": True,
           "ms_per_step": wall * 1e3 / timed_steps,
           "images_per_s": images_s, "macs_per_image": macs,
           "macs_vs_300M": macs / 300e6, "flops_per_image": flops,
           "mfu": flops * images_s / 989e12, "peak_mem_gib": peak,
           "losses": losses, "running_stats_moved": [moved, len(stats0)],
           "update_rule_step2": rule,
           "launches": launches, "launches_expected": want,
           "launches_per_step": per_step,
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step(x, y), 2,
                                              n_top=16, kind=_mobilenet_kind)
    out["depthwise_conv"] = _shape_glue_ms(net, x, _depthwise,
                                           _conv_fwd_bwd, _queued_glue_ms)
    out["relu6_glue"] = _shape_glue_ms(
        net, x, lambda m: isinstance(m, mnet.ReLU6), _relu6_fwd_bwd,
        _queued_glue_ms)
    out["bn_glue"] = _bn_glue_ms(net, x, timer=_queued_glue_ms)
    out["seconds"] = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = bench
    emit(out)
    if not all(np.isfinite(losses)) \
            or not losses[0] > losses[1] > losses[2]:
        fail(f"bf16 MobileNet v2 training loss is not finite or did not "
             f"fall over the first three steps: {losses}")
    if rule["worst_excess"] > 1.0 or not rule["bf16_is_master_rounded"]:
        fail(f"MobileNet v2's second SGD step broke its update rule: {rule}")
    if moved != len(stats0):
        fail(f"only {moved} of {len(stats0)} BatchNorm running statistics "
             "moved")
    if launches != want or per_step["fused_sgd_sweep"] != 2:
        fail(f"MobileNet v2 training launch counts {launches} are not "
             f"{want} ({per_step} per step)")
    if abs(macs / 300e6 - 1.0) > 0.05:
        fail(f"MobileNet v2 counts {macs} multiply-adds per image, not "
             "within 5% of 300M")
    if not isinstance(net.output[0], gnn.Conv2D):
        fail("MobileNet v2's classifier is not its 1x1 convolution")
    del step, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_vision_serve(card: str) -> dict:
    """The hybridized inceptionv3(layout="NHWC") predict in bf16 at (32,
    3, 299, 299), seeded random weights, NDArrays on the card: the eager
    forward first, then the graph: its first call (the capture) and 20
    replays equal to the eager forward bit for bit, one capture and none
    after. Printed: host and device ms per forward and the idle share,
    graph and eager, images/s through the graph, the top device
    events."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import inception_v3

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = 32
    mx.random.seed(SEED + 15)
    net = inception_v3(layout="NHWC", dtype=torch.bfloat16, ctx=mx.gpu(0))
    rs = np.random.RandomState(SEED + 15)
    x = mx.nd.array(rs.rand(batch, 3, 299, 299).astype(np.float32),
                    ctx=mx.gpu(0), dtype="bfloat16")
    with torch.no_grad():
        net(x._data[:1])                       # settle the deferred shapes
    eager = net(x)._data.clone()

    def fwd():
        net(x)

    eager_times = _device_breakdown(fwd, 10)
    net.hybridize(static_alloc=True, static_shape=True)
    first = net(x)._data.clone()
    same = torch.equal(first, eager)
    replays = 20
    for _ in range(replays):
        same &= torch.equal(net(x)._data, eager)
    captures = net.cached_graph.captures
    graph_times = _device_breakdown(fwd, 10, n_top=10)
    out = {"phase": "vision_serve", "card": card,
           "model": "inceptionv3(layout='NHWC')", "dtype": "bfloat16",
           "batch": [batch, 3, 299, 299],
           "params": sum(p.numel() for p in net.parameters()),
           "graph_equals_eager_bits": bool(same), "captures": captures,
           "replays": replays,
           "graph": {k: graph_times[k] for k in (
               "host_ms_per_step", "device_ms_per_step",
               "device_idle_share", "top_device_ms_per_step",
               "device_ms_per_step_by_kind")},
           "eager": {k: eager_times[k] for k in (
               "host_ms_per_step", "device_ms_per_step",
               "device_idle_share")},
           "images_per_s": batch * 1e3 / graph_times["host_ms_per_step"],
           "finite": bool(torch.isfinite(eager.float()).all())}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not same or captures != 1 or net.cached_graph.captures != 1:
        fail(f"vision_serve: graph = eager {same}, {captures} captures")
    if not out["finite"] or tuple(eager.shape) != (batch, 1000):
        fail(f"vision_serve: output {tuple(eager.shape)}, finite "
             f"{out['finite']}")
    del net, x
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# SSD: the box ops, the MultiBox ops, the box_nms kernel, training and
# detection (ssd_reference, ssd_train, ssd_detect)
# ---------------------------------------------------------------------------

# the convolution biases that feed a batch-statistics BatchNorm: their
# gradient is 0 up to rounding, so Adam's first steps there are the sign
# of that rounding on either device
SSD_BIAS_BEFORE_BN = ("trunk.0.bias", "trunk.3.bias", "trunk.6.bias",
                      "stage1.0.bias", "stage2.0.bias")
SSD_LR = 1e-3


def _nms_rows(seed, n=60, lead=(2,), fmt="corner", ids=3):
    """(*lead, n, 6) rows [id, score, box] whose boxes cluster; scores
    with ties, +-0 and NaN; ids shared and distinct (the generator of
    tests/test_torch_cuda_ssd.py)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(int(np.prod(lead))):
        centers = rs.rand(5, 2) * 0.6 + 0.2
        a = (centers[rs.randint(0, 5, n)] + rs.randn(n, 2) * 0.04) \
            .astype(np.float32)
        size = (0.15 + rs.rand(n, 2) * 0.1).astype(np.float32)
        boxes = np.concatenate([a, size] if fmt == "center"
                               else [a - size / 2, a + size / 2], axis=1)
        score = np.round(rs.rand(n), 1).astype(np.float32)
        score[::9] = 0.0
        score[4::9] = -0.0
        score[7::17] = np.nan
        score[2::19] = -0.25
        cls = rs.randint(0, ids, n).astype(np.float32)
        cls[11::23] = -1.0
        out.append(np.concatenate([cls[:, None], score[:, None], boxes],
                                  axis=1))
    return np.stack(out).reshape(tuple(lead) + (n, 6)).astype(np.float32)


def _sorted_nms_rows(rows, topk=-1):
    """The box_nms op's glue: each image's rows sorted by score (stable),
    cut to the first topk; returns (sorted (B, m, 6), n)."""
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, k = flat.shape[1:]
    m = n if topk <= 0 else min(n, topk)
    order = torch.argsort(-flat[..., 1], dim=-1, stable=True)
    return flat.gather(1, order[:, :m, None].expand(-1, -1, k)) \
        .contiguous(), n


def _nan_same(a, b) -> bool:
    """Bit for bit with NaN equal to NaN (the sign of a zero counts)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _ssd_scene(batch, size, classes, seed, max_boxes=8):
    """Seeded images of ``batch`` x 3 x ``size`` x ``size`` with 1 to
    ``max_boxes`` filled rectangles each, the colour its class's, over
    noise; labels (batch, max_boxes, 5) [cls, x1, y1, x2, y2] in [0, 1],
    padded with -1."""
    rs = np.random.RandomState(seed)
    palette = rs.rand(classes, 3).astype(np.float32)
    x = (rs.rand(batch, 3, size, size) * 0.3).astype(np.float32)
    labels = np.full((batch, max_boxes, 5), -1.0, np.float32)
    for b in range(batch):
        for j in range(rs.randint(1, max_boxes + 1)):
            c = rs.randint(classes)
            w, h = rs.uniform(0.1, 0.5, 2)
            x1, y1 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            c0, r0 = int(x1 * size), int(y1 * size)
            c1, r1 = int((x1 + w) * size), int((y1 + h) * size)
            x[b, :, r0:r1, c0:c1] = palette[c][:, None, None]
            labels[b, j] = [c, c0 / size, r0 / size, c1 / size, r1 / size]
    return x, labels


def _nms_detect_rows(device="cuda"):
    """SSD detect's box_nms input as nms_case times it: (32, 7620, 6) rows
    [id, score, box] of _nms_rows's boxes over 20 classes (and -1), the
    scores drawn anew, uniform in [0, 1), -1 at or below 0.3."""
    batch, n = 32, 7620
    rows = torch.from_numpy(_nms_rows(SEED + 23, n=n, lead=(batch,),
                                      ids=20))
    score = torch.from_numpy(np.random.RandomState(SEED + 23).rand(
        batch, n).astype(np.float32))
    rows[..., 1] = torch.where(score > 0.3, score, -1.0)
    return rows.to(device)


# box_nms_sorted's keywords at SSD detect's (ssd.py's nms_thresh, and
# MultiBoxDetection's valid threshold and columns)
NMS_DETECT_KW = dict(overlap_thresh=0.45, valid_thresh=0.01, coord_start=2,
                     score_index=1, id_index=0)


def nms_case(flush, gen, topk=400) -> dict:
    """The box_nms kernels at SSD detect's rows (_nms_detect_rows;
    NMS_DETECT_KW: overlap 0.45, valid 0.01, per class) with detect's topk
    400 or the op's default topk=-1, against their plain version on the
    same sorted rows, bit for bit (at topk=-1 the plain version four
    images at a time); kernels per call (a graph capture's kernel nodes)
    as nms_plan states them: one at topk 400, two at topk=-1; the scratch
    a call allocates. ms: event pairs after the flush (time_ms, as every
    kernel's); device_ms: the same queued behind a sleep (_queued_ms),
    the card's time without the wrapper's host work. plain_ms: at topk
    400 time_ms over 5 calls; at topk=-1 the one plain call of the
    bit-for-bit check (eight calls of four images, ~4 s), timed once.
    Bound: the sorted rows read once and the (32, 7620, 6) output written
    once (f32), against the operations this run's rows need: 20 f32
    operations for each pair of valid rows of one class (i < j, both
    scores above valid_thresh: only those IoUs can change the output) and
    a class test for each valid pair; bound_ms_all_pairs counts 20 for
    every pair (i, j > i) of the m sorted rows instead. No single PyTorch
    call computes it (torchvision's nms is not installed, and it takes no
    classes, topk or -1 rows)."""
    from mxnet_tpu_torch.kernels import (box_nms_sorted,
                                         box_nms_sorted_reference, nms_plan)
    from mxnet_tpu_torch.kernels._build import kernels_per_call

    srt, n_out = _sorted_nms_rows(_nms_detect_rows(), topk)
    batch, m = srt.shape[:2]
    kw = NMS_DETECT_KW
    step = 4 if topk <= 0 else batch

    def plain():
        return torch.cat([box_nms_sorted_reference(srt[i:i + step], n_out,
                                                   **kw)
                          for i in range(0, batch, step)])

    def call():
        return box_nms_sorted(srt, n_out, **kw)

    got = call()
    if topk > 0:
        want = plain()
        plain_ms = time_ms(plain, flush, iters=5, warmup=1)
        plain_timing = "time_ms, 5 calls after 1"
    else:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        flush()
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        plain_timing = "one event pair: the checked call"
    same = _nan_same(got, want)
    del want
    twice = _nan_same(call(), got)
    per_call = kernels_per_call(call)
    plan = nms_plan(m, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - got.numel() * 4
    valid = srt[..., 1] > kw["valid_thresh"]
    n_valid = valid.sum(dim=1).double()
    # class c at column c + 2 (-1 too: it is a class of its own), the
    # invalid rows at column 0
    ids = torch.where(valid, srt[..., 0], -2.0).long() + 2
    per_id = torch.zeros(batch, int(ids.max()) + 1, dtype=torch.float64,
                         device=ids.device).scatter_add_(
        1, ids, valid.double())[:, 1:]
    same_class = float((per_id * (per_id - 1) / 2).sum())
    valid_pairs = float((n_valid * (n_valid - 1) / 2).sum())
    n_bytes = 4.0 * batch * 6 * (m + n_out)
    b_ms, b_by = bound(n_bytes, 20.0 * same_class + valid_pairs,
                       torch.float32)
    rec = {"phase": "kernels", "kernel": "box_nms",
           "shape": [batch, n_out, 6],
           "topk": topk, "dtype": "float32", "route": plan.route,
           "kept_per_image": float((got[..., 0] >= 0).sum()) / batch,
           "valid_rows_per_image": float(n_valid.mean()),
           "bit_identical": same, "same_bits_twice": twice,
           "kernels_per_call": per_call, "planned_kernels": plan.kernels,
           "scratch_bytes": scratch,
           "planned_scratch_bytes": plan.scratch_bytes,
           "max_abs_err": 0.0 if same else None,
           "ms": time_ms(call, flush), "device_ms": _queued_ms(call, flush),
           "plain_ms": plain_ms, "plain_timing": plain_timing,
           "library_ms": None,
           "library": "null (no single call: torchvision is not installed)",
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_ms_all_pairs": bound(
               n_bytes, 20.0 * batch * m * (m - 1) / 2, torch.float32)[0]}
    rec["ok"] = same and twice and per_call == plan.kernels
    emit(rec)
    return rec


def phase_ssd_reference(card: str) -> None:
    """ssd_toy(num_classes=3) at 64x64, batch 2, f32 with TF32 off, seeded
    random weights drawn on the card and carried to a CPU build by a
    .params file: the card's predict forward against the CPU's (each
    output within 1e-4 of its largest); then two record / targets /
    SSDMultiBoxLoss / backward / Trainer('adam').step steps on each
    device: cls_target and loc_mask equal, each loss within 1e-5
    relative, each trained parameter's delta over the two steps within
    1e-3 by norm ratio (the convolution biases that feed a BatchNorm,
    whose gradients are rounding, held to 1e-5 of the largest gradient
    instead; the running statistics, which absorb those biases, are
    not Adam's); then box_nms on the card, kernel against its plain version
    on the card and the op against the CPU's, bit for bit, over crafted
    rows (score ties, +-0 and NaN scores, shared and distinct ids,
    force_suppress, topk, the center format in and out, leading axes)."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import (box_nms_sorted,
                                         box_nms_sorted_reference)
    from mxnet_tpu_torch.ops import spatial

    t0 = time.perf_counter()
    prev = _tf32(False)
    x_np, lab_np = _ssd_scene(2, 64, 3, SEED + 21, max_boxes=4)
    mx.random.seed(SEED + 21)
    card_net = vision.ssd_toy(num_classes=3)
    card_net.initialize(ctx=mx.gpu(0))
    card_net(mx.nd.array(x_np, ctx=mx.gpu(0)))          # settle the shapes
    _redraw(card_net, torch.Generator(device="cuda").manual_seed(SEED + 21))
    with tempfile.TemporaryDirectory() as tmp:
        card_net.save_parameters(f"{tmp}/ssd.params")
        cpu_net = vision.ssd_toy(num_classes=3)
        cpu_net.load_parameters(f"{tmp}/ssd.params", ctx=mx.cpu())
    runs = {}
    for dev, net, ctx in (("card", card_net, mx.gpu(0)),
                          ("cpu", cpu_net, mx.cpu())):
        x, lab = mx.nd.array(x_np, ctx=ctx), mx.nd.array(lab_np, ctx=ctx)
        fwd = [o._data.cpu() for o in net(x)]
        loss_fn = vision.SSDMultiBoxLoss()
        trainer = Trainer(net.collect_params(), "adam",
                          {"learning_rate": SSD_LR})
        params = net._collect_params_with_prefix()
        w0 = {k: p.data()._data.detach().cpu().clone()
              for k, p in params.items()}
        losses, targets, grads = [], [], {}
        for _ in range(2):
            with autograd.record():
                an, cp, bp = net(x)
                lt, lm, ct = net.targets(an, lab, cp)
                loss = loss_fn(cp, bp, ct, lt, lm)
            loss.backward()
            for k in SSD_BIAS_BEFORE_BN:
                grads[k] = params[k].grad()._data.abs().max().item()
            grads["top"] = max(p.grad()._data.abs().max().item()
                               for p in params.values()
                               if p.grad_req != "null")
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
            targets.append((ct._data.cpu(), lm._data.cpu()))
        runs[dev] = dict(fwd=fwd, losses=losses, targets=targets,
                         grads=grads, deltas={
                             k: p.data()._data.detach().cpu() - w0[k]
                             for k, p in params.items()
                             if p.grad_req != "null"})
    on_card, on_cpu = runs["card"], runs["cpu"]
    fwd_err = [_rel(a, b) for a, b in zip(on_card["fwd"], on_cpu["fwd"])]
    loss_err = [abs(a - b) / abs(b) for a, b in zip(on_card["losses"],
                                                     on_cpu["losses"])]
    targets_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                        for a, b in zip(on_card["targets"],
                                        on_cpu["targets"]))
    delta_err = {k: float((on_card["deltas"][k] - d).norm()
                          / d.norm().clamp_min(1e-30))
                 for k, d in on_cpu["deltas"].items()
                 if k not in SSD_BIAS_BEFORE_BN}
    rounding = max(r["grads"][k] / r["grads"]["top"]
                   for r in (on_card, on_cpu) for k in SSD_BIAS_BEFORE_BN)
    _restore_tf32(prev)
    # box_nms over the crafted rows
    cases = {"per_class": dict(id_index=0), "one_class": dict(),
             "force": dict(id_index=0, force_suppress=True),
             "topk": dict(id_index=0, topk=17),
             "zeros_valid": dict(id_index=0, valid_thresh=-0.5),
             "center_in_out": dict(id_index=0, in_format="center",
                                   out_format="center", fmt="center"),
             "corner_to_center": dict(id_index=0, out_format="center"),
             "lead_axes": dict(id_index=0, lead=(2, 3), topk=25),
             "n_1000": dict(id_index=0, n=1000, lead=(3,)),
             "n_3000": dict(id_index=0, n=3000, lead=(2,))}
    nms = {}
    for name, kw in cases.items():
        kw = dict(kw)
        gen = {k: kw.pop(k) for k in ("fmt", "lead", "n") if k in kw}
        rows = torch.from_numpy(_nms_rows(len(name), **gen))
        srt, n = _sorted_nms_rows(rows.cuda(), kw.get("topk", -1))
        args = dict(overlap_thresh=kw.get("overlap_thresh", 0.5),
                    valid_thresh=kw.get("valid_thresh", 0.0),
                    coord_start=2, score_index=1,
                    id_index=-1 if kw.get("force_suppress")
                    else kw.get("id_index", -1),
                    in_format=kw.get("in_format", "corner"),
                    out_format=kw.get("out_format", "corner"))
        kernel = _nan_same(box_nms_sorted(srt, n, **args),
                           box_nms_sorted_reference(srt, n, **args))
        op = _nan_same(spatial.box_nms(rows.cuda(), **kw),
                       spatial.box_nms(rows, **kw))
        nms[name] = kernel and op
    out = {"phase": "ssd_reference", "card": card,
           "model": "ssd_toy(num_classes=3)", "batch": [2, 3, 64, 64],
           "dtype": "float32, TF32 off",
           "forward_rel_err": fwd_err, "losses_card": on_card["losses"],
           "losses_cpu": on_cpu["losses"], "loss_rel_err": loss_err,
           "targets_equal": targets_equal,
           "delta_rel_err_max": max(delta_err.values()),
           "delta_rel_err_worst": max(delta_err, key=delta_err.get),
           "bias_before_bn_grad_over_top": rounding,
           "box_nms_bits": nms, "seconds": time.perf_counter() - t0}
    emit(out)
    if max(fwd_err) > 1e-4 or max(loss_err) > 1e-5 or not targets_equal:
        fail(f"ssd_reference: forward {fwd_err}, loss {loss_err}, targets "
             f"equal {targets_equal}")
    if max(delta_err.values()) > 1e-3 or rounding > 1e-5:
        fail(f"ssd_reference: deltas {delta_err}, biases before BatchNorm "
             f"{rounding} of the largest gradient")
    if not all(nms.values()):
        fail(f"ssd_reference: box_nms on the card is not its plain "
             f"version: {nms}")


def _ssd_kind(name) -> str:
    low = name.lower()
    if "nms_" in name:
        return "box_nms_kernel"
    if any(k in low for k in ("sort", "radix", "scan")):
        return "sort_scan"
    return _kind(name)


def phase_ssd_train(card: str):
    """get_ssd(20, base="small"), the widest SSD the reference builds (a
    32/64/128 trunk, 64-channel stages, 3 scales of 4 anchors, VOC's 20
    classes: 7,620 anchors at 300x300), f32 parameters, seeded
    initialisation, trained through the eager Gluon path at batch 32:
    record, net(x), net.targets (hard-negative mining at 3),
    SSDMultiBoxLoss, backward, Trainer('adam', lr 1e-3).step. The data:
    seeded images with up to 8 filled rectangles of known class, labels
    (32, 8, 5) padded with -1. 3 warm-up and 10 timed steps: the loss
    finite and lower at the last step than at the first, exactly one
    Adam sweep per step and no box_nms. Printed: images/s, ms per step,
    host and device ms, idle share, device ms by kind, MultiBoxTarget's
    own host and device ms, peak memory. Returns (the Adam sweep's
    launches, the net, the batch) for ssd_detect."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import box_nms_sorted, fused_adam_sweep

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, timed_steps = 32, 10
    x_np, lab_np = _ssd_scene(batch, 300, 20, SEED + 22)
    mx.random.seed(SEED + 22)
    net = vision.get_ssd(20, base="small")
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.array(x_np, ctx=mx.gpu(0))
    lab = mx.nd.array(lab_np, ctx=mx.gpu(0))
    loss_fn = vision.SSDMultiBoxLoss()
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": SSD_LR})

    def step():
        with autograd.record():
            an, cp, bp = net(x)
            lt, lm, ct = net.targets(an, lab, cp)
            loss = loss_fn(cp, bp, ct, lt, lm)
        loss.backward()
        trainer.step(1)
        return loss

    losses = [float(step().asnumpy()) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_adam_sweep.launches = box_nms_sorted.launches = 0
    timed = []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"fused_adam_sweep": fused_adam_sweep.launches,
                "box_nms_sorted": box_nms_sorted.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(v.asnumpy()) for v in timed]
    with autograd.pause():
        an, cp, _ = net(x)
    anchors = an.shape[1]
    out = {"phase": "ssd_train", "card": card,
           "model": "get_ssd(20, base='small')", "dtype": "float32",
           "params": sum(p.numel() for p in net.parameters()),
           "anchors": anchors, "batch": [batch, 3, 300, 300],
           "boxes_per_image": float((lab_np[..., 0] >= 0).sum()) / batch,
           "optimizer": {"adam": {"learning_rate": SSD_LR}},
           "steps": timed_steps, "ms_per_step": wall * 1e3 / timed_steps,
           "images_per_s": batch * timed_steps / wall,
           "peak_mem_gib": peak, "losses": losses, "launches": launches}
    out["step_breakdown"] = _device_breakdown(step, 2, n_top=12,
                                              kind=_ssd_kind)
    tgt = _device_breakdown(lambda: net.targets(an, lab, cp), 5, n_top=6,
                            kind=_ssd_kind)
    out["multibox_target"] = {k: tgt[k] for k in (
        "host_ms_per_step", "device_ms_per_step", "device_idle_share",
        "top_device_ms_per_step")}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if anchors != 7620:
        fail(f"ssd_train: {anchors} anchors at 300x300, not 7,620")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"ssd_train: the loss is not finite or did not fall: {losses}")
    if launches != {"fused_adam_sweep": timed_steps, "box_nms_sorted": 0}:
        fail(f"ssd_train: launches {launches}, not one Adam sweep a step "
             "and no box_nms")
    return launches, net, x


def phase_ssd_detect(card: str, net, x) -> dict:
    """ssd_train's net hybridized, detect at batch 32 (nms_topk 400,
    nms_threshold 0.45): the forward's graph (its first call the capture,
    then replays) equal to the eager forward bit for bit with one
    capture; detect's rows equal to the plain route's (box_nms through
    its plain version, on the same card inputs) bit for bit; exactly one
    box_nms call per detect, and in the profile of detects as many
    box_nms kernels a detect as nms_plan states for 400 rows (one: the
    cluster kernel of the shared route). Printed:
    images/s through detect, host and device ms per detect, the idle
    share and device ms by kind."""
    import gc

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.kernels import (box_nms_sorted,
                                         box_nms_sorted_reference, nms_plan)
    from mxnet_tpu_torch.ops import spatial

    t0 = time.perf_counter()
    batch, timed = x.shape[0], 10
    with autograd.predict_mode():
        eager = [o._data.clone() for o in net(x)]
        net.hybridize()
        same = all(torch.equal(a._data, b)
                   for a, b in zip(net(x), eager))
        for _ in range(5):
            same &= all(torch.equal(a._data, b)
                        for a, b in zip(net(x), eager))
        captures = net.cached_graph.captures
        box_nms_sorted.launches = 0
        det = net.detect(x)._data.clone()
        one = box_nms_sorted.launches
        spatial.box_nms_sorted = box_nms_sorted_reference
        try:
            plain = net.detect(x)._data
        finally:
            spatial.box_nms_sorted = box_nms_sorted
        rows_equal = _nan_same(det, plain)
        box_nms_sorted.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(timed):
            net.detect(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = box_nms_sorted.launches
        brk = _device_breakdown(lambda: net.detect(x), 3, n_top=10,
                                kind=_ssd_kind)
    kept = (det[..., 0] >= 0).sum(dim=1).float()
    nms_kernels = sum(r["launches"] for name, r in
                      brk["port_kernels_per_step"].items() if "nms_" in name)
    planned = nms_plan(min(net.nms_topk, det.shape[1])).kernels
    out = {"phase": "ssd_detect", "card": card,
           "model": "get_ssd(20, base='small'), hybridized",
           "batch": list(x.shape), "nms_topk": net.nms_topk,
           "nms_threshold": net.nms_threshold,
           "graph_equals_eager_bits": bool(same), "captures": captures,
           "detect_rows_equal_plain_bits": rows_equal,
           "box_nms_launches_first_detect": one,
           "box_nms_sorted": launches, "detects": timed,
           "box_nms_kernels_per_detect": nms_kernels,
           "box_nms_planned_kernels": planned,
           "kept_per_image": [float(kept.min()), float(kept.mean()),
                              float(kept.max())],
           "images_per_s": batch * timed / wall,
           "ms_per_detect": wall * 1e3 / timed,
           "detect_breakdown": {k: brk[k] for k in (
               "host_ms_per_step", "device_ms_per_step",
               "device_idle_share", "top_device_ms_per_step",
               "device_ms_per_step_by_kind")},
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not same or captures != 1:
        fail(f"ssd_detect: graph = eager {same}, {captures} captures")
    if not rows_equal:
        fail("ssd_detect: detect's rows differ from the plain route's")
    if one != 1 or launches != timed:
        fail(f"ssd_detect: box_nms launched {one} times in one detect and "
             f"{launches} in {timed}")
    if nms_kernels != planned:
        fail(f"ssd_detect: {nms_kernels} box_nms kernels a detect, planned "
             f"{planned}")
    if not torch.isfinite(det).all() or tuple(det.shape) != (batch, 7620, 6):
        fail(f"ssd_detect: rows {tuple(det.shape)} not finite or not "
             f"({batch}, 7620, 6)")
    del net, x
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 17q-17r. the spatial group (ROADMAP.md, port queue 1, item 4 (c))
# ---------------------------------------------------------------------------

# GluonCV faster_rcnn_resnet50_v1b_voc: C4 features at stride 16 of a 600 x
# 1000 image, roi_mode "align", 14 x 14 bins, 128 sampled RoIs an image,
# rpn_test_post_nms 300
FRCNN = dict(n=2, c=1024, h=38, w=63, rois=256, predict_rois=300,
             pooled_size=(14, 14), spatial_scale=1 / 16, sample_ratio=2)
# FlowNetC (Dosovitskiy et al. 2015), its prototxt's correlation_param
FLOWNETC = dict(batch=8, c=256, h=48, w=64, pad_size=20, kernel_size=1,
                max_displacement=20, stride1=1, stride2=2)
# R-FCN on VOC (Dai et al. 2016): 21 classes, 7 x 7 position-sensitive bins
RFCN = dict(c=21 * 49, h=38, w=63, rois=300, output_dim=21, pooled_size=7,
            group_size=7, spatial_scale=1 / 16)
# Fast R-CNN (Girshick 2015), VGG16's conv5_3 at stride 16: 2 images of a
# 608 x 1008 batch, 128 RoIs each, 7 x 7 max pooling
FAST_RCNN = dict(n=2, c=512, h=38, w=63, rois=256, pooled_size=(7, 7),
                 spatial_scale=1 / 16)
# Deformable ConvNets' resnet_v1_101_rfcn_dcn res5 3x3 (dilated 2, 4
# deformable groups)
DCN = dict(c=512, h=38, w=63, num_filter=512, kernel=(3, 3), dilate=(2, 2),
           pad=(2, 2), num_deformable_group=4)


def _roi_rows(rs, n_rois, n_img, img_h, img_w):
    """RoIs [b, x1, y1, x2, y2] in image pixels: boxes of 5-60% of the
    image, some partly outside it, every 17th of batch index -1."""
    x1 = rs.uniform(-0.2 * img_w, 0.95 * img_w, n_rois)
    y1 = rs.uniform(-0.2 * img_h, 0.95 * img_h, n_rois)
    x2 = x1 + rs.uniform(0.05, 0.6, n_rois) * img_w
    y2 = y1 + rs.uniform(0.05, 0.6, n_rois) * img_h
    b = rs.randint(0, n_img, n_rois).astype(np.float64)
    b[::17] = -1
    return np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)


def _frcnn_inputs(n_rois, seed, device="cuda"):
    """Faster R-CNN's RoI head inputs: the (2, 1024, 38, 63) C4 map, RoIs
    over a 608 x 1008 image, a head gradient."""
    rs = np.random.RandomState(seed)
    f = FRCNN
    data = rs.randn(f["n"], f["c"], f["h"], f["w"]).astype(np.float32)
    rois = _roi_rows(rs, n_rois, f["n"], f["h"] * 16, f["w"] * 16)
    g = rs.randn(n_rois, f["c"], *f["pooled_size"]).astype(np.float32)
    return tuple(torch.from_numpy(t).to(device) for t in (data, rois, g))


def _flownet_inputs(batch, seed, device="cuda"):
    f = FLOWNETC
    rs = np.random.RandomState(seed)
    a, b = (rs.randn(batch, f["c"], f["h"], f["w"]).astype(np.float32)
            for _ in range(2))
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _corr_kw():
    return {k: FLOWNETC[k] for k in ("pad_size", "kernel_size",
                                     "max_displacement", "stride1",
                                     "stride2")}


def _event_ms(fn):
    """(fn's result, its device ms between two events, one call after an
    L2-sized read)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.ones(32 << 20, device="cuda").sum()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def roi_align_cases(flush) -> list:
    """roi_align's forward and backward kernels at Faster R-CNN's RoI head
    (FRCNN: a (2, 1024, 38, 63) f32 map, 256 RoIs of which every 17th has
    batch index -1 and some lie partly outside the map, 14 x 14 bins, sr
    2, scale 1/16) against the plain version's autograd on the same card
    inputs: the forward within 1e-6 of its largest magnitude, d data
    within 1e-5 (atomics: another summation order each run); d rois
    (the kernel's, no case of the main path) recorded beside them. ms:
    the event pair after the flush (time_ms); device_ms: queued behind a
    sleep; plain_ms: the plain forward and its autograd backward, each
    timed once in the check. Bound: the bytes, the map read once and the
    (256, 1024, 14, 14) f32 output written once (forward), the head
    gradient read once and the map's gradient written once (backward),
    against 12 f32 operations a sample (four corners' two weight products
    and the three sums and the accumulation) and a division a bin. No
    single PyTorch call computes it (torchvision is not installed)."""
    from mxnet_tpu_torch.kernels import (roi_align, roi_align_bwd,
                                         roi_align_reference)

    f = FRCNN
    kw = dict(pooled_size=f["pooled_size"], spatial_scale=f["spatial_scale"],
              sample_ratio=f["sample_ratio"], aligned=False)
    data, rois, g = _frcnn_inputs(f["rois"], SEED + 31)
    d = data.clone().requires_grad_()
    r = rois.clone().requires_grad_()
    plain, plain_fwd_ms = _event_ms(lambda: roi_align_reference(d, r, **kw))
    _, plain_bwd_ms = _event_ms(lambda: plain.backward(g))

    def fwd():
        return roi_align(data, rois, **kw)

    def bwd(rois_grad=False):
        return roi_align_bwd(g, data, rois, kw["pooled_size"],
                             kw["spatial_scale"], kw["sample_ratio"],
                             False, rois_grad=rois_grad)

    out = fwd()
    dd, dr = bwd(rois_grad=True)
    fwd_err = _rel(out, plain)
    bwd_err = _rel(dd, d.grad)
    rois_err = _rel(dr, r.grad)
    del d, r, plain, dr
    n_out = out.numel()
    map_bytes = 4.0 * data.numel()
    ops = n_out * (12.0 * f["sample_ratio"] ** 2 + 1)
    recs = []
    for name, fn, n_bytes, err, tol, plain_ms in (
            ("roi_align", fwd, 4.0 * n_out + map_bytes + rois.numel() * 4,
             fwd_err, 1e-6, plain_fwd_ms),
            ("roi_align_bwd", bwd, 4.0 * n_out + map_bytes
             + rois.numel() * 4, bwd_err, 1e-5, plain_bwd_ms)):
        b_ms, b_by = bound(n_bytes, ops, torch.float32)
        rec = {"phase": "kernels", "kernel": name,
               "shape": {"map": list(data.shape), "rois": f["rois"],
                         "pooled_size": list(f["pooled_size"]),
                         "sample_ratio": f["sample_ratio"],
                         "spatial_scale": f["spatial_scale"]},
               "dtype": "float32", "rel_err": err, "tolerance": tol,
               "max_abs_err": err * float((out if name == "roi_align"
                                           else dd).abs().max()),
               "ms": time_ms(fn, flush), "device_ms": _queued_ms(fn, flush),
               "plain_ms": plain_ms,
               "plain_timing": "one event pair: the checked call (autograd "
                               "backward for roi_align_bwd)",
               "library_ms": None,
               "library": "null (no single call: torchvision is not "
                          "installed)",
               "bound_ms": b_ms, "bound_by": b_by, "ok": err <= tol}
        if name == "roi_align_bwd":
            rec["rois_grad_rel_err"] = rois_err
            rec["with_rois_grad_device_ms"] = _queued_ms(
                lambda: bwd(rois_grad=True), flush)
        emit(rec)
        recs.append(rec)
    return recs


def correlation_cases(flush) -> list:
    """The correlation kernels at FlowNetC's cost volume (FLOWNETC: (8,
    256, 48, 64) f32 pairs, pad 20, kernel 1, max displacement 20,
    stride2 2: 441 displacements) against the plain version's autograd on
    the same card inputs at batch 8: the forward and both gradients
    within 1e-5 of their largest magnitudes. ms, device_ms and plain_ms
    as roi_align_cases'. Bound: the operations, a product and a sum for
    each (pair, displacement, channel) of the forward (5.55 GFLOP), two of
    each for the backward (one for each gradient), f32, against the bytes
    (the inputs and the volume read or written once). No single PyTorch
    call computes it."""
    from mxnet_tpu_torch.kernels import (correlation, correlation_bwd,
                                         correlation_reference)
    from mxnet_tpu_torch.kernels.correlation import correlation_geometry

    f, kw = FLOWNETC, _corr_kw()
    a, b = _flownet_inputs(f["batch"], SEED + 32)
    geo = correlation_geometry(f["h"], f["w"], f["kernel_size"],
                               f["max_displacement"], f["stride1"],
                               f["stride2"], f["pad_size"])
    g = torch.randn((f["batch"], geo.d ** 2, geo.ho, geo.wo), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 33))
    pa, pb = a.clone().requires_grad_(), b.clone().requires_grad_()
    plain, plain_fwd_ms = _event_ms(lambda: correlation_reference(pa, pb,
                                                                  **kw))
    _, plain_bwd_ms = _event_ms(lambda: plain.backward(g))
    args = [kw[k] for k in ("kernel_size", "max_displacement", "stride1",
                            "stride2", "pad_size")]

    def fwd():
        return correlation(a, b, **kw)

    def bwd():
        return correlation_bwd(g, a, b, *args)

    out = fwd()
    da, db = bwd()
    errs = {"correlation": _rel(out, plain),
            "correlation_bwd": max(_rel(da, pa.grad), _rel(db, pb.grad))}
    maxes = {"correlation": float(out.abs().max()),
             "correlation_bwd": float(max(da.abs().max(), db.abs().max()))}
    del pa, pb, plain, da, db
    pairs = float(f["batch"] * geo.d ** 2 * geo.ho * geo.wo * f["c"])
    in_bytes = 4.0 * (a.numel() + b.numel())
    recs = []
    for name, fn, n_bytes, ops, plain_ms in (
            ("correlation", fwd, in_bytes + 4.0 * out.numel(), 2 * pairs,
             plain_fwd_ms),
            ("correlation_bwd", bwd, 2 * in_bytes + 4.0 * out.numel(),
             4 * pairs, plain_bwd_ms)):
        b_ms, b_by = bound(n_bytes, ops, torch.float32)
        rec = {"phase": "kernels", "kernel": name,
               "shape": {"pair": [f["batch"], f["c"], f["h"], f["w"]],
                         "volume": list(out.shape), **kw},
               "dtype": "float32", "rel_err": errs[name], "tolerance": 1e-5,
               "max_abs_err": errs[name] * maxes[name],
               "gradient_checked_at_batch": f["batch"],
               "ms": time_ms(fn, flush), "device_ms": _queued_ms(fn, flush),
               "plain_ms": plain_ms,
               "plain_timing": "one event pair: the checked call (autograd "
                               "backward for correlation_bwd)",
               "library_ms": None,
               "library": "null (no single call computes it)",
               "bound_ms": b_ms, "bound_by": b_by,
               "ok": errs[name] <= 1e-5}
        emit(rec)
        recs.append(rec)
    return recs


def _spatial_ref_cases(rs):
    """Each op of the group at a small shape: (function, numpy inputs,
    the inputs the reference differentiates, attributes, forward and
    gradient tolerances), as tests/test_torch_spatial_group.py holds them
    against the reference."""
    from mxnet_tpu_torch.ops import contrib, deformable
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import spatial

    def f(*s):
        return rs.randn(*s).astype(np.float32)

    data = f(2, 8, 12, 14)
    rois = _roi_rows(rs, 12, 2, 24, 28)
    return {
        "ROIAlign": (contrib.roi_align, [data, rois], (0, 1),
                     dict(pooled_size=(4, 3), spatial_scale=0.5,
                          sample_ratio=2), 1e-5, [1e-5, 1e-5]),
        "ROIPooling": (ops_nn.roi_pooling, [data, rois], (0,),
                       dict(pooled_size=(3, 3), spatial_scale=0.5), 0.0,
                       [1e-6]),
        "PSROIPooling": (deformable.psroi_pooling, [f(2, 18, 12, 14), rois],
                         (0,), dict(spatial_scale=0.5, output_dim=2,
                                    pooled_size=3), 1e-5, [1e-5]),
        "DeformableConvolution": (
            deformable.deformable_convolution,
            [data, f(2, 36, 12, 14) * 1.5, f(6, 4, 3, 3), f(6)],
            (0, 1, 2, 3), dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                               num_filter=6, num_group=2,
                               num_deformable_group=2),
            1e-5, [1e-5, 1e-5, 1e-4, 1e-5]),
        "Correlation": (deformable.correlation, [data, f(2, 8, 12, 14)],
                        (0, 1), dict(kernel_size=3, max_displacement=2,
                                     stride2=2, pad_size=2), 1e-5,
                        [1e-5, 1e-5]),
        "BilinearSampler": (spatial.bilinear_sampler,
                            [data, rs.uniform(-1.2, 1.2, (2, 2, 9, 7))
                             .astype(np.float32)], (0, 1), {}, 1e-5,
                            [1e-5, 1e-5]),
        "SpatialTransformer": (spatial.spatial_transformer,
                               [data, np.array([[0.9, 0.1, 0.05, -0.1, 1.1,
                                                 0.02]] * 2, np.float32)],
                               (0, 1), dict(target_shape=(6, 5)), 1e-5,
                               [1e-5, 1e-5]),
        "GridGenerator": (ops_nn.grid_generator, [f(3, 6)], (0,),
                          dict(target_shape=(5, 4)), 1e-5, [1e-5]),
        "Crop": (ops_nn.crop, [data], (0,), dict(h_w=(5, 6),
                                                 center_crop=True), 0.0,
                 [0.0]),
        "im2col": (ops_nn.im2col, [data], (0,),
                   dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2),
                        pad=(1, 2)), 0.0, [1e-5]),
        "col2im": (ops_nn.col2im, [f(2, 8 * 9, 42)], (0,),
                   dict(output_size=(12, 14), kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1)), 1e-5, [0.0]),
    }


def _roi_head_block(mx):
    """A HybridBlock as a Faster R-CNN user writes one: F.contrib.ROIAlign
    over the map and the RoIs, then a Dense."""
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class RoiHead(HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc = nn.Dense(32)

        def hybrid_forward(self, F, x, rois):
            return self.fc(F.contrib.ROIAlign(
                x, rois, pooled_size=(7, 7), spatial_scale=1 / 16,
                sample_ratio=2))

    return RoiHead()


def phase_spatial_reference(card: str) -> dict:
    """The group's 11 ops at small shapes, f32 with TF32 off, on the card
    against the CPU from the same numpy inputs: each output and each
    gradient the reference takes within the CPU tests' tolerances
    (ROIPooling's forward, Crop and im2col bit for bit, the deformable
    convolution's weight gradient 1e-4, the rest 1e-5 of the CPU's
    largest magnitude); then a hybridized HybridBlock (F.contrib.ROIAlign,
    then a Dense) on the card: its graph against its eager forward bit
    for bit over 5 calls, one capture, and the eager forward against the
    CPU's (1e-5)."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    t0 = time.perf_counter()
    prev = _tf32(False)
    rs = np.random.RandomState(SEED + 40)
    errs, bad = {}, []
    for name, (fn, arrays, wrt, kw, tol, gtols) in \
            _spatial_ref_cases(rs).items():
        got = {}
        for dev in ("cuda", "cpu"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_(i in wrt)
                  for i, a in enumerate(arrays)]
            y = fn(*ts, **kw)
            g = torch.from_numpy(np.random.RandomState(3).randn(*y.shape)
                                 .astype(np.float32)).to(dev, y.dtype)
            y.backward(g)
            got[dev] = [y] + [ts[i].grad for i in wrt]
        e = [_rel(a, b) for a, b in zip(got["cuda"], got["cpu"])]
        errs[name] = e
        if any(v > t for v, t in zip(e, [tol] + gtols)):
            bad.append(name)
    # the hybridized block
    x_np = rs.randn(2, 16, 19, 31).astype(np.float32)
    r_np = _roi_rows(rs, 24, 2, 19 * 16, 31 * 16)
    block = _roi_head_block(mx)
    block.initialize(ctx=mx.gpu(0))
    x, r = mx.nd.array(x_np, ctx=mx.gpu(0)), mx.nd.array(r_np, ctx=mx.gpu(0))
    with autograd.predict_mode():
        eager = block(x, r)._data.clone()
        block.hybridize()
        same = all(torch.equal(block(x, r)._data, eager) for _ in range(5))
        captures = block.cached_graph.captures
    with tempfile.TemporaryDirectory() as tmp:
        block.save_parameters(f"{tmp}/head.params")
        cpu_block = _roi_head_block(mx)
        cpu_block.load_parameters(f"{tmp}/head.params", ctx=mx.cpu())
    cpu_out = cpu_block(mx.nd.array(x_np, ctx=mx.cpu()),
                        mx.nd.array(r_np, ctx=mx.cpu()))._data
    block_err = _rel(eager, cpu_out)
    _restore_tf32(prev)
    out = {"phase": "spatial_reference", "card": card,
           "dtype": "float32, TF32 off",
           "rel_err_output_then_gradients": errs,
           "hybridized_roi_head": {"graph_equals_eager_bits": bool(same),
                                   "captures": captures,
                                   "eager_vs_cpu_rel_err": block_err},
           "seconds": time.perf_counter() - t0}
    emit(out)
    if bad:
        fail(f"spatial_reference: card against CPU past the tolerance: "
             f"{ {k: errs[k] for k in bad} }")
    if not same or captures != 1 or block_err > 1e-5:
        fail(f"spatial_reference: the hybridized RoI head: graph = eager "
             f"{same}, {captures} captures, eager vs CPU {block_err}")
    return out


def _spatial_counts():
    from mxnet_tpu_torch.kernels import (correlation, correlation_bwd,
                                         roi_align, roi_align_bwd)

    return {"roi_align": roi_align, "roi_align_bwd": roi_align_bwd,
            "correlation": correlation, "correlation_bwd": correlation_bwd}


def _timed_steps(step, steps):
    """(host ms a step, device ms a step, peak MB): ``steps`` calls
    synchronised on the host clock, then the same queued behind a sleep
    (_queued_ms's device time over all the calls), the peak allocation
    over one more call."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    pre, start, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    pre.record()
    torch.cuda._sleep(int(2e8))
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / steps
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return host_ms, device_ms, peak_mb


def phase_spatial(card: str) -> dict:
    """The group's path through mx.nd at the published widths of the
    models that call it, f32 with TF32 off, every launch counter set to 0
    just before it and read just after:
    Faster R-CNN's RoI head (FRCNN): mx.nd.contrib.ROIAlign under
    autograd.record() over 256 RoIs, backward() with a seeded head
    gradient, 3 steps (exactly one roi_align and one roi_align_bwd launch
    a step), then a 300-RoI predict call (one roi_align launch);
    FlowNetC's cost volume (FLOWNETC): mx.nd.Correlation, 3 recorded
    forward and backward steps (one correlation and one correlation_bwd
    launch a step); R-FCN's head (RFCN): mx.nd.contrib.PSROIPooling over
    300 RoIs; the DCN res5 conv (DCN): mx.nd.contrib.DeformableConvolution
    forward and backward; Fast R-CNN's mx.nd.ROIPooling (FAST_RCNN: 256
    RoIs of a (2, 512, 38, 63) map, 7 x 7) forward and backward, timed.
    Each output finite and of its shape; the
    PSROIPooling and DCN outputs and gradients against the CPU's from the
    same inputs (1e-5, the weight's gradient 1e-4), both timed. For each:
    host and device ms a step, peak MB."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    t0 = time.perf_counter()
    prev = _tf32(False)
    gpu = mx.gpu(0)
    counters = _spatial_counts()
    f = FRCNN
    data, rois, g = _frcnn_inputs(f["rois"], SEED + 31)
    _, rois300, _ = _frcnn_inputs(f["predict_rois"], SEED + 34)
    a, b = _flownet_inputs(FLOWNETC["batch"], SEED + 32)
    roi_kw = dict(pooled_size=f["pooled_size"],
                  spatial_scale=f["spatial_scale"],
                  sample_ratio=f["sample_ratio"])
    x = mx.nd.array(data, ctx=gpu)
    x.attach_grad()
    nd_rois = mx.nd.array(rois, ctx=gpu)
    head = mx.nd.array(g, ctx=gpu)
    x1, x2 = mx.nd.array(a, ctx=gpu), mx.nd.array(b, ctx=gpu)
    x1.attach_grad()
    x2.attach_grad()
    outs = {}

    def roi_step():
        with autograd.record():
            y = mx.nd.contrib.ROIAlign(x, nd_rois, **roi_kw)
        y.backward(head)
        outs["roi"] = y

    def corr_step():
        with autograd.record():
            y = mx.nd.Correlation(x1, x2, **_corr_kw())
        y.backward(mx.nd.ones_like(y))
        outs["corr"] = y

    for fn in counters.values():
        fn.launches = 0
    steps = 3
    for _ in range(steps):
        roi_step()
    pred = mx.nd.contrib.ROIAlign(x, mx.nd.array(rois300, ctx=gpu), **roi_kw)
    for _ in range(steps):
        corr_step()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {"roi_align": steps + 1, "roi_align_bwd": steps,
            "correlation": steps, "correlation_bwd": steps}
    shapes_ok = (tuple(outs["roi"].shape) == (f["rois"], f["c"], 14, 14)
                 and tuple(pred.shape) == (f["predict_rois"], f["c"], 14, 14)
                 and tuple(outs["corr"].shape) == (FLOWNETC["batch"], 441,
                                                   48, 64))
    finite = all(bool(torch.isfinite(t._data).all()) for t in (
        outs["roi"], pred, outs["corr"], x.grad, x1.grad, x2.grad))
    timing = {"roi_align_train_step": _timed_steps(roi_step, 10),
              "roi_align_predict_300": _timed_steps(
                  lambda: mx.nd.contrib.ROIAlign(
                      x, mx.nd.array(rois300, ctx=gpu), **roi_kw), 10),
              "correlation_train_step": _timed_steps(corr_step, 5)}
    del x, x1, x2, outs, pred
    # Fast R-CNN's ROIPooling (plain PyTorch on the card: queue 2's
    # candidate), forward and backward, timed
    fr = FAST_RCNN
    rs = np.random.RandomState(SEED + 36)
    xp = mx.nd.array(rs.randn(fr["n"], fr["c"], fr["h"], fr["w"])
                     .astype(np.float32), ctx=gpu)
    xp.attach_grad()
    rp = mx.nd.array(_roi_rows(rs, fr["rois"], fr["n"], fr["h"] * 16,
                               fr["w"] * 16), ctx=gpu)

    def pool_step():
        with autograd.record():
            y = mx.nd.ROIPooling(xp, rp, pooled_size=fr["pooled_size"],
                                 spatial_scale=fr["spatial_scale"])
        y.backward()
        outs["pool"] = y

    outs = {}
    timing["roi_pooling_train_step"] = _timed_steps(pool_step, 3)
    pool_ok = (tuple(outs["pool"].shape) == (fr["rois"], fr["c"], 7, 7)
               and bool(torch.isfinite(outs["pool"]._data).all())
               and bool(torch.isfinite(xp.grad._data).all()))
    del xp, rp, outs
    # R-FCN's PSROIPooling and the DCN conv, card against CPU
    rs = np.random.RandomState(SEED + 35)
    r = RFCN
    ps_data = rs.randn(1, r["c"], r["h"], r["w"]).astype(np.float32)
    ps_rois = _roi_rows(rs, r["rois"], 1, r["h"] * 16, r["w"] * 16)
    ps_kw = {k: r[k] for k in ("output_dim", "pooled_size", "group_size",
                               "spatial_scale")}
    dc = DCN
    ho, wo = dc["h"], dc["w"]
    dc_in = [rs.randn(1, dc["c"], dc["h"], dc["w"]).astype(np.float32),
             (rs.randn(1, 2 * dc["num_deformable_group"] * 9, ho, wo)
              * 2.0).astype(np.float32),
             (rs.randn(dc["num_filter"], dc["c"], 3, 3)
              / np.sqrt(dc["c"] * 9)).astype(np.float32),
             rs.randn(dc["num_filter"]).astype(np.float32)]
    dc_kw = {k: dc[k] for k in ("num_filter", "kernel", "dilate", "pad",
                                "num_deformable_group")}
    compare = {}
    for name, op, arrays, wrt, kw in (
            ("psroi_pooling", mx.nd.contrib.PSROIPooling,
             [ps_data, ps_rois], (0,), ps_kw),
            ("deformable_convolution", mx.nd.contrib.DeformableConvolution,
             dc_in, (0, 1, 2, 3), dc_kw)):
        res = {}
        for dev, ctx in (("card", gpu), ("cpu", mx.cpu())):
            nds = [mx.nd.array(v, ctx=ctx) for v in arrays]
            for i in wrt:
                nds[i].attach_grad()

            def step():
                with autograd.record():
                    y = op(*nds, **kw)
                y.backward()
                return y

            if dev == "card":
                host_ms, device_ms, peak = _timed_steps(step, 5)
                y = step()
            else:
                tc = time.perf_counter()
                y = step()
                host_ms, device_ms, peak = ((time.perf_counter() - tc) * 1e3,
                                            None, None)
            res[dev] = {"out": y._data.cpu(),
                        "grads": [nds[i].grad._data.cpu() for i in wrt],
                        "host_ms": host_ms, "device_ms": device_ms,
                        "peak_mb": peak}
        errs = [_rel(res["card"]["out"], res["cpu"]["out"])] + [
            _rel(p, q) for p, q in zip(res["card"]["grads"],
                                       res["cpu"]["grads"])]
        tols = [1e-5] * len(errs)
        if name == "deformable_convolution":
            tols[3] = 1e-4
        compare[name] = {
            "shape": list(res["card"]["out"].shape),
            "rel_err_output_then_gradients": errs,
            "ok": all(e <= t for e, t in zip(errs, tols)),
            "finite": bool(torch.isfinite(res["card"]["out"]).all()),
            "card_host_ms_per_step": res["card"]["host_ms"],
            "card_device_ms_per_step": res["card"]["device_ms"],
            "card_peak_mb": res["card"]["peak_mb"],
            "cpu_ms_per_step": res["cpu"]["host_ms"]}
    _restore_tf32(prev)
    out = {"phase": "spatial", "card": card, "dtype": "float32, TF32 off",
           "launches": launches, "expected_launches": want,
           "shapes_ok": shapes_ok, "finite": finite,
           "roi_pooling_ok": pool_ok,
           "timing_host_device_ms_peak_mb": timing, "card_vs_cpu": compare,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if launches != want:
        fail(f"spatial: launches {launches}, expected {want}")
    if not shapes_ok or not finite or not pool_ok:
        fail(f"spatial: outputs of the wrong shape ({shapes_ok}) or not "
             f"finite ({finite}); ROIPooling {pool_ok}")
    bad = {k: v for k, v in compare.items() if not (v["ok"] and v["finite"])}
    if bad:
        fail(f"spatial: card against CPU: {bad}")
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    picks = phase_kernels()
    counts = phase_launch_counts()
    phase_reference()
    serving = phase_serving()
    phase_multitenant()
    phase_reload()
    phase_bert_reference()
    serving.update(phase_bert_serving())
    phase_train_reference()
    phase_train_reference(dropout=0.1, attn_dropout=0.1)
    # in turns (0, 0.1, 0.1, 0), so the cost of dropout is read on one
    # card in one process, twice
    train = phase_bert_train()["launches"]
    train_drop = phase_bert_train(dropout=0.1, attn_dropout=0.1)
    drop_ms = [train_drop["ms_per_step"], phase_bert_train(
        dropout=0.1, attn_dropout=0.1)["ms_per_step"]]
    train_drop = train_drop["launches"]
    phase_bert_train()
    phase_bert_trainer_reference()
    trainer = phase_bert_trainer()
    # the eager entry points' cost on the card: the Trainer step beside
    # the TrainStep + Adam step at the same shape and dropout, this run
    emit({"phase": "bert_trainer_vs_trainstep",
          "trainer_lamb_ms_per_step": trainer["ms_per_step"],
          "trainstep_adam_ms_per_step": drop_ms,
          "gap_ms": trainer["ms_per_step"] - float(np.mean(drop_ms))})
    trainer = trainer["launches"]
    phase_gluon_reference()
    gluon = phase_gluon()
    phase_llama_train_reference()
    llama = phase_llama_train()
    llama_remat = phase_llama_remat()
    phase_resnet_train_reference()
    resnet = phase_resnet_train()
    phase_optimizer_paths()
    phase_resnet_v2_trainer_reference()
    phase_resnet_v2_trainer()
    rtc = phase_rtc(card)
    imperative = phase_imperative(card)
    phase_dp_reference()
    dp = phase_dp_train()
    data_llama = phase_data_llama(card)
    data_resnet = phase_data_resnet(card)
    data_gluon = phase_data_gluon(card)
    data_image = phase_data_image(card)
    coldstart = phase_coldstart(card)
    phase_compile_only(card)
    phase_rnn(card)
    word_lm = phase_word_lm(card)
    vision_ref = phase_vision_reference(card)
    mobilenet = phase_mobilenet_train(card)
    phase_vision_serve(card)
    phase_ssd_reference(card)
    ssd_train, ssd_net, ssd_x = phase_ssd_train(card)
    ssd_detect = phase_ssd_detect(card, ssd_net, ssd_x)
    del ssd_net, ssd_x
    phase_spatial_reference(card)
    spatial = phase_spatial(card)
    pk = "mxnet_tpu/pallas_kernels/"
    csrc = "mxnet_tpu_torch/kernels/csrc/"
    replaces = {
        "fused_rms_norm": ("rms_norm.cu", pk + "fused_layers.py:323"),
        "paged_attention_kernel": ("paged_attention.cu",
                                   pk + "paged_attention.py:150"),
        "fused_layer_norm": ("layer_norm.cu", pk + "fused_layers.py:323"),
        "fused_bias_gelu": ("bias_gelu.cu", pk + "fused_layers.py:533"),
        # one kernel for both forward pallas_call sites (:552 and :590)
        "flash_attention": ("flash_attention.cu",
                            pk + "flash_attention.py:552"),
        "fused_layer_norm_bwd": ("layer_norm.cu", pk + "fused_layers.py:361"),
        "fused_bias_gelu_bwd": ("bias_gelu.cu", pk + "fused_layers.py:539"),
        # one algorithm for the four backward sites (:914, :937, :959,
        # :977)
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                pk + "flash_attention.py:914"),
        "fused_adam_sweep": ("fused_optimizer.cu",
                             pk + "fused_optimizer.py:128"),
        # row 9 in RMS mode, reached through _rms_bwd (:479)
        "fused_rms_norm_bwd": ("layer_norm.cu", pk + "fused_layers.py:361"),
        # row 12 for the adamw family: its scan and its sweep
        "fused_adamw_sweep": ("fused_optimizer.cu",
                              pk + "fused_optimizer.py:128"),
        # row 12 for the sgd family
        "fused_sgd_sweep": ("fused_optimizer.cu",
                            pk + "fused_optimizer.py:128"),
        # row 12 for the lamb family: phase 1, the norms, phase 2
        "fused_lamb_sweep": ("fused_optimizer.cu",
                             pk + "fused_optimizer.py:128"),
        # the dropout modes of rows 1', 9, 3-4 and 5-8
        "fused_layer_norm[dropout]": ("layer_norm.cu",
                                      pk + "fused_layers.py:323"),
        "fused_layer_norm_bwd[dropout]": ("layer_norm.cu",
                                          pk + "fused_layers.py:361"),
        "flash_attention[dropout]": ("flash_attention.cu",
                                     pk + "flash_attention.py:552"),
        "flash_attention_bwd[dropout]": ("flash_attention_bwd.cu",
                                         pk + "flash_attention.py:914"),
        # not a Pallas site: dropout_op's hash branch, which XLA fuses
        "hash_dropout": ("dropout.cu", "mxnet_tpu/ops/nn.py:1079"),
        # not a Pallas site: the kvstore's 2-bit quantizer, which XLA fuses
        "twobit_quantize": ("gradient_compression.cu",
                            "mxnet_tpu/kvstore/gradient_compression.py:68"),
        # not a Pallas site: box_nms's lax.scan, which XLA compiles
        "box_nms": ("box_nms.cu", "mxnet_tpu/ops/spatial.py:80"),
        # not Pallas sites: ROIAlign's and Correlation's gathers and their
        # gradients, which XLA fuses
        "roi_align": ("roi_align.cu", "mxnet_tpu/ops/contrib.py:95"),
        "roi_align_bwd": ("roi_align.cu", "mxnet_tpu/ops/contrib.py:95"),
        "correlation": ("correlation.cu", "mxnet_tpu/ops/deformable.py:95"),
        "correlation_bwd": ("correlation.cu",
                            "mxnet_tpu/ops/deformable.py:95"),
    }
    bwd_sites = [pk + "flash_attention.py:937", pk + "flash_attention.py:959",
                 pk + "flash_attention.py:977"]
    also = {"flash_attention": [pk + "flash_attention.py:590"],
            "flash_attention_bwd": bwd_sites,
            "flash_attention[dropout]": [pk + "flash_attention.py:590"],
            "flash_attention_bwd[dropout]": bwd_sites}
    notes = {
        "hash_dropout": "not a Pallas site: dropout_op's hash branch, "
                        "which XLA fuses into its neighbours",
        "box_nms": "not a Pallas site: box_nms's greedy scan over the "
                   "score-sorted rows (lax.scan, mxnet_tpu/ops/spatial.py:"
                   "113-121), which XLA compiles; one call per "
                   "MultiBoxDetection, so one per SSD detect: one kernel "
                   "(the cluster kernel) up to 1,856 sorted rows, as at "
                   "detect's topk 400, two (tiles, sweep) above, as at the "
                   "op's default topk=-1 (default_topk)",
        "roi_align": "not a Pallas site: ROIAlign's four clipped gathers "
                     "a sample (mxnet_tpu/ops/contrib.py:95-146), which XLA "
                     "fuses; one launch a forward (Faster R-CNN's RoI head "
                     "and its 300-RoI predict call)",
        "roi_align_bwd": "not a Pallas site: the gradient of ROIAlign, "
                         "which XLA computes as a scatter-add; one launch a "
                         "backward, d rois in the same launch when asked",
        "correlation": "not a Pallas site: Correlation's loop over the "
                       "displacements (mxnet_tpu/ops/deformable.py:127-139), "
                       "which XLA fuses; one launch a forward (FlowNetC)",
        "correlation_bwd": "not a Pallas site: the gradient of Correlation; "
                           "one launch a backward for both inputs",
        "twobit_quantize": "not a Pallas site: the kvstore's 2-bit "
                           "quantizer with error feedback (_q), which XLA "
                           "fuses; one launch per gradient bucket per step "
                           "with compression_params",
        "fused_rms_norm_bwd": "_norm_bwd_pallas in RMS mode, reached "
                              "through _rms_bwd (fused_layers.py:479)",
        "fused_adamw_sweep": "the adamw family: one overflow scan and one "
                             "sweep per bucket; ms and bound_ms cover both "
                             "launches",
        "fused_sgd_sweep": "the sgd family: one sweep per dtype bucket, two "
                           "per ResNet-50 and per MobileNet v2 step (bf16-mp "
                           "and f32); ms and bound_ms cover ResNet-50's two "
                           "buckets",
        "fused_lamb_sweep": "the lamb family (_lamb_phase1_elem, "
                            "segment_sumsq, _lamb_phase2_elem): three "
                            "kernels per dtype bucket; ms and bound_ms "
                            "cover all three, launches counts phase 2 "
                            "(phase 1 and the norms in launches_by_path)"}
    kernels = []
    for name, (src, site) in replaces.items():
        r = picks[name]
        by_path = {}
        if name in serving:
            by_path["serving"] = serving[name]
        if name in train and train[name]:
            by_path["bert_train"] = train[name]
        if train_drop.get(name):
            by_path["bert_train_dropout"] = train_drop[name]
        if llama.get(name):
            by_path["llama_train"] = llama[name]
        if llama_remat.get(name):
            by_path["llama_remat"] = llama_remat[name]
        if name == "fused_adamw_sweep":
            by_path["llama_train[scan]"] = llama[name + "[scan]"]
        if resnet.get(name):
            by_path["resnet_train"] = resnet[name]
        if mobilenet.get(name):
            by_path["mobilenet_train"] = mobilenet[name]
        if trainer.get(name):
            by_path["bert_trainer"] = trainer[name]
        if imperative["step_launches"].get(name):
            by_path["imperative"] = imperative["step_launches"][name]
        if gluon.get(name):
            by_path["gluon_train"] = gluon[name]
        if dp.get(name):
            by_path["dp_train" + ("_2bit" if name == "twobit_quantize"
                                  else "")] = dp[name]
        for path, got in (("data_llama", data_llama),
                          ("data_resnet", data_resnet),
                          ("data_gluon", data_gluon),
                          ("data_image", data_image),
                          ("coldstart", coldstart),
                          ("word_lm", word_lm)):
            if got.get(name):
                by_path[path] = got[name]
        if name == "fused_adamw_sweep":
            by_path["data_llama[scan]"] = data_llama[name + "[scan]"]
        if name == "fused_adam_sweep":
            by_path["ssd_train"] = ssd_train[name]
        if name == "box_nms":
            by_path["ssd_detect"] = ssd_detect["box_nms_sorted"]
        if name in spatial:
            by_path["spatial"] = spatial[name]
        if name == "fused_lamb_sweep":
            for sub in ("[phase1]", "[norms]"):
                by_path["bert_trainer" + sub] = trainer[name + sub]
        launches = next(iter(by_path.values()))
        if name == "hash_dropout":
            # one kernel for the op's forward and backward wrappers
            by_path["bert_train_dropout"] = {
                "hash_dropout": train_drop["hash_dropout"],
                "hash_dropout_bwd": train_drop["hash_dropout_bwd"]}
            by_path["word_lm"] = {
                "hash_dropout": word_lm["hash_dropout"],
                "hash_dropout_bwd": word_lm["hash_dropout_bwd"]}
            by_path["vision_reference"] = {
                "hash_dropout": vision_ref["hash_dropout"],
                "hash_dropout_bwd": vision_ref["hash_dropout_bwd"]}
            launches = sum(by_path["bert_train_dropout"].values())
        rec = {"name": name, "route": "cuda", "source": csrc + src,
               "replaces": site, "launches": launches,
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": r["shape"], "dtype": r["dtype"]}
        for key in ("device_ms", "library_device_ms", "ctas", "splits",
                    "same_bits_twice", "empty_kernel_device_ms",
                    "kernels_per_call", "plain_device_ms", "event_ms",
                    "rel_err", "plain_timing", "rois_grad_rel_err",
                    "with_rois_grad_device_ms",
                    "gradient_checked_at_batch"):
            if key in r:
                rec[key] = r[key]
        if name in counts:
            rec["kernels_per_call"] = counts[name]
        # the flash kernels' own route (fwd/bwd_route), box_nms's (shared
        # or global)
        if "route" in r:
            rec["kernel_route"] = r["route"]
        if name == "box_nms":
            d = picks["box_nms[topk=-1]"]
            rec["default_topk"] = {k: d[k] for k in (
                "shape", "topk", "route", "kernels_per_call",
                "scratch_bytes", "max_abs_err", "ms", "device_ms",
                "plain_ms", "plain_timing", "bound_ms", "bound_by",
                "bound_ms_all_pairs")}
        if name in ("flash_attention", "flash_attention_bwd"):
            p1 = picks[name + "[proxy1b]"]
            rec["proxy1b_causal"] = {k: p1[k] for k in (
                "shape", "causal", "dtype", "route", "max_abs_err", "ms",
                "plain_ms", "library_ms", "device_ms", "library_device_ms",
                "bound_ms", "bound_by")}
        if name in also:
            rec["also_replaces"] = also[name]
        if name in notes:
            rec["note"] = notes[name]
        kernels.append(rec)
    # row 13: the user's kernels, compiled by NVRTC at run time. The
    # row's numbers are the main path's kernel (the imperative phase's
    # sgd_bf16, timed on its largest parameter); the rtc phase's axpy at
    # (32, 512, 768) sits beside them
    axpy, sgd = rtc["bert_axpy"]["axpy_bf16"], imperative["sgd"]
    k13 = sgd["kernel"]
    kernels.append({
        "name": "mx.rtc.CudaModule", "kernel": "sgd_bf16", "route": "cuda",
        "source": "tests/test_torch_cuda_rtc.py",
        "replaces": "mxnet_tpu/rtc.py:62",
        "launches": sgd["user_kernel"]["launches"],
        "launches_by_path": {"imperative": sgd["user_kernel"]["launches"],
                             "coldstart": coldstart["mx.rtc:scale_bf16"]},
        "max_abs_err": k13["max_abs_err"], "ms": k13["ms"],
        "plain_ms": k13["plain_ms"], "bound_ms": k13["bound_ms"],
        "bound_by": k13["bound_by"], "library_ms": k13["library_ms"],
        "shape": k13["shape"], "dtype": k13["dtype"],
        "compile_ms": dict(rtc["compile_ms"], sgd=sgd["compile_ms"]),
        "image_source": dict(rtc["image_source"],
                             sgd=sgd["image_source"]),
        "note": "the user's kernels, compiled by NVRTC (mxnet_tpu_torch/"
                "rtc.py) from CUDA source at run time; the row is the "
                "imperative path's user SGD kernel, one launch per "
                "parameter, timed on the word embedding against torch.sub; "
                "rtc_axpy is the rtc phase's user axpy",
        "rtc_axpy": {k: axpy[k] for k in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "imperative_sgd": {"device_ms": sgd["user_kernel"]["device_ms"],
                           "ndarray_ops_device_ms":
                               sgd["ndarray_ops"]["device_ms"],
                           "library_device_ms":
                               sgd["library_foreach_add"]["device_ms"],
                           "bound_ms": sgd["bound_ms"]}})
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
