#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of one bf16 chunk, the C2f and
                                     # head plan sweeps, both kernels' per-stage cycle counts and
                                     # the val loader-thread sweep

Phases (any failure stops the run with a non-zero exit code):
1. build the hand-written CUDA kernels from yolo_tpu_torch/csrc (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch twin on the card, in f32 and
   bf16, at the main path's shapes (the C2f instances, four Detect levels
   through both head kernels, NMS at K=64 over a 128-frame chunk and at
   K=1024 over one frame at conf 0.15, as each predict runs it, and over 8
   frames at conf 0.01), with activations captured from the trained model on real-size
   frames; print each kernel's time, its plain twin's, a cuDNN conv walk of
   the same block (`library_ms`, a yardstick the port never calls) and the
   least time the card could take (`bound_ms`); the C2f lines also print
   what the kernel's plan chose for the instance, and hold the instance again
   cut to one frame, as `[predict]` gives it (another plan). `[c2f edges]` then holds
   the C2f kernel against its twin at shapes the main path lacks (B = 1, odd
   and undivided maps, n = 1 and 3, c = 12, 64 and 96, c1 = 288, both shortcut
   settings, upconcat with 48 and 192 small channels). Each captured Detect
   level is also held cut to one frame through both head kernels, and `[head
   edges]` holds both against their twins at the port's head edge shapes
   (B = 1 and 3, an odd map, a map narrower than the tile, P5's C = 192,
   c3 = 192, nc = 3, 17, the stock yolov8.yaml nc = 80 level, and yolov8x's
   c2 = 80 at C = 320 and 512); `[nms edges]` holds the NMS kernel against
   its twin, bit for bit, at B = 1 and 128 and K = 1, 33, 64, 1024, 1200 and
   4096, and at B = 1 and K = 1280 and 1281, the last K of one launch and the
   first of two (both forms of its plan, printed per shape);
3. `[pipeline]`: run FusedDetectTrack (the demo's trained yolov8-small P2,
   scale n, demos/artifacts/train/weights/best.npz) on a seeded synthetic
   256-frame 640x512 IR clip with moving targets and dropout gaps: in f32
   through the kernels and in f32 through the plain twins (tracks, ids and
   stats must be equal, boxes close), then in bf16, timed, with the per-stage
   split and the launch count of every kernel in that run;
4. `[pipeline head_cm]`: the same with `pallas_head2=True`, the Detect levels
   through the channel-major head kernel (8 launches per 256 frames, none of
   the default head kernel);
5. `[pipeline bgr]`: one chunk of 3-channel BGR frames through
   `FusedDetectTrack(channels=3)`, f32 kernels against f32 twins, then bf16;
   `[batched tracker]`: `BatchedMultiTargetTracker.update` / `scan_frames` on
   the card against the CPU on a seeded detection sequence;
6. `[predict]`: `YOLO(best.npz).predict` frame by frame on PREDICT_FRAMES (16) 3-channel frames
   of the clip into the per-object Kalman clip loop, in f32 through the
   kernels and through the twins (equal detections and stats), then in bf16,
   timed;
7. `[track bytetrack]`: `YOLO(best.npz).track(frame, persist=True,
   tracker="bytetrack.yaml")` on TRACK_FRAMES (16) BGR frames, one per call, at the
   track defaults (conf 0.1, max_det 300, imgsz 640; the host BYTETracker):
   f32 kernels against f32 twins (rows and ids equal per frame, boxes 1e-2 px,
   conf 1e-4), then bf16, timed (predict and tracker host ms/frame);
8. `[track botsort]`: the same with a BoT-SORT yaml whose gmc_method is none,
   written to a temporary path (the only form a machine without cv2 runs);
   where cv2 imports, `[track botsort sparseOptFlow]` runs the default
   botsort.yaml, the GMC on;
9. `[track device]`: the bytetrack run with YOLO_TPU_DEVICE_TRACKER=1, the
   batched ByteTrack twin on the card: rows equal the host tracker's under the
   JAX package's contract (ids exact, 2e-2), then its bf16 ms/frame at d_max /
   n_max 320 / 512 (the defaults) and 16 / 64;
10. `[byte scan]`: the 256-frame clip in 128-frame chunks already on the card:
   the bf16 forward, NMS at d_max 16, xyxy → xywh with cls 0, then
   `BatchedBYTETracker(n_max=64, d_max=16).scan_frames`; equal to `update`
   frame by frame and to the same scan on the CPU (ids exact, 1e-4); frames/s
   and the per-chunk event split (forward, NMS, byte step);
11. config 5 (camera-motion compensation and grayscale recovery; needs cv2, and
   fails without it): a 162-frame 640x512 panning clip (a quarter of the 649 frames of a copy of
   demos/motion_comp_bench.py::make_panning_clip, seed 7) through the chunked
   config-5 detector (gray frames, /255, broadcast to the stem, predict_parts
   and NMS at conf 0.15, iou 0.6, max_det 16, 128-frame chunks).
   `[motion kernels]`: f32 kernels against f32 twins (equal detection counts
   per frame, boxes 1e-2 px, conf 1e-4), then the optical-flow
   MotionCompensatedMultiTracker on both detection sequences (equal stats and
   per-frame track lists by position). `[motion optical_flow]`, `[motion
   feature_matching]`, `[motion hybrid]`: the bf16 chunked detector, then the
   host loop: fps_batched = frames / (detect s + host s), device ms/frame
   (CUDA events), host ms/frame split into motion detection and tracker,
   events, resets and launches; optical_flow also with the detector called
   once a frame. `[motion compare]`: `motion.compare_motion_methods` over the
   clip's first 64 frames as an mp4v file, the bf16 detector once a frame.
   `[grayscale]`: 128 frames of the IR clip as an mp4v file through
   `GrayscaleTracker.process_video(test_range=(32, 80))`, its own YOLO set to
   f32 against a plain-twin f32 detector (equal stats and tracks), then the
   default (bf16) tracker timed. `[grayscale scorer]`: `predict_center_torch`
   on 256 seeded 40x40 ROIs on the card against the numpy scorer (same
   index, score rel 1e-5), timed.
12. serving (needs cv2): `[serve kernels]`: a DetectionServer (yolo_tpu_torch/serve.py) on
   127.0.0.1 with lane 0 from best.npz and lane 1 from the .pt the port's `YOLO.export(format="pt")`
   writes, both f32 through the kernels, and a second server f32 through the twins (`plain`);
   4 client threads x 16 frames of the clip (1- or 3-channel by thread), each frame to both lanes:
   every reply status 0, no lane out of service, kernels against twins and lane 1 against lane 0
   at the f32 gates (1e-2 px, conf 1e-4, same counts and classes), kernels 1, 2, 3 and 5 launched
   and none by the twins' server. `[serve letterbox]`: one 640x512 frame's native and cv2
   letterbox on the main thread. `[serve run 1]`, `[serve run 2]` (timed, bf16, the default): 8
   v2 client threads x 64 frames plus one v1 client of 64: frames/s over all clients, request
   latency p50 / p99, the histogram of padded batch sizes, the worker's split per batch (host:
   letterbox + assembly, enqueue, wait, Results; CUDA events: upload, device), the device's idle
   share, the first batch at each B against its median, the launches (kernels 1, 2, 3, 5; not 4);
   every frame must have gone through the native letterbox. `[remote]`: `YOLO("tcp://...")` over
   an mp4v file and a PNG directory equals raw v2 replies, and `track` attaches ids.
   `[predict sources]`: `YOLO(best.npz).predict` over a PNG directory, a glob and a video with
   save, save_txt and save_crop (the files written), and a 300x500 frame through the native
   letterbox, f32 kernels against f32 twins;
13. `[val kernels]` (needs cv2): `YOLO(best.npz).val` at imgsz 640, batch 16, on the
   demo's held-out split (32 frames of 640x512, seed 10,000, written by a copy of
   demos/ir_end_to_end.py::_write_split, letterboxed to 640x640): f32 through the
   kernels against f32 through the twins (P, R, mAP50, mAP50-95 and fitness within
   1e-4, equal confusion matrices, equal detections per image with boxes within 1e-2
   px and conf 1e-4), the f32 mAP beside the JAX demo's recorded one, then bf16 and its
   difference; then kernels 1, 2, 3 and 5 against their twins at TOL on activations
   captured from the first val batch (B = 16, 640x640; NMS at conf 0.001, K = 1024);
14. `[val]`: the same on a 256-frame split (seed 20,000) in f32 and bf16 at batch 16
   and 32: images/s by the host clock over the `.val(...)` call of a model already warmed
   at that batch and dtype (built and on the card before the clock), the per-batch split (loader
   wait, the host's enqueue, upload + forward + NMS in CUDA events, the copy-back wait,
   host matching), each kernel's launches (6 c2f, 3 c2f_upconcat, 4 head_level, 1
   nms_keep a batch), and at batch 16 a profiled call: the device's busy time and idle
   share, the top device kernels and host ops.
15. training (needs cv2): the demo's 64-frame training split (seed 0) and its held-out split
   (the 32 frames of `[val kernels]`), written by the copy of _write_split. `[train]`:
   YOLO("yolov8-small.yaml").train with the IR recipe of train_small_targets.py:16-45
   (TRAIN_RECIPE: imgsz 640, batch 16, AdamW lr0 8e-4, bf16 `amp`, 8 loader threads; epochs
   3 and close_mosaic 1 instead of 150 and 20): per epoch the losses, P, R, mAP50, mAP50-95,
   epoch and validation seconds; train images/s, the per-step split (loader wait; forward +
   loss, backward, optimizer + BN + EMA in CUDA events), peak memory and the launches of
   check_amp and the validations. `[train step f32]`: one f32 step on the card and on the
   CPU from the same tree and batch, held to TRAIN_STEP_TOL. `[train finetune]` (report
   only): YOLO(best.npz), the demo's trained weights, one epoch of the recipe, mAP before
   and after. `[train val kernels]`: both trained models validated in f32 through the
   kernels and the twins, held as `[val kernels]` holds them.
16. the newer paths, each with best.npz at full width and each f32 run through the kernels held
   against the same run through the twins at the f32 gates (1e-2 px, conf 1e-4), kernels 1, 2, 3
   and 5 held against their twins on one frame's activations at the path's shapes (TOL, NMS bit
   for bit; `hold_path_kernels`): `[pipeline options]` (right after `[pipeline]`): `run_clip` in
   bf16 with collect_outputs=False and with prefetch 1 and 4, stats equal to `[pipeline]`'s;
   `[tiled]`: the clip's first 32 frames as BGR through `ops.tiling.tiled_predict` (tile 256,
   overlap 0.25: 9 tiles a frame in one batch, padded to B = 16), f32 then bf16 timed; `[tta]`:
   the 32 frames through `predict(augment=True, imgsz=640)` (640, 544 and 448 square on the
   device), the launches per shape; `[ensemble]`: `YOLO([best.npz, last.npz])` over them;
   `[embed]`: `YOLO.embed` of them (vectors within 1e-4), ms/frame; `[enhance]`:
   `otherplan.enhance_small_targets_torch` on 64 frames on the card against the host's cv2
   enhancement and against itself on the CPU (1e-3, equal `classical_detect` boxes); `[detect_only]`
   and `[single target]`: the clip's first 32 frames as an mp4v file through
   `otherplan.detect_only` and `run_single_target_tracking` with the port's YOLO as the detector.
17. the detect task's last settings (`int8_pipeline_phase`, right after `[pipeline options]`):
   `[pipeline int8]` (calibrated on the clip's first chunk) on the 256-frame clip: f32 through the
   NMS kernel against f32 through its twin (tracks, ids, statuses, detection counts and stats
   equal, boxes 1e-2 px), the frames whose detection count differs from `[pipeline]`'s f32 run
   (reported), then bf16 timed beside `[pipeline]`'s frames/s with its launches (kernel 5 only).
   After `[predict]`: `[predict int8]`, `[predict visualize]` (the files written) and `[predict
   show]` (no display: one warning, the same Results). Last, `[train settings]`: a 4-step epoch
   each of the default, remat and multi_scale + RAM cache + mosaic9 + cutmix (losses, device ms a
   step, peak memory), then `train(batch=-1)` at 640: autobatch's pick with the trainer's step as
   its probe, and one epoch of full batches at that pick (finite losses, peak memory).
18. the slice of YOLO.benchmark, YOLO.tune, COCOeval and the classify task: `[track botsort reid]`
   (after `[track botsort]`): the BoT-SORT run with its crop-and-embed ReID encoder on
   (`model: yolov8n.yaml`, the GMC off), f32 kernels (detector and encoder) against the twins, then
   bf16 timed with the encoder's host ms/frame; `[benchmark]` (after `[detect_only]`): best.npz's
   decoded forward at 640², B = 8 and 32, f32 kernels against twins with kernels 1, 2, 3 and 5 held
   at those activations, then `YOLO.benchmark(imgsz=640)` in bf16 and f32 and `benchmark_formats`;
   `[val coco]` (after `[val]`): the 256-frame split with a COCO annotations file, `save_json=True`,
   the COCOeval keys against a rerun on the written files; `[tune]` (after `[train settings]`): two
   iterations of `YOLO("yolov8-small.yaml").tune` on a 32-frame split at 640; `[classify]` (last):
   yolov8n-cls at full width, predict f32 kernel against twin then bf16, the C2f kernel held at its
   four instances (f32 and bf16, B = 1 and 32), 3 epochs of training on a seeded 4-class folder
   dataset (top1 >= 0.9) and `val` through the kernel against the twin.
19. the segment task (last; `segment_phases`), on a seeded polygon dataset (`write_seg_split`: 256 train and
   64 val 640x512 IR-like frames as BGR, 1-4 bright ellipses each, some overlapping, nc 1): `[segment train]`
   (YOLO("yolov8n-seg.yaml") from the JAX package's init(0), rebuilt at nc 1, SEG_RUN: 3 epochs at batch 16,
   640, bf16, AdamW lr0 8e-4: losses and box / mask metrics per epoch, images/s over the call, the step's split,
   peak memory), `[segment train step f32]` (one f32 step on the card against the CPU, TRAIN_STEP_TOL),
   `[segment val kernels]` (f32 kernels against twins: every box and mask key within 1e-4; then bf16 images/s),
   `[segment predict]` (the 64 val frames one per call, each frame's ten best detections, f32 kernels against
   twins with retina_masks off and on: boxes 1e-2 px, conf 1e-4, each mask's IoU >= 0.99; then bf16 frames/s
   with the host split) and `[segment forward]` (yolov8n-seg at full width, nc 80, 640², B = 8 and 32: preds,
   coefficients and prototypes of the kernels against the twins, NMS with the coefficients as extras, kernels
   1, 2, 3 and 5 held at those activations). Each phase launches kernels 1, 2, 3 and 5.
20. the pose task (last; `pose_phases`), on a seeded keypoint dataset (`write_pose_split`: 256 train and 64 val
   640x512 IR-like frames as BGR, 1-3 bright stick figures each with COCO's 17 keypoints in coco8-pose.yaml's order
   and flip_idx, some at visibility 1 and some at 0, nc 1): `[pose train]` (YOLO("yolov8n-pose.yaml") from the JAX
   package's init(0), POSE_RUN: 3 epochs at batch 16, 640, bf16, AdamW lr0 8e-4: the five losses and box / pose
   metrics per epoch, images/s over the call, the step's split, peak memory), `[pose train step f32]` (one f32 step
   on the card against the CPU, TRAIN_STEP_TOL), `[pose val kernels]` (f32 kernels against twins: every box and
   `pose_` key within 1e-4; then bf16 images/s), `[pose predict]` (the 64 val frames one per call, each frame's ten
   best, f32 kernels against twins: boxes 1e-2 px, conf 1e-4, keypoint x, y 1e-2 px, visibility 1e-4; then bf16
   frames/s with the host split), `[pose forward]` (yolov8n-pose at full width, nc 1, 640², B = 8 and 32: preds of
   the kernels against the twins, NMS with the 51 keypoint rows as extras kernel against twin bit for bit, kernels
   1, 2, 3 and 5 held at those activations) and `[pose track]` (YOLO.track of the trained model over the 64 frames,
   ByteTrack at thresholds fitted to its scores: rows, ids and each track's keypoints of the kernels equal the twins';
   `[segment track]` the same with the segment phases' model and each track's mask; then bf16 frames/s). Each phase
   launches kernels 1, 2, 3 and 5.
21. the obb task (last; `obb_phases`), on a seeded rotated dataset (`write_obb_split`: 256 train and 64 val 640x512
   IR-like frames as BGR, 1-4 bright rotated rectangles each, elongated like aircraft (aspect 2-6, 20-160 px long) at
   uniform angles, two classes (solid and hollow), a third of the frames with an overlapping pair; DOTA rows):
   `[obb train]` (YOLO("yolov8n-obb.yaml") from the JAX package's init(0), rebuilt at nc 2, OBB_RUN: 3 epochs at batch
   16, 640, bf16, AdamW lr0 8e-4: the three losses and the metrics per epoch, images/s over the call, the step's split,
   peak memory), `[obb train step f32]` (one f32 step on the card against the CPU, TRAIN_STEP_TOL), `[obb val kernels]`
   (f32 kernels against twins: every key within 1e-4; then bf16 images/s), `[obb predict]` (the 64 val frames one per
   call, each frame's ten best, f32 kernels against twins: centres and sizes 1e-2 px, angles 1e-4 rad, conf 1e-4; then
   bf16 frames/s with the host split), `[obb forward]` (yolov8n-obb at full width, nc 15 as DOTAv1, 640², B = 8 and 32:
   preds of the kernels against the twins, kernels 1, 2 and 3 held at those activations, the card's rotated NMS at
   K = 1024 against the same function on the CPU, and its time beside the forward's) and `[obb track]` (YOLO.track of
   the trained model over a clip of the 64 frames, ByteTrack at thresholds fitted to its scores: rows (xywhr), ids
   and classes of the kernels equal the twins'; then bf16 frames/s). Each phase launches kernels 1, 2 and 3 and not
   kernel 5: the rotated NMS is plain torch (it is not greedy).
22. the seventeenth slice (last; `slice17_phases`, ~50 s): the segment, pose and obb entry points on the JAX
   package's init(0) trees at full width, each f32 through the kernels against the twins first, then bf16 timed
   with its launches: `[task benchmark]` (the decoded forward at 640², B = 8, then `YOLO.benchmark(imgsz=640)`'s
   rows at B = 1 / 8 / 32), `[task int8]` (`predict(int8=True)` of 16 frames: kernel 5 against its twin, the int8
   tree's predictions on the card against the CPU's at the 99.9th percentile, 0.05 px and 1e-3), `[task tiled]`
   (segment and pose, one 640x512 frame, tile 256: the merged boxes, kernels 1, 2, 3 and 5 held on the tiles),
   `[task serve]` (a server with a segment and a pose lane, the obb lane out of service) and `[task tune]` (segment,
   two one-epoch iterations on a 32-frame polygon split); then the v8 variants: `[variants]` (yolov8n-p6, -seg-p6,
   -pose-p6 at 1280² on frames of 1280x1024, ghost-p2 and ghost at 640x512, cls-resnet50 at 224: the decoded
   forward against the twins, kernels 1, 3 and 5 held at the p6 and ghost-p2 shapes on seeded noise through trees
   whose BN moments come from it (`bn_calibrated`), each held instance's twin depending on its input
   (`live_share`), bf16 predict with its host split), `[pipeline ghost-p2]`
   (FusedDetectTrack with yolov8n-ghost-p2's init(0) tree over 64 frames, conf 1e-6: tracks, ids and stats equal,
   detections on every frame), `[variants train]` (one epoch of yolov8n-ghost-p2 at 640, batch 16, bf16: the
   step's split; the trained tree's forward against the twin) and `[variants train step f32]` (one f32 step of
   yolov8n-ghost-p2 on the card against the CPU, TRAIN_STEP_TOL; `zero_grad_leaves` against their BN weight's gradient).
23. the eighteenth slice (last; `slice18_phases`): the yolo11 and yolo12 families, whose C3k2 blocks are walked
   module by module and whose Detect heads are not legacy, so that kernels 1-4 launch no time on them (each phase
   checks it) and kernel 5 is their one kernel. Trees: init(0) with BN moments from seeded noise (`bn_calibrated`).
   `[yolo11]` and `[yolo12]` (yolo11n / yolo12n at 640²: f32 on the card against the f64 forward within 4x the CPU's
   f32, `card_against_f64`; kernel 5 against its twin on those scores with its `live_share`; bf16 predict at B = 1 and 8, frames/s,
   the host's ms a frame, the device's launches and busy time a call; then track, launching kernel 5), `[yolo11
   tasks]` (seg, pose, obb and cls of both: the decoded forward at B = 8, `card_against_f64`; seg and pose: kernel 5
   held, then predict, val and track launching it), `[yolo11 train]` / `[yolo12 train]` (one bf16 epoch at batch 16, 640: finite losses, the step's
   split, then val through kernel 5 against its twin) and `[yolo11 train step f32]` (one f32 step on the card against
   the CPU, TRAIN_STEP_TOL; yolo12n's is left out, `slice18_phases` says why).
24. the nineteenth slice (`slice19_phases`): yolov3, yolov6, YOLO-NAS and yolov9 at full width (`[v3 v6 v9 nas]`,
   `[v3 v6 v9 nas others]`, `[pipeline v9 head_cm]`, `[pipeline nas]`, one epoch each of yolov9t and yolo_nas_s).
25. the twentieth slice (`slice20_phases`): `[v8 scales]` (yolov8 s-x and yolov8-small m-x at full width,
   whose wide C2f blocks take the kernel's general plan: the f32 forward against the f64 forward, kernels 1-3 held
   with the live gate, bf16 predict launching kernels 1, 2, 3 and 5), `[v10]` (yolov10n and yolov10s: the end-to-end
   rows against the f64 forward's, kernels 1 and 2 held with the live gate, bf16 predict at B = 1 and 8, val, track;
   kernels 3-5 launch no time: the head is depth-wise and NMS-free), `[v10 others]` (m, b, l, x: the same holds,
   predict of 4 frames) and `[yolov10n.yaml train]` (one bf16 epoch: its six loss items, the step's split, then val
   through kernels 1-2 against the twins). `[c2f widths]` (with the kernel holds of item 2) holds kernels 1-2 against
   their twins at every published C2f width (`cuda_c2f.C2F_WIDTHS`), f32 and bf16, with each plan (tile, passes, ring
   chunk, shared bytes) and the widest instance of each model timed against the cuDNN walk and the bound.
26. the twenty-first slice (last; `slice21_phases`): `[rtdetr]` (rtdetr-l at full width: the f32 rows against the
   f64 forward's, paired by class and box, and the f32 query selection's sets against the f64 forward's; bf16 and f32
   predict at B = 1 and 8 with the device's launches a call and the decoder's grid-sample share; val; track),
   `[rtdetr others]` (rtdetr-x, -resnet50, -resnet101 and yolov8l-rtdetr, whose C2f rows and folded necks hold
   kernels 1-2 against their twins with the live gate; predict of 4 frames; kernels 3-5 launch no time on any RT-DETR
   path: the head is a decoder and NMS-free), `[rtdetr-l.yaml train]` (one bf16 epoch: giou / cls / l1, the step's
   split with the host's Hungarian match, val) and `[yolo11-cls-resnet18]` (predict at 224, one epoch on `[classify]`'s
   images; no kernel).
27. the twenty-second slice (`slice22_phases`): `[text tower]`, `[world]` x2, `[yoloe]` x3, two close-set epochs.
28. the twenty-third slice (last; `slice23_phases`): `[sam]` (sam_b at 1024, JAX's init(0) woken by `awake_sam`, on
   a 640x512 BGR clip frame: point and box prompts, the embedding, low-res logits and IoU f32 against f64 within 4x
   the CPU's f32 distance, logit signs ≥ SIGN_AGREE; encode / decode ms; `generate` at its defaults and unfiltered
   with the host split), `[mobile_sam]` (the same), `[sam2]` (sam2_t: the image prompts held so; video propagation of
   8 clip frames at 1024² and 4 backward, each frame against the f64 run; `generate` refused), `[sam variants]`
   (sam_l, sam_h, sam2_s, sam2_b: `info()` equal to JAX's count, a point prompt against f64, encode ms, peak
   memory), `[fastsam]` (FastSAM-s and -x at 640 on a calibrated tree: kernels 1, 2, 3 and 5 held with the live gate;
   everything mode and bbox / point / text prompts on 8 BGR frames, f32 kernels against twins; bf16 frames/s) and
   `[clip vision]` (the seeded ViT-B/32 vision tower, card against CPU). No SAM path launches a kernel.
With `--profile`, after the torch.profiler table: `[c2f plans]` launches the
C2f kernel with every candidate tile and ring step the plan's cost model rates
within 3x of its choice (at most 40), per instance, dtype and batch (128 and
1), and prints the model's choice beside the fastest measured one, and what
the model would choose with each of its constants set to a neutral value;
`[c2f trace]` builds the kernel with its cycle counters compiled in and prints
where one interior block's first warp spends its cycles, stage by stage;
`[head plans]` and `[head trace]` do the same for the head kernel's plan (the
four captured levels, B = 128 and 1) and its stages; `[val workers]` times the bf16 `[val]`
call with 1 to 16 loader threads, and the validator's device pass alone; `[train profile]`
records the device's work over one epoch of `[train]` (the device only: host tracing slows
the steps tenfold) and sets it against an unprofiled step: the device's idle share; `[train step precision]` sets
yolo11n's and yolo12n's f32 train steps (card, card without cuDNN, CPU) against the same step in float64.
Every kernel of a path must have been launched in that path's run. The last
three lines are the `kernels` JSON line, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
# kernel vs plain twin, (atol, rtol): f32 differs only in summation order;
# bf16 rounds every intermediate map, and a one-ulp flip travels down a C2f chain
TOL = {"float32": (1e-3, 1e-3), "bfloat16": (6e-2, 6e-2)}
# the channel-major head's cls output is a sigmoid score, far below 1e-3 on background
# pixels: it is held to a tighter absolute tolerance than the maps and distances, and
# again as a logit, where background and target pixels weigh alike (bf16: two ulps of
# the logit the kernel rounded before its sigmoid, 2 * 2^-7 of its size)
CLS_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (2e-3, 6e-2)}
LOGIT_TOL = {"float32": (1e-3, 0.0), "bfloat16": (6e-2, 1.6e-2)}
FRAMES, CHUNK, HW = 256, 128, (512, 640)  # cut from 512 (PR 17) to keep the script inside half its time limit
PREDICT_FRAMES = 16  # cut to fit the run's time limit (PERF.md §4)
TRACK_FRAMES = 16  # cut to fit the run's time limit (PERF.md §4)
TASK_TRACK_FRAMES = 32  # the segment / pose / obb tracks' moving clips (their near-ties settle at this length)
MOTION_FRAMES = 108  # config 5: a sixth of the reference's clip length, 649 (demos/motion_comp_bench.py); cut to fit the run's time limit
MOTION_COMPARE_FRAMES = 64
GRAY_FRAMES, GRAY_TEST_RANGE = 96, (32, 80)  # frames cut from 128 to fit the run's time limit
VAL_HELDOUT, VAL_FRAMES = (32, 10_000), (64, 20_000)  # validation splits: frames, seed (val cut from 128 to fit the time limit)
KERNEL_ROWS = {  # name → (route, source, the TPU kernel's entry it replaces)
    "c2f": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:264"),
    "c2f_upconcat": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:290"),
    "head_level": ("cuda", "yolo_tpu_torch/csrc/head.cu", "yolo_tpu/ops/pallas_head.py:203"),
    "head_level_cm": ("cuda", "yolo_tpu_torch/csrc/head_cm.cu", "yolo_tpu/ops/pallas_head2.py:117"),
    "nms_keep": ("cuda", "yolo_tpu_torch/csrc/nms.cu", "yolo_tpu/ops/pallas_nms.py:56"),
}


def cv2_version() -> str | None:
    """cv2's version where it imports, else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    return out.stdout.strip().splitlines()[0]


def compute_dtype(half: bool) -> str:
    """The predict setting that goes with `half`: predict computes in bf16 unless asked for f32."""
    return "bfloat16" if half else "float32"


START = time.perf_counter()  # the script's clock: each result line ends with its time on it


def log(tag: str, card: str, msg: str) -> None:
    """One result line, tagged with the card it was measured on, ending with the script's time when it was printed
    (the differences between lines are the phases' times)."""
    print(f"[{tag} | {card}] {msg} [at {time.perf_counter() - START:.1f} s]")


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(call, reps: int = 20) -> float:
    """The device's time per call of `call`, without the host's: `reps` calls
    captured in one CUDA graph, whose replays are timed by events."""
    import torch

    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    return cuda_ms(g.replay, iters=10, warmup=2) / reps


def make_clip(n: int, h: int, w: int, seed: int = 0):
    """Seeded synthetic IR clip made on the card: smooth cloudy background, sensor
    noise and three bright 4-px-sigma targets on straight tracks, two of them
    hidden for a stretch (the tracker must coast). → (n, h, w, 1) uint8 numpy."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    bg = torch.randn((1, 1, h // 16, w // 16), generator=g, device="cuda") * 10 + 30
    bg = F.interpolate(bg, size=(h, w), mode="bicubic", align_corners=False)[0, 0]
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij")
    targets = [  # x0, y0, vx, vy, hidden frames
        (60.0, 100.0, 0.9, 0.3, range(150, 200)),
        (560.0, 420.0, -0.8, -0.4, range(300, 330)),
        (320.0, 60.0, 0.1, 0.6, range(0)),
    ]
    frames = torch.empty((n, h, w), dtype=torch.uint8, device="cuda")
    for f in range(n):
        img = bg + torch.randn((h, w), generator=g, device="cuda") * 2
        for x0, y0, vx, vy, hidden in targets:
            if f not in hidden:
                cx, cy = x0 + vx * f, y0 + vy * f
                img = img + 170 * torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2))
        frames[f] = img.clamp(0, 255).to(torch.uint8)
    return frames.cpu().numpy()[..., None]


# ---------------------------------------------------------------- phase 2 --


def capture_instances(model, x):
    """Run the plain forward once and record every kernel call's inputs, in order."""
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head

    rec = []
    originals = (cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain)

    def c2f(x, kw, shortcut):
        rec.append(("c2f", (x, kw, shortcut)))
        return originals[0](x, kw, shortcut)

    def up(small, skip, kw, shortcut):
        rec.append(("c2f_upconcat", (small, skip, kw, shortcut)))
        return originals[1](small, skip, kw, shortcut)

    def head(x, kw):
        rec.append(("head_level", (x, kw)))
        return originals[2](x, kw)

    cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain = c2f, up, head
    try:  # an end-to-end head (yolov10), RT-DETR's decoder or a YOLOE segment head has no parts: its own rows, no NMS held
        rows = getattr(model, "end2end", False) or getattr(model, "is_rtdetr", False) or getattr(model, "segment", False)
        boxes, scores = (model.predict(x, plain=True), None) if rows else model.predict_parts(x, plain=True)
    finally:
        cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain = originals
    return rec, boxes, scores


def _oihw(w_flat, k, dtype):
    import torch

    cout = w_flat.shape[-1]
    return w_flat.reshape(k, k, -1, cout).permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)


def library_c2f(kw, shortcut, dtype):
    """cuDNN conv walk of one C2f on NCHW channels_last maps (bias inside the conv)."""
    import torch
    import torch.nn.functional as F

    w1, wm, w2 = _oihw(kw.w1, 1, dtype), [_oihw(w, 3, dtype) for w in kw.wm], _oihw(kw.w2, 1, dtype)
    b1, bm, b2 = kw.b1.to(dtype), kw.bm.to(dtype), kw.b2.to(dtype)

    def walk(x):
        y = F.silu(F.conv2d(x, w1, b1))
        parts = list(y.chunk(2, 1))
        for i in range(kw.n):
            t = F.silu(F.conv2d(parts[-1], wm[2 * i], bm[2 * i], padding=1))
            t = F.silu(F.conv2d(t, wm[2 * i + 1], bm[2 * i + 1], padding=1))
            parts.append(parts[-1] + t if shortcut else t)
        return F.silu(F.conv2d(torch.cat(parts, 1), w2, b2))

    return walk


def library_head(kw, dtype):
    import torch.nn.functional as F

    w0, w1r, w1c = _oihw(kw.w0, 3, dtype), _oihw(kw.w1r, 3, dtype), _oihw(kw.w1c, 3, dtype)
    w2r, w2c = _oihw(kw.w2r, 1, dtype), _oihw(kw.w2c, 1, dtype)
    b = [t.to(dtype) for t in (kw.b0, kw.b1r, kw.b1c, kw.b2r, kw.b2c)]
    proj = kw.proj.to(dtype)

    def walk(x):
        u = F.silu(F.conv2d(x, w0, b[0], padding=1))
        r = F.silu(F.conv2d(u[:, : kw.c2], w1r, b[1], padding=1))
        c = F.silu(F.conv2d(u[:, kw.c2 :], w1c, b[2], padding=1))
        bins = F.conv2d(r, w2r, b[3])
        B, _, H, W = bins.shape
        dist = F.softmax(bins.reshape(B, 4, kw.reg_max, H, W).float(), 2).to(dtype).transpose(2, 4) @ proj
        return dist, F.conv2d(c, w2c, b[4])

    return walk


def library_head_cm(kw, dtype):
    """The channel-major level as library calls: the conv walk + softmax DFL, then the sigmoid."""
    import torch

    walk = library_head(kw, dtype)

    def walk_cm(x):
        dist, logits = walk(x)
        return dist, torch.sigmoid(logits.float())

    return walk_cm


def _nchw(x):
    import torch

    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _logit(score):
    """Sigmoid scores (f32) → their logits, in f64."""
    import torch

    s = score.double().clamp(1e-38, 1 - 2.0**-24)
    return torch.log(s) - torch.log1p(-s)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: int, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_candidates(boxes_xywh, scores, conf, max_nms):
    """The suppression tail's inputs, as ops/nms.non_max_suppression_parts forms them."""
    import torch

    from yolo_tpu_torch.ops.boxes import xywh2xyxy
    from yolo_tpu_torch.ops.nms import MAX_WH

    c, cls_id = scores.max(-1)
    c = torch.where(c > conf, c, -1.0)
    top, idx = torch.sort(c, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_nms].contiguous(), idx[:, :max_nms]
    b = xywh2xyxy(torch.gather(boxes_xywh, 1, idx[..., None].expand(-1, -1, 4)))
    off = torch.gather(cls_id, 1, idx).to(b.dtype) * MAX_WH
    return (b + off[..., None]).contiguous(), top


def nms_iou_count(boxes, thr) -> int:
    """IoU evaluations the greedy walk needs on these candidates: K-1-i for every
    candidate i that is not suppressed when its turn comes."""
    import torch

    from yolo_tpu_torch.ops.boxes import box_iou

    B, K, _ = boxes.shape
    over = box_iou(boxes, boxes) > thr
    later = torch.arange(K, device=boxes.device)
    sup = torch.zeros((B, K), dtype=torch.bool, device=boxes.device)
    for i in range(K):
        sup |= over[:, i, :] & (later > i) & ~sup[:, i : i + 1]
    return int(((~sup).float() * (K - 1 - later).float()).sum())


def nms_edges_phase(card):
    """`[nms edges]`: the NMS kernel against its twin, bit for bit, at the port's
    edge shapes (ops/cuda_nms.py NMS_EDGES: B = 1 and 128, K = 1 to 4096, both
    forms of the plan) on seeded candidates with ties, duplicates and padding.
    The twin takes 16 images at a time (its IoU matrix is B x K x K floats)."""
    import torch

    from yolo_tpu_torch.ops import cuda_nms

    for B, K in cuda_nms.NMS_EDGES:
        boxes, scores = cuda_nms.edge_candidates(B, K, seed=K, device="cuda")
        got = cuda_nms.nms_keep(boxes, scores, 0.5)
        want = torch.cat([cuda_nms.nms_keep_plain(boxes[i : i + 16], scores[i : i + 16], 0.5) for i in range(0, B, 16)])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms edges: B={B} K={K}: keep mask differs from the twin in {int((got != want).sum())} slots")
        ms = cuda_ms(lambda: cuda_nms.nms_keep(boxes, scores, 0.5), iters=20, warmup=2)
        log("nms edges", card, f"B={B:<3d} K={K:<4d} kept={int(got.sum())} valid={int((scores > 0).sum())} equal to the twin; "
            f"{cuda_nms.plan_text(B, K)} kernel_ms={ms:.4f}")


def c2f_plan_text(B, H, W, c1, cs, kw, dtype) -> str:
    from yolo_tpu_torch.ops import cuda_c2f

    p = cuda_c2f.plan(B, H, W, c1, cs, kw.c, kw.w2.shape[1], kw.n, dtype)
    text = (f"tile={p['tile'][0]}x{p['tile'][1]} blocks={p['blocks']} cluster={p['cluster']} per_sm={p['blocks_per_sm']} "
            f"smem={p['smem']}B {p['instruction']}")
    text += f" item={p['item_px']}px ring={p['ring_steps']}x{p['step_slices']}" if p["ring_steps"] else ""
    if p["ring_steps"] and p["ring_chunk"] < (kw.c + 15) // 16 * 16:
        text += f" ring_chunk={p['ring_chunk']}"
    if p["passes"] > 1:  # a split plan: the chain's passes, then the cv2 launch
        text += (f" passes={p['passes']} ({p['pass_bottlenecks']} bottleneck(s) each, then cv2 at tile="
                 f"{p['tail_tile'][0]}x{p['tail_tile'][1]}" + (f" ring_chunk={p['tail_chunk']}x{p['tail_step_slices']}"
                                                               if p["ring_steps"] else "") + f") workspace={p['workspace']}")
    return text


def c2f_edges_phase(card):
    """The C2f kernel against its plain twin, f32 and bf16, on seeded random
    weights and inputs at the port's list of edge shapes. A disagreement raises."""
    import numpy as np
    import torch

    from yolo_tpu_torch.nn import modules as PM
    from yolo_tpu_torch.ops import cuda_c2f

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        atol, rtol = TOL[dn]
        for c1, c2, n, shortcut, cs, B, H, W in cuda_c2f.EDGE_SHAPES:
            rng = np.random.default_rng(0)
            mod = PM.C2f(c1, c2, n=n, shortcut=shortcut)
            for m in mod.modules():
                if isinstance(m, PM.ConvBNAct):
                    fan_in = m.weight[0].numel()
                    m.weight = torch.from_numpy(rng.uniform(-1, 1, tuple(m.weight.shape)) / np.sqrt(fan_in)).float().to("cuda", dtype)
                    m.bias = torch.from_numpy(rng.normal(0, 0.1, tuple(m.bias.shape))).float().to("cuda", dtype)
            kw = mod.kernel_weights()
            skip = torch.from_numpy(rng.normal(0, 1, (B, H, W, c1 - cs))).float().to("cuda", dtype)
            if cs:
                small = torch.from_numpy(rng.normal(0, 1, (B, H // 2, W // 2, cs))).float().to("cuda", dtype)
                got, want = cuda_c2f.fused_c2f_upconcat(small, skip, kw, shortcut), cuda_c2f.c2f_upconcat_plain(small, skip, kw, shortcut)
            else:
                got, want = cuda_c2f.fused_c2f(skip, kw, shortcut), cuda_c2f.c2f_plain(skip, kw, shortcut)
            torch.cuda.synchronize()
            desc = f"B={B} {H}x{W} {f'up({cs})+{c1 - cs}' if cs else c1}->{c2} n={n}{' shortcut' if shortcut else ''}"
            err = float((got.float() - want.float()).abs().max())
            if got.shape != want.shape or not torch.isfinite(got).all() or not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
                raise AssertionError(f"c2f edges {dn}: {desc} disagrees with the plain twin (atol {atol}, rtol {rtol}), max |err| {err}")
            log(f"c2f edges {dn}", card, f"{desc:44s} max_abs_err={err:.3e} {c2f_plan_text(B, H, W, c1, cs, kw, dtype)}")


def head_plan_text(B, H, W, C, kw, dtype) -> str:
    from yolo_tpu_torch.ops import cuda_head

    p = cuda_head.plan(B, H, W, C, kw.c2, kw.c3, kw.nc, dtype)
    text = (f"tile={p['tile'][0]}x{p['tile'][1]} blocks={p['blocks']} tiles={p['tiles']} per_sm={p['blocks_per_sm']} "
            f"smem={p['smem']}B {p['instruction']}")
    return text + (f" ring={p['ring_steps']}x{p['slot_bytes']}B" if p["ring_steps"] else "")


def head_fns(name):
    """(kernel wrapper, plain twin) of a head kernel by its KERNEL_ROWS name."""
    from yolo_tpu_torch.ops import cuda_head, cuda_head_cm

    if name == "head_level_cm":
        return cuda_head_cm.head_level_cm, cuda_head_cm.head_level_cm_plain
    return cuda_head.fused_head_level, cuda_head.head_level_plain


def hold(name, desc, dn, got, want) -> dict:
    """Hold a kernel's outputs against its twin's at the stated tolerances (the
    channel-major head's scores also as logits) → max |err| by output; raises."""
    import torch

    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    atol, rtol = TOL[dn]
    held = [(f"output {i}", g_.float(), w_.float(), atol, rtol) for i, (g_, w_) in enumerate(zip(got, want))]
    if name == "head_level_cm":
        held = [("dist", *held[0][1:]), ("cls", *held[1][1:3], *CLS_TOL[dn]),
                ("cls as logit", _logit(got[1]), _logit(want[1]), *LOGIT_TOL[dn])]
    errs = {}
    for label, g_, w_, at, rt in held:
        if g_.shape != w_.shape or not torch.isfinite(g_).all():
            raise AssertionError(f"{name} {desc} {dn}: {label}: shape {tuple(g_.shape)} vs {tuple(w_.shape)} or non-finite")
        errs[label] = float((g_ - w_).abs().max())
        if not torch.allclose(g_, w_, atol=at, rtol=rt):
            raise AssertionError(f"{name} {desc} {dn}: {label} disagrees with the plain twin "
                                 f"(atol {at}, rtol {rt}), max |err| {errs[label]}")
    return errs


def head_level_bound(x, kw, got, dn):
    """The least time of one head level on the card: its input, weights and outputs at the memory rate, or its
    multiply-adds (two operations each) at the peak rate of `dn`, whichever is longer → (ms, 'bytes' | 'operations')."""
    import torch

    B, H, W, C = x.shape
    macs = H * W * (9 * C * (kw.c2 + kw.c3) + 9 * kw.c2 * kw.c2 + 9 * kw.c3 * kw.c3 + kw.c2 * 4 * kw.reg_max + kw.c3 * kw.nc)
    wbytes = _nbytes(*(t for k, t in vars(kw).items() if torch.is_tensor(t) and not k.startswith("_")))
    return _bound(_nbytes(x, *got) + wbytes, 2.0 * B * macs, dn)


def head_edges_phase(card):
    """`[head edges]`: both head kernels against their twins, f32 and bf16, on
    seeded random levels at the port's list of edge shapes (ops/cuda_head.py
    HEAD_EDGES). A disagreement raises. At the legacy heads' widths (HEAD_WIDTHS: yolov3, -tiny, yolov9) the head
    kernel's ms beside its twin's, the cuDNN conv walk's and the level's bound."""
    import numpy as np
    import torch

    from yolo_tpu_torch.ops import cuda_head

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B, H, W, C, c2, c3, nc in cuda_head.HEAD_EDGES:
            kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=0, device="cuda", dtype=dtype)
            x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (B, H, W, C))).float().to("cuda", dtype)
            desc = f"B={B} {H}x{W} C={C} c2={c2} c3={c3} nc={nc}"
            for name in ("head_level", "head_level_cm"):
                kern, plain = head_fns(name)
                got, want = kern(x, kw), plain(x, kw)
                torch.cuda.synchronize()
                errs = hold(name, desc, dn, got, want)
                times = ""
                if name == "head_level" and (B, H, W, C, c2, c3, nc) in cuda_head.HEAD_WIDTHS:
                    bound, by = head_level_bound(x, kw, got, dn)
                    lib = library_head(kw, dtype)
                    xl = _nchw(x)
                    times = (f" kernel_ms={cuda_ms(lambda: kern(x, kw)):.4f} plain_ms={cuda_ms(lambda: plain(x, kw)):.4f} "
                             f"library_ms(cudnn walk)={cuda_ms(lambda: lib(xl)):.4f} bound_ms={bound:.4f} ({by})")
                log(f"head edges {dn}", card, f"{name:14s} {desc:40s} max_abs_err="
                    + "/".join(f"{v:.3e}" for v in errs.values()) + f" {head_plan_text(B, H, W, C, kw, dtype)}" + times)


def head_plan_sweep(cases, card, within=3.0, most=40):
    """`[head plans]`: the head plan's cost model against the card, as `[c2f
    plans]` does for C2f: per captured Detect level, dtype and batch (a chunk,
    one frame), every candidate tile the model rates within `within` of its
    choice (the `most` cheapest) is launched and timed; then the model's choice
    with its constant `barrier` at 0."""
    import torch

    from yolo_tpu_torch.ops import cuda_head

    key = lambda p: (p["th"], p["tw"])  # noqa: E731
    show = lambda k: f"{k[0]}x{k[1]}"  # noqa: E731
    for dn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for B in (CHUNK, 1):
            total = {"model": 0.0, "fastest": 0.0, "without barrier": 0.0}
            for x, kw in cases[dn]:
                x = x[:B]
                _, H, W, C = x.shape
                shape = (B, H, W, C, kw.c2, kw.c3, kw.nc, dtype)
                timed = {}

                def ms(k):
                    if k not in timed:
                        run = lambda: cuda_head._launch(x, kw, cm=False, force=k)  # noqa: E731
                        timed[k] = cuda_ms(run, iters=3, warmup=1)
                        if timed[k] < 0.5:  # a short kernel: enough launches in a row that the host's gaps do not count
                            timed[k] = cuda_ms(run, iters=30, warmup=3)
                    return timed[k]

                def choice(model):
                    cands = cuda_head.candidates(*shape, model=model)
                    return key(min(cands, key=lambda p: p["cost"])), cands

                pick, cands = choice(None)
                if pick != cuda_head.plan(*shape)["tile"]:
                    raise AssertionError(f"head plans: the candidates' cheapest {pick} is not the plan's tile for {shape}")
                floor = min(p["cost"] for p in cands)
                near = sorted({key(p): p["cost"] for p in cands if p["cost"] <= within * floor}.items(), key=lambda kv: kv[1])[:most]
                for k, _ in near:
                    ms(k)
                fastest = min(timed, key=timed.get)
                alt = choice({"barrier": 0.0})[0]
                total["model"] += ms(pick)
                total["fastest"] += timed[fastest]
                total["without barrier"] += ms(alt)
                log(f"head plans {dn}", card, f"B={B:<3d} {H}x{W} C={C:<4d} model {show(pick)} {ms(pick):.4f} ms | fastest of "
                    f"{len(near)} {show(fastest)} {timed[fastest]:.4f} ms ({ms(pick) / timed[fastest]:.3f}x), then "
                    + " ".join(f"{show(k)} {v:.4f}" for k, v in sorted(timed.items(), key=lambda kv: kv[1])[1:4])
                    + (f" | without barrier: {show(alt)} {ms(alt):.4f}" if alt != pick else ""))
            log(f"head plans {dn}", card, f"B={B}: sum over the levels, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))


def head_stage_trace(cases, card):
    """`[head trace]`: the bf16 head kernel built with -DYT_HEAD_TRACE. Per
    captured Detect level at chunk size, the cycles that thread 0 of one
    interior block spent per stage (input staging, the first conv, the reg
    second conv with its 1x1 and DFL as its epilogue, the cls second conv with
    its 1x1 as its epilogue), split into waits for its copies, the block
    barriers, copy issue, the product loop, the epilogues and the rest, per
    tile of that block, with the level's kernel time in that build."""
    import ctypes

    import torch

    from yolo_tpu_torch.ops import _cuda, cuda_head

    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(_cuda.build(extra=("-DYT_HEAD_TRACE",))))
    lib.yt_head_set_trace.argtypes = [ctypes.c_void_p]
    log("head trace", card, f"traced build in {time.perf_counter() - t0:.1f} s")
    stages = ("staging", "first conv", "reg 3x3 | 1x1+DFL", "cls 3x3 | 1x1")
    slots = ("copy wait", "barrier", "copy issue", "loop", "epilogue", "other")
    buf = torch.zeros((4 * 7 + 1,), dtype=torch.int64, device="cuda")
    for x, kw in cases:
        _, H, W, C = x.shape
        desc = f"{H}x{W} C={C}"
        run = lambda: cuda_head._launch(x, kw, cm=False, lib=lib)  # noqa: E731
        kms = cuda_ms(run)  # also warms L2 with the weights and the input, as in a run of chunks
        torch.cuda.synchronize()
        buf.zero_()
        lib.yt_head_set_trace(buf.data_ptr())
        run()
        torch.cuda.synchronize()
        lib.yt_head_set_trace(None)
        v = buf.cpu().tolist()
        tiles = max(v[-1], 1)
        rows = [v[7 * s_ : 7 * s_ + 7] for s_ in range(4)]
        whole = sum(sum(r[:6]) for r in rows)
        for stage, r in zip(stages, rows):
            log("head trace", card, f"{desc:16s} {stage:18s} steps/tile={r[6] / tiles:<5.1f} "
                + " ".join(f"{s_}={v_ / tiles:.0f}" for s_, v_ in zip(slots, r)) + f" sum={sum(r[:6]) / tiles:.0f}")
        log("head trace", card, f"{desc:16s} block: {tiles} tiles, {whole / tiles:.0f} cycles/tile, kernel "
            f"{kms:.4f} ms; shares: " + ", ".join(f"{s_} {sum(r[i] for r in rows) / whole:.3f}" for i, s_ in enumerate(slots))
            + f"; reg loop {rows[2][3] / tiles:.0f} cycles/tile")


def _c2f_case(name, args, B):
    """A captured C2f call cut to B frames → (x or skip, small or None, kw, shortcut, description)."""
    if name == "c2f":
        x, kw, sc = args
        small = None
    else:
        small, x, kw, sc = args
        small = small[:B]
    x = x[:B]
    cs = 0 if small is None else small.shape[-1]
    desc = f"{x.shape[1]}x{x.shape[2]} {f'up({cs})+{x.shape[-1]}' if cs else x.shape[-1]}->{kw.w2.shape[1]} n={kw.n}"
    return x, small, kw, sc, desc


def c2f_plan_sweep(cases, card, within=3.0, most=40):
    """`[c2f plans]`: the plan's cost model against the card. Per captured C2f
    instance, dtype and batch (a chunk, one frame), every candidate the model
    rates within `within` of its choice (the `most` cheapest) is launched and
    timed; the line gives the model's choice and the fastest candidate. Then each
    constant of the model is set to its neutral value in turn, and the choice the
    model would then make is timed too. The sums say what each constant is worth."""
    import torch

    from yolo_tpu_torch.ops import cuda_c2f

    neutral = {"barrier": 0.0, "shared": 1.0}
    key = lambda p: (p["th"], p["tw"], p["step_slices"])  # noqa: E731
    show = lambda k: f"{k[0]}x{k[1]}" + (f" ring 2x{k[2]}" if k[2] else "")  # noqa: E731
    sums = {}
    for dn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for B in (CHUNK, 1):
            total = sums.setdefault((dn, B), {"model": 0.0, "fastest": 0.0, **{f"without {k}": 0.0 for k in neutral}})
            for name, args in cases[dn]:
                x, small, kw, sc, desc = _c2f_case(name, args, B)
                shape = (B, x.shape[1], x.shape[2], kw.w1.shape[0], 0 if small is None else small.shape[-1], kw.c, kw.w2.shape[1], kw.n, dtype)
                timed = {}

                def ms(k):
                    if k not in timed:
                        run = lambda: cuda_c2f._launch(x, small, kw, sc, force=k)  # noqa: E731
                        timed[k] = cuda_ms(run, iters=3, warmup=1)
                        if timed[k] < 0.5:  # a short kernel: enough launches in a row that the host's gaps do not count
                            timed[k] = cuda_ms(run, iters=30, warmup=3)
                    return timed[k]

                def choice(model):
                    cands = cuda_c2f.candidates(*shape, model=model)
                    return key(min(cands, key=lambda p: p["cost"])), cands  # the first of least cost, as the plan takes it

                pick, cands = choice(None)
                if pick[:2] != cuda_c2f.plan(*shape)["tile"]:
                    raise AssertionError(f"c2f plans: the candidates' cheapest {pick} is not the plan's tile for {desc}")
                floor = min(p["cost"] for p in cands)
                near = sorted({key(p): p["cost"] for p in cands if p["cost"] <= within * floor}.items(), key=lambda kv: kv[1])[:most]
                for k, _ in near:
                    ms(k)
                fastest = min(timed, key=timed.get)
                without = {k: choice({k: v})[0] for k, v in neutral.items()}
                total["model"] += ms(pick)
                total["fastest"] += timed[fastest]
                for k, alt in without.items():
                    total[f"without {k}"] += ms(alt)
                log(f"c2f plans {dn}", card, f"B={B:<3d} {desc:30s} model {show(pick)} {ms(pick):.4f} ms | fastest of {len(near)} "
                    f"{show(fastest)} {timed[fastest]:.4f} ms ({ms(pick) / timed[fastest]:.3f}x), then "
                    + " ".join(f"{show(k)} {v:.4f}" for k, v in sorted(timed.items(), key=lambda kv: kv[1])[1:4]) + " | "
                    + ", ".join(f"without {k}: {show(alt)} {ms(alt):.4f}" for k, alt in without.items() if alt != pick))
    for (dn, B), total in sums.items():
        log(f"c2f plans {dn}", card, f"B={B}: sum over the instances, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))


def c2f_stage_trace(cases, card):
    """`[c2f trace]`: the bf16 kernel built with -DYT_C2F_TRACE. Per captured
    instance at chunk size, the cycles that thread 0 of one interior block spent,
    per GEMM of the block: waiting for its own copies, at the block barriers,
    issuing copies, in the ldmatrix + mma loop, in the epilogues and in the rest
    (zeroing, item set-up), with the ring steps it took."""
    import ctypes

    import torch

    from yolo_tpu_torch.ops import _cuda, cuda_c2f

    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(_cuda.build(extra=("-DYT_C2F_TRACE",))))
    lib.yt_c2f_set_trace.argtypes = [ctypes.c_void_p]
    log("c2f trace", card, f"traced build in {time.perf_counter() - t0:.1f} s")
    slots = ("copy wait", "barrier", "copy issue", "loop", "epilogue", "other")
    buf = torch.zeros((16, 7), dtype=torch.int64, device="cuda")
    for name, args in cases:
        x, small, kw, sc, desc = _c2f_case(name, args, CHUNK)
        stages = ["cv1 y_a", "cv1 y_b"] + [f"m{i}.cv{j}" for i in range(kw.n) for j in (1, 2)]
        stages += [f"cv2[{o}]" for o in range(-(-kw.w2.shape[1] // (-(-kw.c // 16) * 16)))]
        cuda_c2f._launch(x, small, kw, sc, lib=lib)  # warm: the weights and this block's input are in L2, as in a run of chunks
        torch.cuda.synchronize()
        buf.zero_()
        lib.yt_c2f_set_trace(buf.data_ptr())
        cuda_c2f._launch(x, small, kw, sc, lib=lib)
        torch.cuda.synchronize()
        lib.yt_c2f_set_trace(None)
        rows = buf.cpu().tolist()[: len(stages)]
        whole = sum(sum(r[:6]) for r in rows)
        for stage, r in zip(stages, rows):
            log("c2f trace", card, f"{desc:30s} {stage:8s} steps={r[6]:<4d} " + " ".join(f"{s}={v}" for s, v in zip(slots, r)) + f" sum={sum(r[:6])}")
        log("c2f trace", card, f"{desc:30s} block    steps={sum(r[6] for r in rows):<4d} cycles={whole} shares: "
            + ", ".join(f"{s} {sum(r[i] for r in rows) / whole:.3f}" for i, s in enumerate(slots)))


def check_kernels(model, params, frames, card, d_max=16, keep=None):
    """Phase 2: every kernel against its plain twin at the main path's shapes → per-kernel records (bf16).
    `keep`, a dict, receives the captured C2f calls by dtype name and, under "head " + that name, the
    captured Detect levels (for `--profile`)."""
    import torch

    from yolo_tpu_torch import FusedDetectTrack
    from yolo_tpu_torch.ops import cuda_c2f, cuda_nms

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        atol, rtol = TOL[dn]
        ft = FusedDetectTrack(model, params, frame_hw=HW, chunk=CHUNK, d_max=d_max, dtype=dtype, plain=True)
        x = torch.from_numpy(frames).cuda().to(dtype)
        rec, boxes, scores = capture_instances(ft.model, x)
        nb = sum(1 for name, _ in rec if name == "c2f")
        log(f"kernels {dn}", card, f"captured {len(rec)} kernel calls from a {tuple(x.shape)} chunk ({nb} c2f)")
        if keep is not None:
            keep[dn] = [(name, args) for name, args in rec if name.startswith("c2f")]
            keep["head " + dn] = [args for name, args in rec if name == "head_level"]
        # every captured Detect level is also a case of the channel-major head kernel
        cases = [c for name, args in rec for c in ([(name, args)] + ([("head_level_cm", args)] if name == "head_level" else []))]
        for name, args in cases:
            if name == "c2f":
                xin, kw, sc = args
                B, H, W, c1 = xin.shape
                kern = lambda: cuda_c2f.fused_c2f(xin, kw, sc)  # noqa: E731
                plain = lambda: cuda_c2f.c2f_plain(xin, kw, sc)  # noqa: E731
                lib, lib_in = library_c2f(kw, sc, dtype), _nchw(xin)
                macs = H * W * (c1 * 2 * kw.c + kw.n * 18 * kw.c * kw.c + (2 + kw.n) * kw.c * kw.w2.shape[1])
                ins = (xin,)
                desc = f"{H}x{W} {c1}->{kw.w2.shape[1]} n={kw.n}{' shortcut' if sc else ''}"
                tile = c2f_plan_text(B, H, W, c1, 0, kw, dtype)
            elif name == "c2f_upconcat":
                small, skip, kw, sc = args
                B, H, W, ck = skip.shape
                cs = small.shape[-1]
                kern = lambda: cuda_c2f.fused_c2f_upconcat(small, skip, kw, sc)  # noqa: E731
                plain = lambda: cuda_c2f.c2f_upconcat_plain(small, skip, kw, sc)  # noqa: E731
                walk = library_c2f(kw, sc, dtype)
                lib_small, lib_skip = _nchw(small), _nchw(skip)

                def lib(_, walk=walk, s=lib_small, k=lib_skip):
                    return walk(torch.cat([torch.nn.functional.interpolate(s, scale_factor=2.0), k], 1))

                lib_in = None
                macs = (H // 2) * (W // 2) * cs * 2 * kw.c + H * W * (
                    ck * 2 * kw.c + kw.n * 18 * kw.c * kw.c + (2 + kw.n) * kw.c * kw.w2.shape[1]
                )
                ins = (small, skip)
                desc = f"{H}x{W} up({cs})+{ck}->{kw.w2.shape[1]} n={kw.n}"
                tile = c2f_plan_text(B, H, W, cs + ck, cs, kw, dtype)
            else:
                xin, kw = args
                B, H, W, C = xin.shape
                kfn, pfn = head_fns(name)
                kern = lambda: kfn(xin, kw)  # noqa: E731
                plain = lambda: pfn(xin, kw)  # noqa: E731
                lib, lib_in = (library_head_cm if name == "head_level_cm" else library_head)(kw, dtype), _nchw(xin)
                tile = head_plan_text(B, H, W, C, kw, dtype)
                macs = H * W * (9 * C * (kw.c2 + kw.c3) + 9 * kw.c2 * kw.c2 + 9 * kw.c3 * kw.c3
                                + kw.c2 * 4 * kw.reg_max + kw.c3 * kw.nc)
                ins = (xin,)
                desc = f"{H}x{W} C={C}"
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs = hold(name, desc, dn, got, want)
            got = (got,) if torch.is_tensor(got) else got
            err = max(v for k, v in errs.items() if k != "cls as logit")
            ms, pms = cuda_ms(kern), cuda_ms(plain)
            lms = cuda_ms(lambda: lib(lib_in))
            wbytes = _nbytes(*(t for k, t in vars(kw).items() if torch.is_tensor(t) and not k.startswith("_")))
            bound, by = _bound(_nbytes(*ins, *got) + wbytes, 2.0 * B * macs, dn)
            log(
                f"kernels {dn}", card,
                f"{name:14s} {desc:32s} {tile} "
                f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms(cudnn walk)={lms:.4f} "
                f"bound_ms={bound:.4f} ({by})"
            )
            if name.startswith("c2f"):
                # the per-frame predict path gives the kernel the same instance with one frame: another plan
                one = [t[:1] for t in ins]
                fused = cuda_c2f.fused_c2f if name == "c2f" else cuda_c2f.fused_c2f_upconcat
                plain1 = cuda_c2f.c2f_plain if name == "c2f" else cuda_c2f.c2f_upconcat_plain
                g1, w1 = fused(*one, kw, sc).float(), plain1(*one, kw, sc).float()
                torch.cuda.synchronize()
                err1 = float((g1 - w1).abs().max())
                if g1.shape != w1.shape or not torch.isfinite(g1).all() or not torch.allclose(g1, w1, atol=atol, rtol=rtol):
                    raise AssertionError(f"{name} {desc} {dn} at B=1: disagrees with the plain twin (atol {atol}, rtol {rtol}), "
                                         f"max |err| {err1}")
                log(f"kernels {dn}", card, f"{name:14s} {desc:32s} B=1: {c2f_plan_text(1, H, W, kw.w1.shape[0], kw.w1.shape[0] - ins[-1].shape[-1], kw, dtype)} "
                    f"max_abs_err={err1:.3e} kernel_ms={cuda_ms(lambda: fused(*one, kw, sc)):.4f}")
            if name.startswith("head"):
                # the per-frame predict path gives the kernel the same level with one frame: another plan
                e1 = hold(name, desc + " B=1", dn, kfn(xin[:1], kw), pfn(xin[:1], kw))
                log(f"kernels {dn}", card, f"{name:14s} {desc:32s} B=1: {head_plan_text(1, H, W, C, kw, dtype)} max_abs_err="
                    + "/".join(f"{v:.3e}" for v in e1.values()) + f" kernel_ms={cuda_ms(lambda: kfn(xin[:1], kw)):.4f}")
            if name == "head_level_cm":
                cls = want[1].float().abs()
                for k, v in errs.items():
                    log(f"kernels {dn}", card, f"{name:14s} {desc:32s} {k:12s} max_abs_err={v:.3e}"
                        + (f" (scores: max {float(cls.max()):.3e}, median {float(cls.median()):.3e})" if k == "cls" else ""))
            if dtype == torch.bfloat16:
                r = records.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                                                  ops_ms=0.0, bytes_ms=0.0))
                r["ms"] += ms
                r["plain_ms"] += pms
                r["library_ms"] += lms
                r["bound_ms"] += bound
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ops_ms" if by == "operations" else "bytes_ms"] += bound
        # NMS: the candidates of this chunk (K = max_nms = 64 at d_max = 16)
        cand, top = nms_candidates(boxes, scores, ft.conf, ft.max_nms)
        B, K, _ = cand.shape
        got = cuda_nms.nms_keep(cand, top, ft.iou)
        want = cuda_nms.nms_keep_plain(cand, top, ft.iou)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep {dn}: keep mask differs from the plain twin in {int((got != want).sum())} slots")
        ms = cuda_ms(lambda: cuda_nms.nms_keep(cand, top, ft.iou), iters=50, warmup=5)
        pms = cuda_ms(lambda: cuda_nms.nms_keep_plain(cand, top, ft.iou))
        n_iou = nms_iou_count(cand, ft.iou)
        bound, by = _bound(_nbytes(cand, top) + B * K, 12.0 * n_iou, "float32")
        log(
            f"kernels {dn}", card,
            f"nms_keep      B={B} K={K} kept={int(got.sum())} valid={int((top > 0).sum())} {cuda_nms.plan_text(B, K)} "
            f"max_abs_err=0 kernel_ms={ms:.4f} (device, graph: {graph_ms(lambda: cuda_nms.nms_keep(cand, top, ft.iou)):.4f}) "
            f"plain_ms={pms:.4f} library_ms=null bound_ms={bound:.5f} ({by}; {n_iou} IoUs x 12 f32 ops)"
        )
        # the predict facade's NMS: K = max_nms = 1024 candidates of one frame at its conf 0.15, as each
        # predict launches it, and over 8 frames at a low threshold
        for nb, conf in ((1, ft.conf), (8, 0.01)):
            cand1k, top1k = nms_candidates(boxes[:nb], scores[:nb], conf, 1024)
            got1k = cuda_nms.nms_keep(cand1k, top1k, ft.iou)
            want1k = cuda_nms.nms_keep_plain(cand1k, top1k, ft.iou)
            torch.cuda.synchronize()
            if not torch.equal(got1k, want1k):
                raise AssertionError(f"nms_keep {dn} B={nb} K=1024: keep mask differs in {int((got1k != want1k).sum())} slots")
            log(f"kernels {dn}", card, f"nms_keep      B={nb} K=1024 conf={conf} kept={int(got1k.sum())} "
                f"valid={int((top1k > 0).sum())} {cuda_nms.plan_text(nb, 1024)} max_abs_err=0 kernel_ms="
                f"{cuda_ms(lambda: cuda_nms.nms_keep(cand1k, top1k, ft.iou), iters=50, warmup=5):.4f} (device, graph: "
                f"{graph_ms(lambda: cuda_nms.nms_keep(cand1k, top1k, ft.iou)):.4f}) plain_ms="
                f"{cuda_ms(lambda: cuda_nms.nms_keep_plain(cand1k, top1k, ft.iou), iters=2, warmup=1):.4f}")
        if dtype == torch.bfloat16:
            records["nms_keep"] = dict(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound, max_abs_err=0.0,
                                       ops_ms=bound if by == "operations" else 0.0,
                                       bytes_ms=bound if by == "bytes" else 0.0)
    return records


# ---------------------------------------------------------------- phase 3 --


def make_pipeline(model, params, dtype, plain, head_cm=False, channels=1):
    from yolo_tpu_torch import FusedDetectTrack

    return FusedDetectTrack(model, params, frame_hw=HW, channels=channels, chunk=CHUNK, conf=0.15, iou=0.6, n_max=64,
                            d_max=16, dtype=dtype, plain=plain, pallas_head2=head_cm)


def launch_counters() -> dict:
    """name → the wrapper whose `launches` attribute counts that kernel's launches."""
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm, cuda_nms

    return {"c2f": cuda_c2f.fused_c2f, "c2f_upconcat": cuda_c2f.fused_c2f_upconcat, "head_level": cuda_head.fused_head_level,
            "head_level_cm": cuda_head_cm.head_level_cm, "nms_keep": cuda_nms.nms_keep}


def counted(path_kernels, run):
    """Set every launch count to 0, drive one path with `run()`, read the counts
    just after: every kernel of the path must have launched, no other head kernel may have."""
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    result = run()
    launches = {k: f.launches for k, f in counters.items()}
    for k, v in launches.items():
        if (v <= 0) if k in path_kernels else (v != 0):
            raise AssertionError(f"kernel {k}: {v} launches on a path of {sorted(path_kernels)}")
    return result, launches


def timed_run(ft, clip):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, stats = ft.run_clip(clip)  # ends in one device synchronisation
    return outs, stats, time.perf_counter() - t0


def pipeline_phase(tag, model, params, clip, card, head_cm):
    """FusedDetectTrack on the clip: f32 kernels against f32 twins, then the timed bf16 run → its launch counts."""
    import torch

    ok_, sk, wk = timed_run(make_pipeline(model, params, torch.float32, plain=False, head_cm=head_cm), clip)
    op_, sp, wp = timed_run(make_pipeline(model, params, torch.float32, plain=True, head_cm=head_cm), clip)
    worst = compare_runs(ok_, op_, sk, sp)
    log(f"{tag} f32", card, f"kernels {sk} in {wk:.2f} s | plain {sp} in {wp:.2f} s | tracks, ids, statuses, detection "
        f"counts, stats equal; max |box/conf/vel diff| {worst:.3e}")

    ft = make_pipeline(model, params, torch.bfloat16, plain=False, head_cm=head_cm)
    ft.run_clip(clip[:CHUNK])  # warm-up: cuDNN plans, allocator, first launches
    ft.reset()
    ft.timings = []
    path = {"c2f", "c2f_upconcat", "nms_keep", "head_level_cm" if head_cm else "head_level"}
    (ob, sb, wb), launches = counted(path, lambda: timed_run(ft, clip))
    split = {}
    for marks in ft.timings:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    same = sum(int((a["det_count"] == b["det_count"]).sum()) for a, b in zip(ob, ok_))
    log(f"{tag} bf16", card, f"{sb}; {FRAMES} frames in {wb:.3f} s = {FRAMES / wb:.1f} frames/s end to end (host clock, "
        f"upload included); device split per {FRAMES} frames: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; tracker {split.get('tracker', 0.0) / FRAMES:.3f} ms/frame; det_count equal to f32 on {same}/{FRAMES} frames")
    log(f"{tag} bf16", card, f"kernel launches in that run: {launches}")
    if not all(len(o["bbox"]) == CHUNK and o["bbox"].shape[1:] == (64, 4) for o in ob):
        raise AssertionError("unexpected packed output shape")
    return ft, launches, (ob, sb), (ok_, sk), FRAMES / wb


def bgr_phase(model, params, clip, card):
    """FusedDetectTrack on 3-channel BGR frames (no gray fold; the flip to RGB
    on the card), one chunk: f32 through the kernels against f32 through the
    twins, then bf16 with the launch counts."""
    import numpy as np
    import torch

    bgr = np.repeat(clip[:CHUNK], 3, -1)
    bgr[..., 0] //= 2  # unequal channels, so the stem's three input planes all matter
    ok_, sk, _ = timed_run(make_pipeline(model, params, torch.float32, plain=False, channels=3), bgr)
    op_, sp, _ = timed_run(make_pipeline(model, params, torch.float32, plain=True, channels=3), bgr)
    worst = compare_runs(ok_, op_, sk, sp)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (_, sb, wb), launches = counted(path, lambda: timed_run(make_pipeline(model, params, torch.bfloat16, plain=False, channels=3), bgr))
    if sk["detection_frames"] <= 0:
        raise AssertionError(f"the 3-channel pipeline detected nothing: {sk}")
    log("pipeline bgr", card, f"f32 kernels {sk} | plain equal in tracks, ids, statuses, detection counts, stats; max |box/conf/vel "
        f"diff| {worst:.3e}; bf16 {sb} in {wb:.3f} s (cold), launches {launches}")


def batched_tracker_phase(card):
    """BatchedMultiTargetTracker (the host wrapper of the batched Kalman step)
    on the card against the same wrapper on the CPU, on a seeded sequence of
    three moving boxes with dropout gaps: `update` frame by frame over the
    first frames, then `scan_frames` over the rest."""
    import numpy as np

    from yolo_tpu_torch.kalman.batched import STATUS_PREDICTED, BatchedMultiTargetTracker

    rng = np.random.default_rng(0)
    T, T_UPDATE, D = 96, 32, 16
    boxes, mask = np.zeros((T, D, 4), np.float32), np.zeros((T, D), bool)
    targets = [(60.0, 100.0, 2.5, 0.8, range(20, 40)), (560.0, 420.0, -2.0, -1.0, range(50, 70)), (320.0, 60.0, 0.3, 1.5, range(0))]
    for t in range(T):
        seen = [(x0 + vx * t, y0 + vy * t) for x0, y0, vx, vy, hidden in targets if t not in hidden]
        for i, (cx, cy) in enumerate(seen):
            cx, cy = cx + rng.normal(0, 0.3), cy + rng.normal(0, 0.3)
            boxes[t, i], mask[t, i] = (cx - 6, cy - 6, cx + 6, cy + 6), True
    trackers = [BatchedMultiTargetTracker(n_max=64, d_max=D, device=dev) for dev in ("cuda", "cpu")]
    worst, n_tracks = 0.0, 0
    for t in range(T_UPDATE):
        dets = [[*b, 0.9] for b, m in zip(boxes[t], mask[t]) if m]
        got, want = (tr.update(dets) for tr in trackers)
        if [(g["track_id"], g["status"], g["time_since_update"]) for g in got] != [(w["track_id"], w["status"], w["time_since_update"]) for w in want]:
            raise AssertionError(f"batched tracker update, frame {t}: the card's tracks differ from the CPU's")
        for g, w in zip(got, want):
            worst = max(worst, float(np.abs(g["bbox"] - w["bbox"]).max()), float(np.abs(g["velocity"] - w["velocity"]).max()))
        n_tracks += len(got)
    got, want = (tr.scan_frames(boxes[T_UPDATE:], mask[T_UPDATE:]) for tr in trackers)
    for k in ("emit", "status", "track_num", "time_since_update"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"batched tracker scan_frames: '{k}' on the card differs from the CPU's")
    emit = got["emit"]
    for k in ("bbox", "velocity", "confidence"):
        worst = max(worst, float(np.abs(got[k][emit] - want[k][emit]).max()))
    predicted = int((got["status"][emit] == STATUS_PREDICTED).sum())
    if worst > 1e-2 or n_tracks <= 0 or not emit.any() or predicted <= 0:
        raise AssertionError(f"batched tracker: max diff {worst}, {n_tracks} tracks from update, {int(emit.sum())} emitted, {predicted} coasting")
    log("batched tracker", card, f"update x{T_UPDATE} ({n_tracks} tracks) and scan_frames x{T - T_UPDATE} ({int(emit.sum())} emitted, "
        f"{predicted} coasting) on the card equal the CPU's in ids, statuses and ages; max |box/vel/conf diff| {worst:.3e}")


def predict_phase(clip, card):
    """`YOLO(best.npz).predict`, one 3-channel frame at a time, into the clip loop
    with the per-object Kalman trackers: f32 through the kernels against f32
    through the twins, then bf16, timed (each predict ends in a device wait,
    so the host clock sees all of it)."""
    import contextlib
    import io

    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.kalman.multi_tracker import EnhancedMultiTargetTracker
    from yolo_tpu_torch.kalman.pipeline import track_clip, yolo_detector

    frames = np.repeat(clip[:PREDICT_FRAMES], 3, -1)  # BGR copies of the IR frames

    def run(half, plain):
        detect = yolo_detector(YOLO(str(WEIGHTS)).fuse(), 0.15, imgsz=640, iou=0.6, half=half, plain=plain,
                               compute_dtype=compute_dtype(half))
        detect(frames[0])  # warm-up: cuDNN plans, allocator, first launches
        seen, spent = [], {"detect": 0.0, "track": 0.0}

        def detector(frame):
            t0 = time.perf_counter()
            seen.append(detect(frame))
            spent["detect"] += time.perf_counter() - t0
            return seen[-1]

        class Timed(EnhancedMultiTargetTracker):
            def update(self, detections):
                t0 = time.perf_counter()
                tracks = super().update(detections)
                spent["track"] += time.perf_counter() - t0
                return tracks

        with contextlib.redirect_stdout(io.StringIO()):  # the trackers narrate every track they open and lose
            tracker = Timed(max_lost_frames=150, min_hits=1, iou_threshold=0.1)
            t0 = time.perf_counter()
            stats = track_clip(iter(frames), detector, tracker, total_frames=len(frames))
            wall = time.perf_counter() - t0
        return seen, stats, wall, spent

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (dk, sk, wk, _), _ = counted(path, lambda: run(half=False, plain=False))
    dp, sp, wp, _ = run(half=False, plain=True)
    if [len(d) for d in dk] != [len(d) for d in dp]:
        raise AssertionError(f"detections per frame differ: kernels {[len(d) for d in dk]} vs plain {[len(d) for d in dp]}")
    worst = max([float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) for a, b in zip(dk, dp) if a] or [0.0])
    if worst > 1e-2:
        raise AssertionError(f"boxes of the kernel and plain runs differ by {worst} px")
    details = lambda s: [{k: v for k, v in d.items() if k != "confidence"} for d in s["tracker"]["tracker_details"]]  # noqa: E731
    head = lambda s: {**{k: v for k, v in s.items() if k != "tracker"}, **{k: v for k, v in s["tracker"].items() if k != "tracker_details"}}  # noqa: E731
    if head(sk) != head(sp) or details(sk) != details(sp):
        raise AssertionError(f"clip stats differ: kernels {sk} vs plain {sp}")
    if sk["frames"] != PREDICT_FRAMES or sk["detection_frames"] <= 0 or sum(len(d) for d in dk) <= 0:
        raise AssertionError(f"the predict path detected nothing: {head(sk)}")
    log("predict f32", card, f"kernels {head(sk)} in {wk:.2f} s | plain in {wp:.2f} s | detections per frame and stats equal "
        f"({sum(len(d) for d in dk)} detections); max |box/conf diff| {worst:.3e}")
    (db, sb, wb, spent), launches = counted(path, lambda: run(half=True, plain=False))
    same = sum(len(a) == len(b) for a, b in zip(db, dk))
    log("predict bf16", card, f"{head(sb)}; {PREDICT_FRAMES} frames in {wb:.3f} s = {PREDICT_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per predict); predict {spent['detect'] / PREDICT_FRAMES * 1e3:.3f} ms/frame, per-object tracker "
        f"{spent['track'] / PREDICT_FRAMES * 1e3:.3f} ms/frame; detections equal to f32 on {same}/{PREDICT_FRAMES} frames")
    log("predict bf16", card, f"kernel launches in that run: {launches}")


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, then restore them."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def track_run(frames, tracker, half, plain, device_tracker=False, d_max=320, n_max=512, encoder_s=None):
    """`YOLO(best.npz).track` one BGR frame per call with persist=True at the track
    defaults (conf 0.1, max_det 300, imgsz 640) → (Results rows per frame, wall s,
    tracker s, tracker class). The tracker is made first, as the first call would
    make it (create_tracker), so that its update can be timed; one predict warms up.
    A BoT-SORT ReID encoder embeds through the C2f kernel's twin too with `plain`, is
    warmed up on one crop, and adds its host seconds to `encoder_s["encoder"]`."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.trackers.track import create_tracker

    with environ(YOLO_TPU_DEVICE_TRACKER=int(device_tracker), YOLO_TPU_DEVICE_TRACKER_DMAX=d_max,
                 YOLO_TPU_DEVICE_TRACKER_NMAX=n_max):
        model = YOLO(str(WEIGHTS))
        # cuDNN plans, allocator, first launches
        model.predict(frames[0], conf=0.1, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False)
        model._tracker = trk = create_tracker(tracker, device=model.device)
    encoder = getattr(trk, "encoder", None)
    if encoder is not None:
        if plain:
            embed = encoder.model.embed
            encoder.model.embed = lambda *a, **k: embed(*a, plain=True, **k)
        encoder(frames[0], np.array([[64.0, 64.0, 32.0, 32.0]], np.float32))  # plans, cuDNN, allocator
        time_calls(trk, "encoder", encoder_s if encoder_s is not None else {})
    spent, update = [0.0], trk.update

    def timed_update(*args, **kw):
        t0 = time.perf_counter()
        out = update(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    trk.update = timed_update
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for frame in frames:
        rows.append(model.track(frame, persist=True, tracker=tracker, half=half, plain=plain, compute_dtype=compute_dtype(half),
                                verbose=False)[0].boxes.data)
    return rows, time.perf_counter() - t0, spent[0], type(trk).__name__


def compare_tracks(got, want, box_tol, conf_tol, what):
    """Per frame: equal row counts, equal ids, boxes within box_tol px, conf within
    conf_tol (rows in id order) → (largest box difference, tracked rows, distinct ids)."""
    import numpy as np

    worst, n_rows, ids = 0.0, 0, set()
    for f, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}, frame {f}: rows {g.shape} vs {w.shape}")
        if g.shape[-1] == 7:
            g, w = g[np.argsort(g[:, 4], kind="stable")], w[np.argsort(w[:, 4], kind="stable")]
            if not np.array_equal(g[:, 4], w[:, 4]):
                raise AssertionError(f"{what}, frame {f}: ids {g[:, 4]} vs {w[:, 4]}")
            n_rows += len(g)
            ids |= set(g[:, 4].tolist())
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - w[:, :4]).max()))
            if worst > box_tol or float(np.abs(g[:, -2] - w[:, -2]).max()) > conf_tol or not np.array_equal(g[:, -1], w[:, -1]):
                raise AssertionError(f"{what}, frame {f}: boxes / conf / cls beyond {box_tol} px / {conf_tol}:\n{g}\n{w}")
    return worst, n_rows, ids


def track_phase(tag, clip, card, tracker):
    """`[track bytetrack]` / `[track botsort]`: YOLO.track over the clip's first
    TRACK_FRAMES frames as BGR, f32 through the kernels against f32 through the
    twins (rows, ids, boxes 1e-2 px, conf 1e-4), then bf16, timed → the f32 kernel rows."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rk, wk, _, name), _ = counted(path, lambda: track_run(frames, tracker, half=False, plain=False))
    rp, wp, _, _ = track_run(frames, tracker, half=False, plain=True)
    worst, n_rows, ids = compare_tracks(rk, rp, 1e-2, 1e-4, f"{tag}: kernels against plain")
    if n_rows <= 0:
        raise AssertionError(f"{tag}: no tracked rows in {TRACK_FRAMES} frames")
    log(f"{tag} f32", card, f"{name}: kernels in {wk:.2f} s | plain in {wp:.2f} s | rows and ids equal on every frame "
        f"({n_rows} tracked rows, ids {sorted(int(i) for i in ids)}); max |box diff| {worst:.3e} px")
    (rb, wb, tb, _), launches = counted(path, lambda: track_run(frames, tracker, half=True, plain=False))
    same = sum(len(a) == len(b) for a, b in zip(rb, rk))
    log(f"{tag} bf16", card, f"{TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} frames/s (host clock, one frame "
        f"per track call); predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, tracker {tb / TRACK_FRAMES * 1e3:.3f} ms/frame; "
        f"rows per frame equal to f32 on {same}/{TRACK_FRAMES} frames; kernel launches {launches}")
    return rk


def track_device_phase(clip, card, host_rows):
    """`[track device]`: the bytetrack run with YOLO_TPU_DEVICE_TRACKER=1, the batched
    twin on the card: rows match the host tracker's under the JAX package's contract
    (ids exact, 2e-2); then its bf16 ms/frame at the default capacities and at 16 / 64."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rd, _, _, name), _ = counted(path, lambda: track_run(frames, "bytetrack.yaml", half=False, plain=False, device_tracker=True))
    if name != "BatchedBYTETracker":
        raise AssertionError(f"track device: YOLO_TPU_DEVICE_TRACKER=1 made a {name}")
    worst, n_rows, _ = compare_tracks(rd, host_rows, 2e-2, 2e-2, "track device: the batched twin against the host tracker")
    log("track device f32", card, f"BatchedBYTETracker on the card (d_max 320, n_max 512): {n_rows} tracked rows, rows and ids "
        f"equal to [track bytetrack]'s host tracker on every frame; max |box diff| {worst:.3e} px")
    for d_max, n_max in ((320, 512), (16, 64)):
        (rb, wb, tb, _), launches = counted(
            path, lambda: track_run(frames, "bytetrack.yaml", half=True, plain=False, device_tracker=True, d_max=d_max, n_max=n_max))
        log("track device bf16", card, f"d_max {d_max} n_max {n_max}: {TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} "
            f"frames/s; predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, batched tracker update {tb / TRACK_FRAMES * 1e3:.3f} "
            f"ms/frame (host clock, ends in its copy to the host); tracked rows {sum(len(r) for r in rb if r.shape[-1] == 7)}; "
            f"kernel launches {launches}")


def reid_tracker_yaml(path: Path) -> Path:
    """The shipped botsort.yaml with the GMC off and the ReID encoder on (`model: yolov8n.yaml`), at `path`."""
    text = (ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "botsort.yaml").read_text()
    text = text.replace("gmc_method: sparseOptFlow", "gmc_method: none").replace("with_reid: False", "with_reid: True")
    text = "\n".join("model: yolov8n.yaml" if line.startswith("model:") else line for line in text.splitlines()) + "\n"
    if "with_reid: True" not in text or "model: yolov8n.yaml" not in text:
        raise AssertionError(f"botsort.yaml no longer has the with_reid / model keys this phase sets:\n{text}")
    path.write_text(text)
    return path


def track_reid_phase(clip, card):
    """`[track botsort reid]`: YOLO(best.npz).track over the first TRACK_FRAMES BGR frames with BoT-SORT's
    crop-and-embed ReID encoder (`YOLO("yolov8n.yaml").embed` of each detection's crop at imgsz 128, on the
    card, f32, through the C2f kernel; the JAX package's initial tree) and the GMC off: f32 kernels (the
    detector's and the encoder's) against the twins (rows and ids equal, boxes 1e-2 px, conf 1e-4), then the
    bf16 detector, timed: frames/s, predict, tracker and the encoder's host ms/frame, launches."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = str(reid_tracker_yaml(Path(tmp) / "botsort_reid.yaml"))
        enc_k, enc_p, enc_b = {}, {}, {}
        (rk, wk, _, name), launches_f32 = counted(path, lambda: track_run(frames, cfg, half=False, plain=False, encoder_s=enc_k))
        rp, wp, _, _ = track_run(frames, cfg, half=False, plain=True, encoder_s=enc_p)
        worst, n_rows, ids = compare_tracks(rk, rp, 1e-2, 1e-4, "track botsort reid: kernels against plain")
        if n_rows <= 0 or not enc_k.get("encoder") or not enc_p.get("encoder"):
            raise AssertionError(f"track botsort reid: {n_rows} tracked rows, encoder seconds {enc_k} / {enc_p}")
        log("track botsort reid f32", card, f"{name} + ReID(yolov8n.yaml, imgsz 128): kernels in {wk:.2f} s | plain in {wp:.2f} s | "
            f"rows and ids equal on every frame ({n_rows} tracked rows, ids {sorted(int(i) for i in ids)}); max |box diff| "
            f"{worst:.3e} px; encoder {enc_k['encoder'] * 1e3 / TRACK_FRAMES:.3f} ms/frame (twins "
            f"{enc_p['encoder'] * 1e3 / TRACK_FRAMES:.3f}); launches {launches_f32}")
        (rb, wb, tb, _), launches = counted(path, lambda: track_run(frames, cfg, half=True, plain=False, encoder_s=enc_b))
    same = sum(len(a) == len(b) for a, b in zip(rb, rk))
    enc = enc_b["encoder"]
    log("track botsort reid bf16", card, f"{TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per track call); predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, tracker {(tb - enc) / TRACK_FRAMES * 1e3:.3f} "
        f"ms/frame and its ReID encoder {enc / TRACK_FRAMES * 1e3:.3f} ms/frame (f32); rows per frame equal "
        f"to f32 on {same}/{TRACK_FRAMES} frames; kernel launches {launches}")


def byte_scan_phase(model, params, clip, card):
    """`[byte scan]`: the JAX package's device_fps_byte_track shape. Per 128-frame
    chunk, frames already on the card: the bf16 forward (predict_parts, the default
    head kernel), NMS with d_max 16, xyxy → xywh with cls 0, then
    BatchedBYTETracker(n_max 64, d_max 16, max_time_lost 30).scan_frames. The
    outputs must equal `update` frame by frame on the same detections, and the
    same scan on the CPU (ids exact, 1e-4)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.ops.nms import non_max_suppression_parts
    from yolo_tpu_torch.trackers.batched import BatchedBYTETracker

    ft = make_pipeline(model, params, torch.bfloat16, plain=False)
    chunks = [torch.from_numpy(clip[i : i + CHUNK]).cuda() for i in range(0, FRAMES, CHUNK)]

    def run(trk, marks=None):
        dets, outs = [], []
        with torch.no_grad():
            for frames in chunks:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                boxes, scores = ft.model.predict_parts(frames.to(ft.dtype), plain=False)
                ev[1].record()
                det = non_max_suppression_parts(boxes, scores, conf_thres=ft.conf, iou_thres=ft.iou, max_det=ft.d_max,
                                                max_nms=ft.max_nms)
                ev[2].record()
                xyxy = det["boxes"].float()
                xywh = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)
                seq = (xywh, det["scores"].float(), torch.zeros_like(det["scores"], dtype=torch.float32), det["valid"])
                outs.append(trk.scan_frames(*seq))  # ends in the chunk's one wait for the device
                ev[3].record()
                dets.append(seq)
                if marks is not None:
                    marks.append(ev)
        return dets, {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def make(device):  # the ByteTrack defaults: track_buffer 30 at 30 frames/s, so max_time_lost 30
        return BatchedBYTETracker(n_max=64, d_max=ft.d_max, device=device)

    run(make("cuda"))  # warm-up
    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (dets, outs), launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: run(make("cuda"), marks))
    wall = time.perf_counter() - t0
    split = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])] for ev in marks])
    xywh, sc, cl, valid = (torch.cat([d[i] for d in dets]).cpu().numpy() for i in range(4))
    cpu = make("cpu").scan_frames(xywh, sc, cl, valid)
    step = make("cuda")
    worst = 0.0
    for f in range(FRAMES):
        m = valid[f]
        rows = step.update(xywh[f][m], sc[f][m], cl[f][m])
        for o, what in ((outs, "the scan"), (cpu, "the CPU scan")):
            keep = np.flatnonzero(o["emit"][f])
            keep = keep[np.argsort(o["track_id"][f][keep])]
            scan_rows = np.concatenate([o["xyxy"][f][keep]] + [o[k][f][keep, None] for k in ("track_id", "score", "cls", "det_idx")], 1)
            if scan_rows.shape != rows.shape or not np.array_equal(scan_rows[:, 4], rows[:, 4]):
                raise AssertionError(f"byte scan, frame {f}: stepwise update gives ids {rows[:, 4]}, {what} {scan_rows[:, 4]}")
            if len(rows):
                worst = max(worst, float(np.abs(scan_rows - rows).max()))
    if worst > 1e-4 or not outs["emit"].any():
        raise AssertionError(f"byte scan: max |row diff| {worst} against stepwise update, {int(outs['emit'].sum())} emitted")
    log("byte scan", card, f"{FRAMES} frames (on the card) in {wall:.3f} s = {FRAMES / wall:.1f} frames/s (host clock); "
        f"{int(valid.sum())} detections, {int(outs['emit'].sum())} emitted rows, {len(set(outs['track_id'][outs['emit']].tolist()))} "
        f"ids; the scan equals update frame by frame and the CPU scan (ids exact, max |row diff| {worst:.3e}); kernel launches "
        f"{launches}")
    for i, (fwd, nms, byte) in enumerate(split):
        log("byte scan", card, f"chunk {i}: forward {fwd:.2f} ms, NMS {nms:.2f} ms, byte step {byte:.2f} ms "
            f"({byte / CHUNK:.3f} ms/frame, its copy to the host included)")


# ------------------------------------------------------------ config 5 --


def make_panning_clip(n_frames: int, w: int = 640, h: int = 512, seed: int = 7, visible: int = 10, occluded: int = 50):
    """The config-5 clip (a copy of demos/motion_comp_bench.py::make_panning_clip): the frame is
    a crop window drifting over a 2x textured background, with a smooth pan and two abrupt
    jumps at 1/3 and 2/3 of the clip (camera bumps that should fire global resets), and one
    target that moves in world coordinates, visible 10 frames of every 60. → (n, h, w) uint8."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    H2, W2 = h * 2, w * 2
    bg = cv2.resize(rng.normal(30, 10, (H2 // 16, W2 // 16)).astype(np.float32), (W2, H2), interpolation=cv2.INTER_CUBIC)
    # mid-frequency texture: the LK and ORB motion detectors need trackable features
    bg += cv2.resize(rng.normal(0, 12, (H2 // 4, W2 // 4)).astype(np.float32), (W2, H2), interpolation=cv2.INTER_CUBIC)
    gy, gx = np.mgrid[0:H2, 0:W2]
    bg += 25 * np.cos(gy / 37.0) * np.sin(gx / 53.0)
    frames = np.empty((n_frames, h, w), np.uint8)
    cycle = visible + occluded
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(n_frames):
        ox = int(w / 2 + (w / 3) * np.sin(f / 90)) + (80 if f >= n_frames // 3 else 0)
        oy = int(h / 2 + (h / 4) * np.cos(f / 130)) + (60 if f >= 2 * n_frames // 3 else 0)
        ox = int(np.clip(ox, 0, W2 - w))
        oy = int(np.clip(oy, 0, H2 - h))
        img = bg[oy : oy + h, ox : ox + w] + rng.normal(0, 2, (h, w))
        tx = W2 / 2 + 300 * np.sin(f / 200)
        ty = H2 / 2 + 150 * np.cos(f / 260)
        cx, cy = tx - ox, ty - oy
        if (f % cycle) < visible and 10 < cx < w - 10 and 10 < cy < h - 10:
            img = img + 170 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2)))
        frames[f] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def motion_detector(model, params, dtype, plain):
    """The counterpart of demos/motion_comp_bench.py::build_batch_detector / build_detector:
    (T, H, W) uint8 gray frames on the card, /255 in the compute dtype, broadcast to the
    stem's channels, `DetectionModel.predict_parts`, `non_max_suppression_parts` at conf
    0.15, iou 0.6, max_det 16 (max_nms 1024, its default, as there) → the NMS dict."""
    import copy

    import torch

    from yolo_tpu_torch import params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression_parts

    m = copy.deepcopy(model)
    params_from_jax(m, params, dtype)
    ch = int(params["model"]["0"]["conv"]["weight"].shape[2])  # stem input channels

    @torch.no_grad()
    def detect(frames):
        x = frames[..., None].to(dtype) / 255.0
        boxes, scores = m.predict_parts(x.expand(*x.shape[:3], ch), plain=plain)
        return non_max_suppression_parts(boxes, scores, conf_thres=0.15, iou_thres=0.6, max_det=16, plain=plain)

    return detect


def time_calls(obj, name: str, spent: dict) -> None:
    """Replace `obj.<name>` by a wrapper that adds each call's host seconds to `spent[name]`."""
    call = getattr(obj, name)
    spent[name] = 0.0

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return call(*args, **kwargs)
        finally:
            spent[name] += time.perf_counter() - t0

    setattr(obj, name, timed)


def det_lists(out) -> list:
    """NMS dict (host numpy) → per frame [[x1, y1, x2, y2, conf], ...], the tracker's input."""
    return [[[*b.tolist(), float(s)] for b, s, v in zip(bb, ss, vv) if v] for bb, ss, vv in zip(out["boxes"], out["scores"], out["valid"])]


def detect_chunked(detect, clip_gray):
    """The whole clip through `detect` in CHUNK-frame chunks (the last one padded with black
    frames) → (per-frame detections, host-clock s of the leg: uploads, forward, NMS and the
    copies back, one device wait per chunk; CUDA-event ms of each chunk's forward + NMS)."""
    import numpy as np
    import torch

    n = len(clip_gray)
    pad = (-n) % CHUNK
    clip = np.concatenate([clip_gray, np.zeros((pad, *clip_gray.shape[1:]), np.uint8)]) if pad else clip_gray
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, marks = [], []
    for i in range(0, len(clip), CHUNK):
        frames = torch.from_numpy(clip[i : i + CHUNK]).cuda()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = detect(frames)
        ev[1].record()
        outs.append({k: out[k].cpu().numpy() for k in ("boxes", "scores", "valid")})
        marks.append(ev)
    wall = time.perf_counter() - t0
    out = {k: np.concatenate([o[k] for o in outs])[:n] for k in outs[0]}
    return det_lists(out), wall, [a.elapsed_time(b) for a, b in marks]


def motion_loop(method, clip_bgr, dets):
    """MotionCompensatedMultiTracker over the clip with precomputed detections (the demo's
    batched-detect leg) → (per-frame track lists, comprehensive stats, host s, of which s in
    the global motion detector). The trackers' per-reset prints go to a buffer, as in
    motion/compare.py."""
    import contextlib
    import io

    from yolo_tpu_torch.motion import MotionCompensatedMultiTracker

    spent = {}
    with contextlib.redirect_stdout(io.StringIO()):
        tracker = MotionCompensatedMultiTracker(max_lost_frames=150, min_hits=1, iou_threshold=0.1,
                                                motion_detection_method=method)
        time_calls(tracker.motion_detector, "detect_motion", spent)
        tracks = []
        t0 = time.perf_counter()
        for frame, d in zip(clip_bgr, dets):
            tracks.append(tracker.update([list(x) for x in d], frame))
        wall = time.perf_counter() - t0
    return tracks, tracker.get_comprehensive_stats(), wall, spent["detect_motion"]


def same_tracks(got, want, what) -> float:
    """Per frame, track lists compared by position (ids are random uuids): equal statuses,
    ages, hits, resets; boxes within 1e-2 px → the largest box difference."""
    import numpy as np

    worst = 0.0
    for f, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what}, frame {f}: {len(g)} tracks vs {len(w)}")
        for a, b in zip(g, w):
            keys = ("status", "age", "hits", "hit_streak", "time_since_update", "reset_count")
            if [a[k] for k in keys] != [b[k] for k in keys]:
                raise AssertionError(f"{what}, frame {f}: {[a[k] for k in keys]} vs {[b[k] for k in keys]}")
            worst = max(worst, float(np.abs(np.asarray(a["bbox"]) - np.asarray(b["bbox"])).max()))
    if worst > 1e-2:
        raise AssertionError(f"{what}: boxes differ by {worst} px")
    return worst


def motion_kernels_phase(model, params, pan, card):
    """`[motion kernels]`: the chunked config-5 detector over the panning clip in f32 through
    the kernels and through the twins (equal detection counts per frame, boxes 1e-2 px, conf
    1e-4), then the optical-flow motion-compensated tracker on both detection sequences
    (equal events, resets and per-frame track lists)."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (dk, wk, _), launches = counted(path, lambda: detect_chunked(motion_detector(model, params, torch.float32, False), pan))
    dp, wp, _ = detect_chunked(motion_detector(model, params, torch.float32, True), pan)
    if [len(d) for d in dk] != [len(d) for d in dp]:
        bad = [f for f, (a, b) in enumerate(zip(dk, dp)) if len(a) != len(b)]
        raise AssertionError(f"motion kernels: detection counts differ on frames {bad[:20]}")
    rows = [(np.asarray(a), np.asarray(b)) for a, b in zip(dk, dp) if a]
    box = max([float(np.abs(a[:, :4] - b[:, :4]).max()) for a, b in rows] or [0.0])
    conf = max([float(np.abs(a[:, 4] - b[:, 4]).max()) for a, b in rows] or [0.0])
    n_det = sum(len(d) for d in dk)
    if box > 1e-2 or conf > 1e-4 or n_det <= 0:
        raise AssertionError(f"motion kernels: {n_det} detections, boxes differ by {box} px, conf by {conf}")
    log("motion kernels f32", card, f"{len(pan)} frames in {-(-len(pan) // CHUNK)} chunks: kernels {wk:.2f} s (first, cold), "
        f"plain {wp:.2f} s; detection counts equal on every frame ({n_det} detections on "
        f"{sum(1 for d in dk if d)} frames); max |box diff| {box:.3e} px, |conf diff| {conf:.3e}; launches {launches}")
    bgr = np.repeat(pan[..., None], 3, -1)
    tk, sk, _, _ = motion_loop("optical_flow", bgr, dk)
    tp, sp, _, _ = motion_loop("optical_flow", bgr, dp)
    if sk["basic"] != sp["basic"] or sk["motion_detection"] != sp["motion_detection"]:
        raise AssertionError(f"motion kernels: tracker stats differ: {sk['basic']} vs {sp['basic']}")
    worst = same_tracks(tk, tp, "motion kernels: optical_flow tracks, kernels against plain")
    if sk["basic"]["global_resets"] <= 0:
        raise AssertionError(f"motion kernels: no global reset on the panning clip: {sk['basic']}")
    log("motion kernels f32", card, f"optical_flow tracker on both: stats equal {sk['basic']}; "
        f"{sum(len(t) for t in tk)} track rows equal frame by frame (by position), max |box diff| {worst:.3e} px")


def motion_method_phase(method, model, params, pan, card):
    """`[motion <method>]`: the bf16 chunked detector, then the host loop (demos/motion_comp_bench.py's
    batched-detect leg, its deployment shape)."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    detect = motion_detector(model, params, torch.bfloat16, False)
    detect_chunked(detect, pan[:CHUNK])  # warm-up: cuDNN plans, allocator, first launches
    (dets, dev_s, chunk_ms), launches = counted(path, lambda: detect_chunked(detect, pan))
    _, stats, host_s, motion_s = motion_loop(method, np.repeat(pan[..., None], 3, -1), dets)
    n = len(pan)
    b = stats["basic"]
    log(f"motion {method}", card, f"{n} frames: fps_batched {n / (dev_s + host_s):.1f} frames/s = {n} / (detect {dev_s:.3f} s "
        f"+ host {host_s:.3f} s); detect {dev_s / n * 1e3:.3f} ms/frame (host clock, uploads and copies back included), "
        f"device {sum(chunk_ms) / n:.3f} ms/frame (CUDA events; per chunk " + ", ".join(f"{v:.2f}" for v in chunk_ms)
        + f" ms); host {host_s / n * 1e3:.3f} ms/frame = motion detection {motion_s / n * 1e3:.3f} + tracker "
        f"{(host_s - motion_s) / n * 1e3:.3f}; {sum(len(d) for d in dets)} detections; events {b['global_motion_events']}, "
        f"global resets {b['global_resets']}, individual resets {b['individual_resets']}; launches {launches}")


def motion_per_frame_phase(method, model, params, pan, card):
    """`[motion <method> per-frame]`: the demo's per-frame-dispatch control: the bf16 detector
    called once a frame (B = 1), its detections straight into the host loop."""
    import contextlib
    import io

    import numpy as np
    import torch

    from yolo_tpu_torch.motion import MotionCompensatedMultiTracker

    detect = motion_detector(model, params, torch.bfloat16, False)
    bgr = np.repeat(pan[..., None], 3, -1)
    n = len(pan)
    spent = {"detect": 0.0, "track": 0.0}

    def run():
        t0 = time.perf_counter()
        for f in range(n):
            t1 = time.perf_counter()
            d = det_lists({k: v.cpu().numpy() for k, v in detect(torch.from_numpy(pan[f : f + 1]).cuda()).items()})[0]
            t2 = time.perf_counter()
            tracker.update(d, bgr[f])
            spent["detect"] += t2 - t1
            spent["track"] += time.perf_counter() - t2
        return time.perf_counter() - t0

    detect(torch.from_numpy(pan[:1]).cuda())  # warm-up at B = 1
    with contextlib.redirect_stdout(io.StringIO()):
        tracker = MotionCompensatedMultiTracker(max_lost_frames=150, min_hits=1, iou_threshold=0.1, motion_detection_method=method)
        wall, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, run)
    b = tracker.get_comprehensive_stats()["basic"]
    log(f"motion {method} per-frame", card, f"{n} frames in {wall:.3f} s = {n / wall:.1f} frames/s (host clock, one detect "
        f"call a frame, B = 1): detect {spent['detect'] / n * 1e3:.3f} ms/frame, host motion + tracker "
        f"{spent['track'] / n * 1e3:.3f} ms/frame; events {b['global_motion_events']}, global resets {b['global_resets']}, "
        f"individual resets {b['individual_resets']}; launches {launches}")


def motion_compare_phase(model, params, pan, card):
    """`[motion compare]`: the first MOTION_COMPARE_FRAMES frames of the panning clip as an mp4v
    file; the package's entry point `motion.compare_motion_methods` over it with the bf16
    detector called once a frame."""
    import contextlib
    import io

    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch.motion import compare_motion_methods

    detect = motion_detector(model, params, torch.bfloat16, False)

    def detector(frame):  # a decoded BGR frame → its gray plane, as the demo's per-frame detector
        return det_lists({k: v.cpu().numpy() for k, v in detect(torch.from_numpy(frame[None, ..., 0].copy()).cuda()).items()})[0]

    detector(np.repeat(pan[0][..., None], 3, -1))  # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        vid = Path(tmp) / "pan.mp4"
        vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (pan.shape[2], pan.shape[1]))
        for frame in pan[:MOTION_COMPARE_FRAMES]:
            vw.write(np.repeat(frame[..., None], 3, -1))
        vw.release()
        path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
        with contextlib.redirect_stdout(io.StringIO()):  # the trackers' own prints; the method lines go to the log
            out, launches = counted(path, lambda: compare_motion_methods(vid, detector, report_path=Path(tmp) / "report.txt"))
    for method, r in out["results"].items():
        log("motion compare", card, f"{method}: {r['frames']} frames, {r['fps']:.1f} frames/s ({r['ms_per_frame']:.3f} ms/frame, "
            f"detect, decode and host legs together); events {r['global_motion_events']}, global resets "
            f"{r['global_resets']}, individual resets {r['individual_resets']}")
    if any(r["frames"] != MOTION_COMPARE_FRAMES for r in out["results"].values()):
        raise AssertionError(f"motion compare: frames read {[r['frames'] for r in out['results'].values()]}")
    log("motion compare", card, f"recommended {out['recommended']}; launches over the three methods {launches}")


def grayscale_phase(clip, card):
    """`[grayscale]`: GRAY_FRAMES frames of the IR clip as a BGR mp4v file through
    `GrayscaleTracker.process_video(test_range=(32, 80))`: the tracker's own `yolo_detect`
    (the port's YOLO on the card, set to f32 through its overrides) against a detector that
    calls `YOLO.predict(plain=True, compute_dtype="float32")`: equal stats and tracks; then
    the default tracker (bf16), timed."""
    import contextlib
    import io

    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.grayscale import GrayscaleTracker

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    with tempfile.TemporaryDirectory() as tmp:
        vid = Path(tmp) / "ir.mp4"
        vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (clip.shape[2], clip.shape[1]))
        for frame in clip[:GRAY_FRAMES]:
            vw.write(np.repeat(frame, 3, -1))
        vw.release()
        run = lambda t: t.process_video(vid, test_range=GRAY_TEST_RANGE, write_video=False)  # noqa: E731

        with contextlib.redirect_stdout(io.StringIO()):
            own = GrayscaleTracker(str(WEIGHTS), conf=0.25)
            own._yolo = YOLO(str(WEIGHTS)).fuse()
            own._yolo.overrides["compute_dtype"] = "float32"
            sk, launches32 = counted(path, lambda: run(own))
            twin = YOLO(str(WEIGHTS)).fuse()
            plain = GrayscaleTracker(conf=0.25, detector=lambda frame: [list(r) for r in twin.predict(
                frame, conf=0.25, plain=True, compute_dtype="float32", verbose=False)[0].boxes.data])
            sp = run(plain)
        if own._yolo.predictor.dtype != torch.float32 or sk != sp:
            raise AssertionError(f"grayscale: f32 kernels {sk} vs plain {sp}")
        if sk["detected_frames"] <= 0 or sk["predicted_frames"] <= 0:
            raise AssertionError(f"grayscale: nothing detected or coasted: {sk}")
        log("grayscale f32", card, f"own yolo_detect (kernels) and the plain detector: stats and tracks equal "
            f"{ {k: v for k, v in sk.items() if k != 'tracks'} }, tracks {sk['tracks']}; launches {launches32}")

        with contextlib.redirect_stdout(io.StringIO()):
            t = GrayscaleTracker(str(WEIGHTS), conf=0.25)
            t.yolo_detect(np.repeat(clip[0], 3, -1), -1)  # builds the YOLO on the card; warm-up
            spent = {}
            for name in ("yolo_detect", "predict_lost_targets"):
                time_calls(t, name, spent)
            t0 = time.perf_counter()
            sb, launches16 = counted(path, lambda: run(t))
            wall = time.perf_counter() - t0
    n = sb["frames"]
    if t._yolo.predictor.dtype != torch.bfloat16 or n != GRAY_FRAMES:
        raise AssertionError(f"grayscale: the default run computed in {t._yolo.predictor.dtype} over {n} frames")
    counts = {k: v for k, v in sb.items() if k != "tracks"}
    moved = max(max(abs(a - b) for a, b in zip(sb["tracks"][i]["last_center"], sk["tracks"][i]["last_center"]))
                for i in sb["tracks"] if i in sk["tracks"])
    log("grayscale bf16", card, f"{n} frames in {wall:.3f} s = {n / wall:.1f} frames/s (host clock, video decode included); "
        f"yolo_detect {spent['yolo_detect'] / n * 1e3:.3f} ms/frame, predict_lost_targets "
        f"{spent['predict_lost_targets'] / n * 1e3:.3f} ms/frame; stats {counts}, equal to f32: "
        f"{counts == {k: v for k, v in sk.items() if k != 'tracks'}}, track ids {sorted(sb['tracks'])} (f32 "
        f"{sorted(sk['tracks'])}), last centers within {moved} px of f32's; launches {launches16}")


def grayscale_scorer_phase(card):
    """`[grayscale scorer]`: `predict_center_torch` on the card over 256 seeded 40x40 ROIs at
    once against the numpy scorer's argmax on each (same index, score rel 1e-5); its time per
    256 ROIs and per single ROI (CUDA events). Plain PyTorch: no kernel, no bound row."""
    import numpy as np
    import torch

    from yolo_tpu_torch.grayscale.scoring import gradient_window_scores, predict_center_torch

    rng = np.random.default_rng(0)
    rois = rng.integers(0, 256, (256, 40, 40)).astype(np.uint8)
    yy, xx = np.mgrid[0:40, 0:40]
    for i in range(0, 256, 4):  # a bright target in every fourth ROI
        cx, cy = rng.uniform(3, 37, 2)
        rois[i] = np.clip(rois[i] // 4 + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0), 0, 255).astype(np.uint8)
    dev = torch.from_numpy(rois).cuda()
    best, score = (t.cpu().numpy() for t in predict_center_torch(dev))
    worst = 0.0
    for i, roi in enumerate(rois):
        s = gradient_window_scores(roi)
        iy, ix = np.unravel_index(int(np.argmax(s)), s.shape)
        worst = max(worst, abs(float(score[i]) - float(s[iy, ix])) / abs(float(s[iy, ix])))
        if (iy, ix) != tuple(best[i]) or worst > 1e-5:
            raise AssertionError(f"grayscale scorer, ROI {i}: card {tuple(best[i])} {score[i]} vs numpy {(iy, ix)} {s[iy, ix]}")
    ms256 = cuda_ms(lambda: predict_center_torch(dev), iters=20, warmup=3)
    ms1 = cuda_ms(lambda: predict_center_torch(dev[0]), iters=50, warmup=5)
    log("grayscale scorer", card, f"256 ROIs 40x40 on the card: every index equal to the numpy scorer's, score rel err "
        f"{worst:.2e}; {ms256:.4f} ms per 256 ROIs ({ms256 / 256 * 1e3:.2f} us/ROI), {ms1:.4f} ms for one ROI (CUDA events)")


# ------------------------------------------------------------- validation --


# --------------------------------------------------------------- serving --

SERVE_CLIENTS, SERVE_FRAMES = 8, 64  # `[serve]`: v2 client threads x frames each, plus one v1 client
SERVE_KERNEL_CLIENTS, SERVE_KERNEL_FRAMES = 4, 16  # `[serve kernels]`
SERVE_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}


@contextlib.contextmanager
def serving(models, out_of_service=(), **kw):
    """A DetectionServer on 127.0.0.1 (any free port) in a thread, its lanes built, or failing (only the
    lanes in `out_of_service` may be); shut down and joined on exit."""
    import threading

    from yolo_tpu_torch.serve import DetectionServer

    srv = DetectionServer(models, host="127.0.0.1", port=0, batch_window_ms=4.0, **kw)
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever, args=(ready,), daemon=True)
    t.start()
    try:
        if not ready.wait(60):
            raise RuntimeError("the server did not start listening")
        t0 = time.perf_counter()
        while not all(lane.error or (lane.predictor is not None and lane.predictor.done_warmup) for lane in srv.lanes.values()):
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("the server's lanes did not build in 600 s")
            time.sleep(0.05)
        errors = {mid: lane.error for mid, lane in srv.lanes.items() if lane.error and mid not in out_of_service}
        if errors or not all(srv.lanes[mid].error for mid in out_of_service):
            raise AssertionError(f"server lanes out of service: {errors}")
        yield srv
    finally:
        srv.shutdown()
        t.join(30)
        if t.is_alive():
            raise RuntimeError("the server did not stop")


def v1_request(conn, frame):
    """One protocol-v1 round trip → (n, 6) detections (v1 has no status field)."""
    import struct

    import numpy as np

    def recv(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    conn.sendall(b"YTPU" + struct.pack("<III", *frame.shape) + frame.tobytes())
    if recv(4) != b"YTPR":
        raise AssertionError("bad v1 response magic")
    (n,) = struct.unpack("<I", recv(4))
    return np.frombuffer(recv(n * 24), np.float32).reshape(n, 6)


def run_clients(port, jobs):
    """`jobs`: one list a client thread of (lane or "v1", frame). Each thread sends its frames one
    request at a time (v2 through utils/remote.RemoteModel, which raises on a reply with a status
    other than 0) → (per thread the replies and each request's seconds, wall s of the whole run)."""
    import socket
    import threading

    from yolo_tpu_torch.utils.remote import RemoteModel

    out, failures = [None] * len(jobs), []

    def client(i):
        replies, lat = [], []
        models = {}
        conn = None
        try:
            for lane, frame in jobs[i]:
                t0 = time.perf_counter()
                if lane == "v1":
                    conn = conn or socket.create_connection(("127.0.0.1", port), timeout=300)
                    replies.append(v1_request(conn, frame))
                else:
                    rm = models.setdefault(lane, RemoteModel(f"tcp://127.0.0.1:{port}/{lane}"))
                    replies.append(rm(frame))
                lat.append(time.perf_counter() - t0)
            out[i] = (replies, lat)
        except Exception as e:  # reported below: a client that fails fails the phase
            failures.append(f"client {i}: {type(e).__name__}: {e}")
        finally:
            for rm in models.values():
                rm.close()
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {failures or 'a client did not finish in 600 s'}")
    return out, wall


def same_dets(got, want, what) -> float:
    """Equal row counts and classes, boxes within 1e-2 px, conf 1e-4 (the f32 gates) → the largest difference."""
    import numpy as np

    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g[:, 5], w[:, 5]):
            raise AssertionError(f"{what}, reply {k}: {len(g)} vs {len(w)} detections or other classes")
        if len(g):
            d = np.abs(g - w)
            if d[:, :4].max() > 1e-2 or d[:, 4].max() > 1e-4:
                raise AssertionError(f"{what}, reply {k}: boxes differ by {d[:, :4].max()} px, conf by {d[:, 4].max()}")
            worst = max(worst, float(d[:, :5].max()))
    return worst


def batch_stats(timings) -> dict:
    """The worker's batches: histogram of padded sizes B (and of frames n), and per batch the host's
    letterbox + assembly, enqueue, wait and Results ms and, in CUDA events, upload and device ms."""
    import numpy as np

    hist, frames = {}, {}
    for t in timings:
        hist[t["B"]] = hist.get(t["B"], 0) + 1
        frames[t["n"]] = frames.get(t["n"], 0) + 1
    ms = lambda key: np.array([t[key] for t in timings]) * 1e3  # noqa: E731
    up = np.array([t["events"][0].elapsed_time(t["events"][1]) for t in timings])
    dev = np.array([t["events"][1].elapsed_time(t["events"][2]) for t in timings])
    return {"batches": len(timings), "B": dict(sorted(hist.items())), "n": dict(sorted(frames.items())),
            "pre": ms("pre_s"), "enqueue": ms("enqueue_s"), "wait": ms("wait_s"), "post": ms("post_s"), "upload": up, "device": dev}


def serve_kernels_phase(clip, card):
    """`[serve kernels]`: lane 0 from best.npz and lane 1 from the .pt the port's `YOLO.export(format="pt")`
    writes, f32 through the kernels; a second server's lane 0 f32 through the twins (`plain`). 4 client
    threads x 16 frames of 640x512, 1- and 3-channel by thread, each frame to lane 0 and lane 1 (the
    twins' server: lane 0). Every reply has status 0 and no lane fails; kernels against twins and lane 0
    against lane 1 within the f32 gates; the kernel server launches kernels 1, 2, 3 and 5, the twins' none."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    frames = [clip[k] if (k // SERVE_KERNEL_FRAMES) % 2 == 0 else np.repeat(clip[k], 3, -1)
              for k in range(SERVE_KERNEL_CLIENTS * SERVE_KERNEL_FRAMES)]
    per = [frames[i * SERVE_KERNEL_FRAMES:(i + 1) * SERVE_KERNEL_FRAMES] for i in range(SERVE_KERNEL_CLIENTS)]
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        pt = YOLO(str(WEIGHTS)).export(format="pt")
        f32 = {"compute_dtype": "float32"}
        with serving({0: str(WEIGHTS), 1: str(pt.resolve())}, predict_args=f32) as srv:
            for lane in srv.lanes.values():
                lane.predictor.timings = []
            (out, wall), launches = counted(SERVE_PATH, lambda: run_clients(srv.port, [[(j, f) for f in fr for j in (0, 1)] for fr in per]))
            stats = batch_stats([t for lane in srv.lanes.values() for t in lane.predictor.timings])
            if any(lane.predictor.dtype != torch.float32 for lane in srv.lanes.values()):
                raise AssertionError("the kernel server's lanes did not compute in f32")
        with serving({0: str(WEIGHTS)}, predict_args={**f32, "plain": True}) as srv:
            (twin, _), none = counted(set(), lambda: run_clients(srv.port, [[(0, f) for f in fr] for fr in per]))
    lane0 = [r for replies, _ in out for r in replies[0::2]]
    lane1 = [r for replies, _ in out for r in replies[1::2]]
    plain = [r for replies, _ in twin for r in replies]
    worst = same_dets(lane0, plain, "serve kernels vs twins")
    worst_pt = same_dets(lane1, lane0, "serve lane 1 (.pt) vs lane 0 (.npz)")
    n = sum(len(r) for r in lane0)
    if n <= 0:
        raise AssertionError("the server detected nothing")
    log("serve kernels", card, f"{len(frames)} frames x 2 lanes in {wall:.2f} s from {SERVE_KERNEL_CLIENTS} clients, every status 0, "
        f"no lane error; {n} detections; kernels vs twins max |diff| {worst:.3e}, lane 1 (.pt) vs lane 0 {worst_pt:.3e}; "
        f"batches B {stats['B']}; launches {launches} (twins' server: {none})")


def serve_phase(clip, card, run_no, srv):
    """`[serve]` (timed): the bf16 server (the default) on `srv`, SERVE_CLIENTS v2 client threads x
    SERVE_FRAMES frames of 640x512 (1-channel on even threads, 3 on odd) plus one v1 client of
    SERVE_FRAMES 3-channel frames: frames/s over all clients (host clock over the run), request
    latency p50 / p99, the batch-size histogram, the worker's split per batch and its device-busy
    share, the first batch at each B against that B's median, and the launches (kernels 1, 2, 3, 5)."""
    import numpy as np

    lane = srv.lanes[0]
    n_clip = len(clip)
    jobs = [[(0, clip[(i * SERVE_FRAMES + k) % n_clip] if i % 2 == 0 else np.repeat(clip[(i * SERVE_FRAMES + k) % n_clip], 3, -1))
             for k in range(SERVE_FRAMES)] for i in range(SERVE_CLIENTS)]
    jobs.append([("v1", np.repeat(clip[k % n_clip], 3, -1)) for k in range(SERVE_FRAMES)])
    lane.predictor.timings = []
    with native_letterboxes() as calls:
        (out, wall), launches = counted(SERVE_PATH, lambda: run_clients(srv.port, jobs))
    if launches["head_level_cm"] != 0:
        raise AssertionError(f"[serve] launched the channel-major head: {launches}")
    st = batch_stats(lane.predictor.timings)
    lat = np.array([x for _, ls in out for x in ls]) * 1e3
    frames = len(lat)
    if len(calls) != frames:
        raise AssertionError(f"[serve]: {len(calls)} of {frames} frames went through the native letterbox")
    busy = float(st["upload"].sum() + st["device"].sum()) / 1e3
    q = lambda a: f"median {np.median(a):.3f} (p90 {np.percentile(a, 90):.3f})"  # noqa: E731
    first = {}
    for t in lane.predictor.timings:
        first.setdefault(t["B"], (t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"]) * 1e3)
    per_b = {}
    for t in lane.predictor.timings:
        per_b.setdefault(t["B"], []).append((t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"]) * 1e3)
    log(f"serve run {run_no}", card, f"{frames} frames from {SERVE_CLIENTS} v2 + 1 v1 clients in {wall:.3f} s = {frames / wall:.1f} "
        f"frames/s (all letterboxed by the native library); request latency p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; "
        f"{sum(len(r) for rs, _ in out for r in rs)} detections; batches {st['batches']}: B {st['B']}, frames per batch {st['n']}")
    log(f"serve run {run_no}", card, f"worker per batch (ms): letterbox + assembly {q(st['pre'])}, enqueue {q(st['enqueue'])}, "
        f"wait {q(st['wait'])}, Results {q(st['post'])} (host clock); upload {q(st['upload'])}, device {q(st['device'])} "
        f"(CUDA events); device busy {busy:.3f} s of {wall:.3f} s: idle {100 * (1 - busy / wall):.1f}%")
    log(f"serve run {run_no}", card, "first batch at each B against that B's median (ms, host): " + ", ".join(
        f"B={b}: {first[b]:.2f} / {np.median(per_b[b]):.2f} ({len(per_b[b])} batches)" for b in sorted(first)))
    log(f"serve run {run_no}", card, f"kernel launches in that run: {launches}")
    return launches


def letterbox_cost(clip, card):
    """The host's cost of one 640x512 BGR frame's letterbox into 640x640 on the main thread, nothing
    else running: the native library (the server's route; a row copy at ratio 1) against the
    port's LetterBox (a numpy pad at ratio 1); ms per frame over 64 frames."""
    import numpy as np

    from yolo_tpu_torch import native
    from yolo_tpu_torch.ops.letterbox import LetterBox

    frames = [np.ascontiguousarray(np.repeat(f, 3, -1)) for f in clip[:64]]
    lb = LetterBox((640, 640), auto=False)
    cost = {}
    for name, fn in (("native", lambda f: native.letterbox(f, (640, 640))), ("LetterBox", lambda f: lb(f, return_meta=True))):
        fn(frames[0])
        t0 = time.perf_counter()
        outs = [fn(f) for f in frames]
        cost[name] = (time.perf_counter() - t0) / len(frames) * 1e3
    if not all(np.array_equal(a[0], b[0]) for a, b in zip(outs, [native.letterbox(f, (640, 640)) for f in frames])):
        raise AssertionError("at ratio 1 the native letterbox and the padding differ")
    log("serve letterbox", card, "one 640x512x3 frame into 640x640 on the main thread: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in cost.items()) + " (equal pixels)")


def write_bgr_video(path: Path, frames) -> Path:
    """(n, h, w, 1) IR frames as a 30 fps mp4v file of BGR frames."""
    import cv2
    import numpy as np

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (frames.shape[2], frames.shape[1]))
    for frame in frames:
        vw.write(np.repeat(frame, 3, -1))
    vw.release()
    return path


def remote_phase(clip, card, srv):
    """`[remote]`: `YOLO("tcp://.../0")` on the `[serve]` server (bf16) over a 16-frame mp4v file and a
    directory of 8 PNGs: each Results equals a raw v2 request for the frame it decoded (one client,
    so every call is B = 1); `track` over the video attaches ids."""
    import cv2
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.utils.remote import RemoteModel

    with tempfile.TemporaryDirectory() as tmp:
        vid, pngs = write_bgr_video(Path(tmp) / "ir.mp4", clip[:16]), Path(tmp) / "pngs"
        pngs.mkdir()
        for k in range(8):
            cv2.imwrite(str(pngs / f"{k:03d}.png"), clip[100 + k])
        m = YOLO(f"tcp://127.0.0.1:{srv.port}/0")
        counts = {}
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as rm:
            for name, src in (("video", vid), ("pngs", pngs)):
                res = m.predict(str(src), conf=0.0, verbose=False)
                raw = [rm(r.orig_img) for r in res]
                if [len(r) for r in res] != [len(d) for d in raw] or not all(np.array_equal(r.boxes.data, d) for r, d in zip(res, raw)):
                    raise AssertionError(f"[remote] {name}: YOLO(tcp://).predict differs from raw v2 replies")
                counts[name] = (len(res), sum(len(r) for r in res))
        tracked = m.track(str(vid), conf=0.0, verbose=False)
        ids = sorted({int(i) for r in tracked if len(r) for i in r.boxes.id})
        m.predictor.close()
    if counts["video"][0] != 16 or counts["pngs"][0] != 8 or not ids or not all(r.boxes.is_track for r in tracked if len(r)):
        raise AssertionError(f"[remote]: frames/detections {counts}, track ids {ids}")
    log("remote", card, f"YOLO(tcp://) predict = raw v2 replies: video {counts['video'][0]} frames ({counts['video'][1]} detections), "
        f"PNG dir {counts['pngs'][0]} frames ({counts['pngs'][1]}); track ids {ids}")


def predict_sources_phase(clip, card):
    """`[predict sources]`: `YOLO(best.npz).predict` on the card (bf16) over a directory of 8 PNGs, a glob
    of 4 of them and a 16-frame mp4v video, with save, save_txt and save_crop: the files each writes.
    Then a 300x500 frame, which the letterbox resizes: the native letterbox route (required here),
    f32 kernels against f32 twins at the f32 gates, with the launches."""
    import cv2
    import numpy as np

    from yolo_tpu_torch import YOLO, native

    with tempfile.TemporaryDirectory() as tmp:
        pngs, vid = Path(tmp) / "pngs", write_bgr_video(Path(tmp) / "ir.mp4", clip[:16])
        pngs.mkdir()
        for k in range(8):
            cv2.imwrite(str(pngs / f"{k:03d}.png"), clip[200 + k])
        written = {}
        for name, src, want in (("dir", pngs, 8), ("glob", pngs / "00[0-3].png", 4), ("video", vid, 16)):
            out = Path(tmp) / "runs" / name
            y = YOLO(str(WEIGHTS))  # a predictor keeps the run directory of its first write
            res, launches = counted(SERVE_PATH, lambda: y.predict(str(src), save=True, save_txt=True, save_crop=True, project=str(out.parent),
                                                                  name=name, exist_ok=True, verbose=False))
            files = sorted(str(f.relative_to(out)) for f in out.rglob("*") if f.is_file())
            kinds = {k: sum(1 for f in files if f.startswith(k)) for k in ("labels/", "crops/")}
            kinds["images"] = len(files) - sum(kinds.values())
            if len(res) != want or kinds["images"] < 1 or kinds["labels/"] < 1 or kinds["crops/"] < 1:
                raise AssertionError(f"[predict sources] {name}: {len(res)} results, files {files}")
            written[name] = (len(res), sum(len(r) for r in res), kinds, launches["c2f"])
        log("predict sources", card, "; ".join(f"{k}: {n} frames, {d} detections, written {w} (c2f launches {c})"
                                               for k, (n, d, w, c) in written.items()))

    small = np.ascontiguousarray(np.repeat(clip[230, 100:400, 50:550], 3, -1))  # 300x500 with 3 targets: scaled by 1.28
    with native_letterboxes() as calls:
        got, launches = counted(SERVE_PATH, lambda: YOLO(str(WEIGHTS)).predict(small, compute_dtype="float32", verbose=False)[0])
    want = YOLO(str(WEIGHTS)).predict(small, compute_dtype="float32", plain=True, verbose=False)[0]
    worst = same_dets([got.boxes.data], [want.boxes.data], "predict 300x500 kernels vs twins")
    if calls != [(300, 500, 3)] or len(got) == 0:
        raise AssertionError(f"300x500 predict: native letterbox calls {calls}, {len(got)} detections")
    _, meta = native.letterbox(small, (640, 640))
    log("predict sources", card, f"300x500 frame through the native letterbox (ratio {meta[0][0]!r}, pad {meta[1]}): f32 kernels "
        f"{len(got)} detections = twins', max |diff| {worst:.3e}; launches {launches}")


@contextlib.contextmanager
def native_letterboxes():
    """Record the shape of every image the predictor letterboxes through the native library in
    the block (it must have built: the card's machine has g++)."""
    from yolo_tpu_torch import native

    if not native.available():
        raise AssertionError("the native letterbox library did not build (g++)")
    calls, real = [], native.letterbox
    native.letterbox = lambda img, *a, **k: (calls.append(img.shape), real(img, *a, **k))[1]
    try:
        yield calls
    finally:
        native.letterbox = real


_PNG_POOL, _PNG_JOBS = ThreadPoolExecutor(8), []  # the split writers' PNG encoders (threads start at first use)


def write_png(path, img) -> None:
    """cv2.imwrite of `img` on _PNG_POOL's threads (cv2 releases the GIL while it compresses): the split writers draw
    their frames in order on the main thread and hand each finished array over, so the files are those written one
    after another; `flush_pngs` waits for them."""
    import cv2

    _PNG_JOBS.append(_PNG_POOL.submit(cv2.imwrite, str(path), img))


def flush_pngs() -> None:
    """Wait until every `write_png` image is on disk."""
    jobs = list(_PNG_JOBS)
    _PNG_JOBS.clear()
    if not all(j.result() for j in jobs):
        raise OSError("a split image was not written")


def split_once(root: Path, tag: str, what: str, write) -> Path:
    """`write()` → a dataset under `root` (its yaml, or a folder), unless `root` holds it already: `main` writes every
    dataset while the kernels build (`write_datasets`), the phases (and the card tests, which call them alone) write
    what is missing. Prints how long a write took."""
    done = root / ".dataset"
    if not done.exists():
        t0 = time.perf_counter()
        out = write()
        done.write_text(str(out))
        print(f"[{tag} split] {what} written in {time.perf_counter() - t0:.1f} s")
    return Path(done.read_text())


def heldout_split(root: Path) -> Path:
    return split_once(root, "heldout", f"{VAL_HELDOUT[0]} frames of 640x512", lambda: write_split(root, *VAL_HELDOUT))


def val_split(root: Path) -> Path:
    return split_once(root, "val", f"{VAL_FRAMES[0]} frames of 640x512", lambda: write_split(root, *VAL_FRAMES))


def train_split(root: Path) -> Path:
    return split_once(root, "train", f"{TRAIN_SET[0]} train + {VAL_HELDOUT[0]} held-out frames of 640x512",
                      lambda: (write_split(root, *TRAIN_SET, split="train"), write_split(root, *VAL_HELDOUT))[1])


def cls_split(root: Path) -> Path:
    return split_once(root, "classify", f"{CLS_TRAIN[0]} train + {CLS_VAL[0]} val images of 224x224, {len(CLS_SHAPES)} "
                      "classes", lambda: (write_cls_split(root, *CLS_TRAIN), write_cls_split(root, *CLS_VAL, split="val"))[1])


def seg_split(root: Path) -> Path:
    return split_once(root, "segment", f"{SEG_TRAIN[0]} train + {SEG_VAL[0]} val frames of 640x512 with polygon labels",
                      lambda: (write_seg_split(root, *SEG_TRAIN, split="train"), write_seg_split(root, *SEG_VAL, split="val"))[1])


def pose_split(root: Path) -> Path:
    return split_once(root, "pose", f"{POSE_TRAIN[0]} train + {POSE_VAL[0]} val frames of 640x512 with 17-keypoint labels",
                      lambda: (write_pose_split(root, *POSE_TRAIN, split="train"), write_pose_split(root, *POSE_VAL, split="val"))[1])


def obb_split(root: Path) -> Path:
    return split_once(root, "obb", f"{OBB_TRAIN[0]} train + {OBB_VAL[0]} val frames of 640x512 with DOTA rows",
                      lambda: (write_obb_split(root, *OBB_TRAIN, split="train"), write_obb_split(root, *OBB_VAL, split="val"))[1])


def write_datasets(root: Path) -> None:
    """Every seeded dataset of the run under `root` (held-out and val splits, the training split, the classify,
    segment, pose and obb sets), each in the directory its phase reads."""
    heldout_split(root / "heldout")
    val_split(root / "val")
    train_split(root / "train")
    for name, write in (("cls", cls_split), ("seg", seg_split), ("pose", pose_split), ("obb", obb_split)):
        write(root / name)


def write_split(root: Path, n: int, seed: int, w: int = 640, h: int = 512, split: str = "val") -> Path:
    """A copy of demos/ir_end_to_end.py::_write_split at its defaults (the training
    distribution): n seeded 640x512 IR frames as PNGs under root/images/<split>, 1-3 small
    bright targets on a cloudy background each, YOLO labels under root/labels/<split> → the
    dataset yaml, which names every split written under root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        bg = rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32)
        img = cv2.resize(bg, (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines = []
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.08, 0.92), rng.uniform(0.08, 0.92)
            r = rng.uniform(2.5, 6.0)
            a = rng.uniform(120.0, 200.0)
            img += a * np.exp(-(((xx - cx * w) ** 2 + (yy - cy * h) ** 2) / (2 * r**2)))
            lines.append(f"0 {cx:.4f} {cy:.4f} {(4 * r) / w:.4f} {(4 * r) / h:.4f}")
        write_png(root / f"images/{split}/{i}.png", np.clip(img, 0, 255).astype(np.uint8))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    flush_pngs()
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: aircraft\n")
    return root / "data.yaml"


def recording_validator():
    """The port's DetectionValidator, keeping each batch's packed device outputs (host copies) in `outs`."""
    from yolo_tpu_torch.engine.validator import DetectionValidator

    class Recording(DetectionValidator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.outs = []

        def _update(self, batch, out, *rest):
            self.outs.append(out)
            return super()._update(batch, out, *rest)

    return Recording


def val_run(data, y=None, **kw):
    """`y.val(data=..., imgsz=640, plots=False, **kw)` on the card, `y` a new YOLO(best.npz) unless
    given → (results, validator)."""
    from yolo_tpu_torch import YOLO

    y = y or YOLO(str(WEIGHTS))
    results = y.val(validator=recording_validator(), data=str(data), imgsz=640, plots=False, **kw)
    return results, y.validator


def same_val_detections(got, want) -> float:
    """Per image: equal detection counts, boxes within 1e-2 px and conf within 1e-4, rows in x1 order
    (two scores of one image may lie within the f32 difference) → the largest |diff|."""
    import numpy as np

    worst = 0.0
    for a, b in zip((o for out in got.outs for o in out), (o for out in want.outs for o in out)):
        a, b = a[a[:, 6] > 0], b[b[:, 6] > 0]
        if len(a) != len(b):
            raise AssertionError(f"val: detections per image differ, kernels {len(a)} vs plain {len(b)}")
        a, b = a[np.argsort(a[:, 0], kind="stable")], b[np.argsort(b[:, 0], kind="stable")]
        if not np.array_equal(a[:, 5], b[:, 5]) or not np.isfinite(a).all():
            raise AssertionError("val: classes differ or non-finite outputs")
        box, conf = float(np.abs(a[:, :4] - b[:, :4]).max(initial=0)), float(np.abs(a[:, 4] - b[:, 4]).max(initial=0))
        if box > 1e-2 or conf > 1e-4:
            raise AssertionError(f"val: boxes differ by {box} px or conf by {conf}")
        worst = max(worst, box, conf)
    return worst


def val_kernel_holds(model, params, data, card):
    """Kernels 1, 2, 3 and 5 against their twins at TOL on activations captured from the first
    val batch (B = 16, 640x640, the letterboxed 640x512 frames, RGB / 255), f32 and bf16; NMS at
    conf 0.001, K = 1024, bit for bit."""
    import copy

    import torch

    from yolo_tpu_torch.cfg import get_cfg
    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset
    from yolo_tpu_torch.nn.tasks import params_from_jax
    from yolo_tpu_torch.ops import cuda_c2f, cuda_nms

    model = copy.deepcopy(model)
    d = check_det_dataset(str(data))
    imgs = next(iter(build_dataloader(build_yolo_dataset(get_cfg(overrides={"imgsz": 640}), d["val"], d), 16, workers=4)))["img"]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        params_from_jax(model, params, dtype)
        x = torch.from_numpy(imgs).cuda().to(dtype) / 255.0
        rec, boxes, scores = capture_instances(model, x)
        for name, args in rec:
            if name == "c2f":
                kern, plain = (lambda a=args: cuda_c2f.fused_c2f(*a)), (lambda a=args: cuda_c2f.c2f_plain(*a))
            elif name == "c2f_upconcat":
                kern, plain = (lambda a=args: cuda_c2f.fused_c2f_upconcat(*a)), (lambda a=args: cuda_c2f.c2f_upconcat_plain(*a))
            else:
                kfn, pfn = head_fns(name)
                kern, plain = (lambda a=args: kfn(*a)), (lambda a=args: pfn(*a))
            B, H, W, C = args[1 if name == "c2f_upconcat" else 0].shape
            desc = f"B={B} {H}x{W} C={C}"
            errs = hold(name, desc, dn, kern(), plain())
            log(f"val kernels {dn}", card, f"{name:14s} {desc:22s} max_abs_err={max(errs.values()):.3e} "
                f"kernel_ms={cuda_ms(kern):.4f} plain_ms={cuda_ms(plain):.4f}")
        cand, top = nms_candidates(boxes, scores, 0.001, 1024)
        got, want = cuda_nms.nms_keep(cand, top, 0.7), cuda_nms.nms_keep_plain(cand, top, 0.7)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep {dn} B=16 K=1024 conf 0.001: keep mask differs in {int((got != want).sum())} slots")
        log(f"val kernels {dn}", card, f"nms_keep       B={cand.shape[0]} K={cand.shape[1]} valid={int((top > 0).sum())} "
            f"kept={int(got.sum())} max_abs_err=0 kernel_ms={cuda_ms(lambda: cuda_nms.nms_keep(cand, top, 0.7), iters=50, warmup=5):.4f} "
            f"plain_ms={cuda_ms(lambda: cuda_nms.nms_keep_plain(cand, top, 0.7), iters=2, warmup=1):.4f}")


def val_kernels_phase(model, params, data, card):
    """`[val kernels]`: YOLO(best.npz).val on the demo's held-out split (32 frames, seed 10,000, as
    demos/ir_end_to_end.py::make_dataset makes it) at imgsz 640, batch 16: f32 through the kernels
    against f32 through the twins (metrics within 1e-4, equal confusion matrices, per-image
    detections), then bf16; the kernels against their twins on one val batch."""
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rk, vk), launches = counted(path, lambda: val_run(data, batch=16))
    rp, vp = val_run(data, batch=16, plain=True)
    n_det, dm, worst = hold_val_runs("val", card, rk, vk, rp, vp)
    if rk["mAP50"] <= 0 or n_det <= 0:
        raise AssertionError(f"val found nothing: {rk}, {n_det} detections")
    demo = json.loads((ROOT / "demos" / "artifacts" / "demo_report.json").read_text())["train_metrics_heldout_val"]
    log("val kernels f32", card, f"kernels {rk} | plain: every key within {dm:.2e}, confusion matrix equal "
        f"{vk.confusion_matrix.matrix.tolist()}, {n_det} detections over {VAL_HELDOUT[0]} images equal per image (max |box/conf diff| "
        f"{worst:.3e}); launches {launches}")
    log("val kernels f32", card, f"for scale only: the JAX demo's recorded held-out mAP50 {demo['mAP50']:.4f}, "
        f"mAP50-95 {demo['mAP50-95']:.4f} (demos/artifacts/demo_report.json); the port's here {rk['mAP50']:.4f}, {rk['mAP50-95']:.4f}")
    rb, _ = val_run(data, batch=16, half=True)
    log("val kernels bf16", card, f"{rb}; bf16 - f32: " + ", ".join(f"{k} {rb[k] - rk[k]:+.4f}" for k in rb))
    val_kernel_holds(model, params, data, card)


def val_phase(data, warm_data, card):
    """`[val]`: YOLO(best.npz).val on a 256-frame split (seed 20,000), f32 and bf16 at batch 16 (the
    cfg default) and 32, each after a warm-up of the same YOLO on the 32-frame split: images/s by
    the host clock over the `.val(...)` call alone (the model built and its weights on the card
    before the clock starts), the per-batch split (loader wait on the main thread, upload + forward +
    NMS in CUDA events, the wait on the copy back, host matching) and each kernel's launches (6
    c2f, 3 c2f_upconcat, 4 head_level and 1 nms_keep a batch); at batch 16 also a profiled call
    for the device's idle share."""
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.data.dataset import YOLODataset

    YOLODataset(str(Path(data).parent / "images" / "val"))  # the label cache, written before any timed run
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    per_batch = {"c2f": 6, "c2f_upconcat": 3, "head_level": 4, "nms_keep": 1}
    for half in (False, True):
        for batch in (16, 32):
            y = YOLO(str(WEIGHTS))
            val_run(warm_data, y, batch=batch, half=half)  # weights, plans, cuDNN, allocator at this batch

            def timed():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = val_run(data, y, batch=batch, half=half)
                return out, time.perf_counter() - t0

            ((res, v), wall), launches = counted(path, timed)
            n_b = len(v.timings)
            if n_b != -(-VAL_FRAMES[0] // batch) or any(launches[k] != c * n_b for k, c in per_batch.items()):
                raise AssertionError(f"val batch {batch}: {n_b} batches, launches {launches}")
            mean = {k: sum(t[k] for t in v.timings) / n_b for k in v.timings[0]}
            tag = f"val {'bf16' if half else 'f32'} b{batch}"
            log(tag, card, f"{VAL_FRAMES[0]} images in {wall:.3f} s = {VAL_FRAMES[0] / wall:.1f} images/s (host clock, the "
                f".val call on a warm model); per batch: " + ", ".join(f"{k} {m:.2f} ms" for k, m in mean.items())
                + f"; mAP50 {res['mAP50']:.4f} mAP50-95 {res['mAP50-95']:.4f}; launches {launches}")
            if batch == 16:
                val_profile(tag, y, data, batch, half, card)


def val_profile(tag, y, data, batch, half, card):
    """One more val call under torch.profiler: the device's busy time (the sum of its kernels and
    copies) against the call's wall time → the idle share (the profiler's own host cost inflates
    the wall a little, so the share is an upper bound); the top device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        val_run(data, y, batch=batch, half=half)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")]  # kernels, copies, sets
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    busy = sum(dev(e) for e in on_card) / 1e6
    if busy <= 0:
        raise AssertionError(f"{tag}: the profiler recorded no device time ({len(on_card)} device events)")
    top_dev = sorted(on_card, key=dev, reverse=True)[:6]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log(tag + " profile", card, f"device busy {busy:.3f} s of {wall:.3f} s under the profiler: idle {1 - busy / wall:.1%}; "
        "device: " + ", ".join(f"{e.key[:40]} {dev(e) / 1e3:.1f} ms x{e.count}" for e in top_dev)
        + "; host self: " + ", ".join(f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}" for e in top_cpu))


def val_workers_sweep(data, warm_data, card):
    """`--profile`: the bf16 `[val]` call at batch 16 with 1, 2, 4, 8 (the cfg default) and 16 loader
    threads, then the validator's device pass alone (no loader) on one pinned-able batch: the host's
    time to issue it and the time left for the device after."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    for workers in (1, 2, 4, 8, 16):
        y = YOLO(str(WEIGHTS))
        val_run(warm_data, y, batch=16, half=True, workers=workers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, v = val_run(data, y, batch=16, half=True, workers=workers)
        wall = time.perf_counter() - t0
        mean = {k: sum(t[k] for t in v.timings) / len(v.timings) for k in v.timings[0]}
        log("val workers", card, f"bf16 b16, {workers:2d} loader threads: {VAL_FRAMES[0] / wall:.1f} images/s; per batch: "
            + ", ".join(f"{k} {m:.2f} ms" for k, m in mean.items()))
    y = YOLO(str(WEIGHTS))
    y.val(data=str(warm_data), imgsz=640, plots=False, half=True)
    imgs = np.random.default_rng(0).integers(0, 255, (16, 640, 640, 3), np.uint8)
    for _ in range(3):
        y.validator._device_pass(y.model, imgs, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        y.validator._device_pass(y.model, imgs, torch.device("cuda"), torch.bfloat16)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    log("val workers", card, f"the device pass alone (B = 16, bf16, no loader threads): the host issues it in "
        f"{(t1 - t0) / 10 * 1e3:.2f} ms, the device finishes {(time.perf_counter() - t1) * 1e3:.2f} ms after the tenth")


# ---------------------------------------------------------------- training --

TRAIN_SET = (64, 0)  # demos/ir_end_to_end.py::make_dataset: 64 train frames (seed 0), the held-out split as val
# train_small_targets.py:16-45 (the IR recipe) on yolov8-small.yaml at scale n, nc = 1, full width and depth;
# cut: epochs 3 (150) and close_mosaic 1 (20, which at 3 epochs would switch mosaic and copy-paste off at once)
TRAIN_RECIPE = dict(
    epochs=3, patience=30, batch=16, imgsz=640, optimizer="AdamW", lr0=0.0008, lrf=0.005, momentum=0.95,
    weight_decay=0.0008, warmup_epochs=5, hsv_h=0.0, hsv_s=0.0, hsv_v=0.3, degrees=0.0, translate=0.05, scale=0.2,
    shear=0.0, perspective=0.0, flipud=0.1, fliplr=0.5, mosaic=0.3, mixup=0.0, copy_paste=0.15, close_mosaic=1,
    amp=True, workers=8, seed=0,
)
# [train step f32], card against CPU: the loss and its components (relative), every gradient (absolute, as a
# share of its tensor's largest), the BN running moments after the step (absolute), and the parameters after
# the optimizer. AdamW's first step moves a parameter by lr · u(g), u(g) = g / (|g| + 1e-8) of the clipped
# gradient, which is ±1 wherever |g| >> 1e-8: a gradient near zero that differs between the devices within
# the gradient tolerance may move its parameter up to 2 lr the other way. So the parameters must agree
# within lr · |u(g_card) - u(g_cpu)| (from the two runs' own gradients, in float64) + TRAIN_STEP_TOL["param"]
TRAIN_STEP_TOL = {"loss": 1e-4, "grad": 1e-3, "bn": 1e-4, "param": 1e-6}


def zero_grad_leaves(model) -> set:
    """The train leaves whose gradient is zero by construction: the BN bias of the last depth-wise conv (`conv/2/cv2`)
    of each GhostBottleneck in a C3Ghost, whose output reaches the loss only through 1x1 convs (the next bottleneck's,
    C3's cv3) into training-mode BNs, which take any constant away. Their gradients are rounding noise of the sum
    that the same BN's weight gradient takes over the same terms, scaled by the normalised activations: it grows
    with the map (1e-7 at 64², 2e-5 at 640² and B = 16), so `train_step_f32_phase` holds each against the largest
    gradient of its BN's weight instead of its own largest. The same holds in the attention blocks of yolo11 and yolo12:
    the BN biases of an Attention's or AAttn's `pe` and `proj`, a PSABlock's `ffn.1` and an ABlock's `mlp.1` add a
    constant to a residual stream that reaches the loss only through 1x1 convs into training-mode BNs."""
    from yolo_tpu_torch.nn import modules as M

    def path(name, *rest):
        return "/".join(["model", *name.split(".")[1:], *rest, "bn", "bias"])

    zero = {path(name, "m", str(j), "conv", "2", "cv2") for name, m in model.named_modules() if isinstance(m, M.C3)
            for j, b in enumerate(m.m) if isinstance(b, M.GhostBottleneck) and b.s == 1}
    for name, m in model.named_modules():
        if isinstance(m, (M.Attention, M.AAttn)):
            zero |= {path(name, "pe"), path(name, "proj")}
        elif isinstance(m, M.PSABlock):
            zero.add(path(name, "ffn", "1"))
        elif isinstance(m, M.ABlock):
            zero.add(path(name, "mlp", "1"))
    return zero


def train_epoch_recorder(epochs: list, profile_epoch=None):
    """A DetectionTrainer whose hooks keep each epoch's numbers in `epochs`, and profile
    one epoch's training steps (`profile_epoch`, a dict that gets the result) with torch.profiler."""
    from yolo_tpu_torch.engine.trainer import DetectionTrainer

    class Recording(DetectionTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.callbacks["on_train_epoch_start"].append(self._start)
            self.callbacks["on_train_epoch_end"].append(self._train_end)
            self.callbacks["on_fit_epoch_end"].append(self._record)
            self._n, self._prof = 0, None

        def _start(self, t):
            self._t0 = time.perf_counter()
            if profile_epoch is not None and self._n == profile_epoch["epoch"]:
                from torch.profiler import ProfilerActivity, profile

                self._prof = profile(activities=[ProfilerActivity.CUDA])  # the device only: host tracing slows the steps 10x
                self._prof.__enter__()
            self._n += 1

        def _train_end(self, t):
            self._t_end = time.perf_counter()  # the epoch's losses were read: the device is done with its steps
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                profile_epoch.update(device_profile(self._prof, self._t_end - self._t0))
                self._prof = None

        def _record(self, t):
            profiled = profile_epoch is not None and self._n - 1 == profile_epoch["epoch"]
            epochs.append({"row": dict(t._last_row), "epoch_s": t.epoch_time, "val_s": t.val_time,
                           "timings": list(t.timings), "t_end": self._t_end, "profiled": profiled})

    return Recording


def device_profile(prof, wall: float) -> dict:
    """The device's busy time (its kernels, copies and sets) in a profiled window of `wall` s → busy,
    the window's idle share, the top device kernels."""
    events = prof.key_averages()
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    busy = sum(dev(e) for e in on_card) / 1e6
    if busy <= 0:
        raise AssertionError(f"the profiler recorded no device time ({len(on_card)} device events)")
    top = sorted(on_card, key=dev, reverse=True)[:6]
    return {"busy": busy, "wall": wall, "idle": 1 - busy / wall, "kernels": len(on_card),
            "top": ", ".join(f"{e.key[:40]} {dev(e) / 1e3:.1f} ms x{e.count}" for e in top)}


def train_step_flops(batch: int, imgsz: int = 640) -> tuple:
    """The operations of one train step's convolutions and matrix products (FlopCounterMode, from
    their shapes): (forward, forward + backward) of the yolov8-small train form on `batch` images."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from yolo_tpu_torch.nn.tasks import DetectionModel, load_train_params

    m = DetectionModel("yolov8-small.yaml")
    load_train_params(m, m.init(0))
    m.train()
    x = torch.rand(batch, imgsz, imgsz, 3, device="cuda", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fwd:
        outs = m.forward_features(x)
    with FlopCounterMode(display=False) as both:
        sum(o.float().sum() for o in m.forward_features(x)).backward()
    del outs
    return fwd.get_total_flops(), both.get_total_flops()


def train_phase(data, run_dir, card, profiling):
    """`[train]`: YOLO("yolov8-small.yaml").train with TRAIN_RECIPE on the 64-frame split, validating
    the EMA weights on the 32-frame held-out split each epoch: per epoch the loss components, P, R,
    mAP50, mAP50-95, epoch and validation seconds; train images/s over every step after the first of
    each epoch (host clock, from the step's loader wait to the epoch's read of its losses); the mean
    per-step split (loader wait on the host; forward + loss, backward, optimizer + BN + EMA in CUDA
    events); peak device memory; each kernel's launches (check_amp and the validations); with
    --profile, the device's idle share over the second epoch's steps."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs, prof = [], ({"epoch": 1} if profiling else None)
    y = YOLO("yolov8-small.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: y.train(
        trainer=train_epoch_recorder(epochs, prof), data=str(data), project=str(run_dir), name="train", exist_ok=True,
        **TRAIN_RECIPE))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    batch = TRAIN_RECIPE["batch"]
    for e in epochs:
        r = e["row"]
        if not all(np.isfinite(r[f"train/{k}_loss"]) for k in ("box", "cls", "dfl")) or r["train/box_loss"] <= 0:
            raise AssertionError(f"train: epoch {r['epoch']} losses {r}")
        log("train", card, f"epoch {r['epoch'] + 1}/{TRAIN_RECIPE['epochs']}: box {r['train/box_loss']:.4f} cls "
            f"{r['train/cls_loss']:.4f} dfl {r['train/dfl_loss']:.4f}; P {r['metrics/precision']:.4f} R {r['metrics/recall']:.4f} "
            f"mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    timed = [e for e in epochs if not e["profiled"]]
    images = sum((len(e["timings"]) - 1) * batch for e in timed)
    span = sum(e["t_end"] - e["timings"][1]["start"] for e in timed)
    steps = [t for e in timed for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("train", card, f"{images} images over the {len(steps)} steps after the first of each epoch not profiled: "
        f"{images / span:.1f} images/s "
        f"(host clock); per step: loader wait {mean['loader']:.2f} ms (host), forward+loss {mean['forward']:.2f} ms, backward "
        f"{mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms (events); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before the phase); the whole .train call {wall:.1f} s; launches {launches}")
    fwd, both = train_step_flops(batch)
    log("train", card, f"a step's convolutions: {both / 1e12:.3f} TFLOP (forward {fwd / batch / 1e9:.2f} GFLOP an image, "
        f"FlopCounterMode); at {PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s (bf16) the bound is {both / PEAK_OPS_PER_S['bfloat16'] * 1e3:.3f} "
        f"ms a step against {span / len(steps) * 1e3:.1f} ms measured")
    if prof:
        n_prof = len(next(e for e in epochs if e["profiled"])["timings"])
        busy_step, wall_step = prof["busy"] / n_prof, span / len(steps)
        log("train profile", card, f"epoch {prof['epoch'] + 1}'s {n_prof} steps: device busy {prof['busy']:.3f} s in {prof['wall']:.3f} s "
            f"under the profiler (idle {prof['idle']:.1%} there); {busy_step * 1e3:.1f} ms of device work a step against "
            f"{wall_step * 1e3:.1f} ms a step unprofiled: idle {1 - busy_step / wall_step:.1%}; device: {prof['top']}")
    if metrics is None or y.params is None:
        raise AssertionError("train: no metrics or weights")
    return y, launches


def train_step_f32_phase(data, card, cfg_name="yolov8-small.yaml", tag="train step f32", recipe=None):
    """`[train step f32]`: one f32 step of the trainer's path (forward, loss, backward, AdamW at the
    recipe's lr0 with its weight decay at batch 16, BN moments) on the card and on the CPU, from
    DetectionModel("yolov8-small.yaml").init(0) (or `cfg_name`'s model at the dataset's nc: a segment
    or pose model with its loss and the batch's masks or keypoints) and the first batch of the training
    loader (B = 16, 640x640): within TRAIN_STEP_TOL, or the run fails."""
    import numpy as np
    import torch

    from yolo_tpu_torch.cfg import get_cfg
    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset
    from yolo_tpu_torch.nn.tasks import guess_model_task, load_train_params, model_class_for, train_leaves, yaml_model_load
    from yolo_tpu_torch.engine.trainer import LOSSES
    from yolo_tpu_torch.utils.optim import AdamW, apply_bn_stats

    cfg = get_cfg(overrides=recipe or TRAIN_RECIPE)
    d = check_det_dataset(str(data))
    batch = next(iter(build_dataloader(build_yolo_dataset(cfg, d["train"], d, mode="train"), cfg.batch, workers=8, shuffle=True)))
    lr, decay = cfg.lr0, cfg.weight_decay * cfg.batch * max(round(cfg.nbs / cfg.batch), 1) / cfg.nbs
    yaml_cfg = yaml_model_load(cfg_name)
    model_cls = model_class_for(yaml_cfg)
    loss_cls = LOSSES[guess_model_task(yaml_cfg)]
    runs = {}
    for dev in ("cuda", "cpu"):
        m = model_cls(cfg_name, nc=d["nc"], device=dev)
        load_train_params(m, m.init(0))
        m.train()
        x = torch.from_numpy(batch["img"]).to(dev).float() / 255.0
        tb = {k: torch.from_numpy(batch[k]).to(dev) for k in ("cls", "bboxes", "mask_gt", "masks", "keypoints") if k in batch}
        t0 = time.perf_counter()
        total, comps = loss_cls(m, cfg)(m.forward_features(x), tb)
        total.backward()
        leaves = train_leaves(m)
        params = {k: t for k, t in leaves.items() if isinstance(t, torch.nn.Parameter)}
        grads = {k: t.grad.detach().cpu().clone() for k, t in params.items()}  # before the clip scales them in place
        AdamW(list(params.items()), weight_decay=decay).step(lr, None, lr_bias=lr)
        apply_bn_stats(m)
        after = {k: t.detach().cpu().clone() for k, t in leaves.items()}
        runs[dev] = (float(total.detach()), comps.cpu().numpy(), grads, after, time.perf_counter() - t0)
    (tc, cc, gc, pc, sc), (tp, cp, gp, pp, sp) = runs["cuda"], runs["cpu"]
    err = {"loss": max(abs(tc - tp) / abs(tp), float(np.abs(cc - cp).max() / np.abs(cp).max()))}
    zero = zero_grad_leaves(m)
    floor = {k: float(gp[k[: -len("bias")] + "weight"].abs().max()) if k in zero else 1e-30 for k in gp}
    by_leaf = {k: float((gc[k] - gp[k]).abs().max() / gp[k].abs().max().clamp(min=floor[k])) for k in gp}
    worst_leaf = max(by_leaf, key=by_leaf.get)
    err["grad"] = by_leaf[worst_leaf]
    err["bn"] = max(float((pc[k] - pp[k]).abs().max()) for k in pp if "running" in k)
    def u(g):  # AdamW's first-step direction of each gradient after the global-norm clip at 10
        g = {k: v.double() for k, v in g.items()}
        scale = min(1.0, 10.0 / (float(torch.sqrt(sum((v * v).sum() for v in g.values()))) + 1e-6))
        return {k: scale * v / ((scale * v).abs() + 1e-8) for k, v in g.items()}

    uc, up = u(gc), u(gp)
    err["param"], apart = 0.0, 0
    for k in gp:
        excess = (pc[k] - pp[k]).double().abs() - lr * (uc[k] - up[k]).abs()
        err["param"] = max(err["param"], float(excess.max()))
        apart += int((torch.sign(gc[k]) != torch.sign(gp[k])).sum())
    zeros = (f"; the {len(zero)} gradients zero by construction (largest on the CPU {max(float(gp[k].abs().max()) for k in zero):.3e}, "
             f"card against CPU {max(float((gc[k] - gp[k]).abs().max()) for k in zero):.3e}) held against their BN weight's "
             f"gradient: {max(by_leaf[k] for k in zero):.3e} of it at most" if zero else "")
    if any(v > TRAIN_STEP_TOL[k] for k, v in err.items()):
        raise AssertionError(f"{tag}: card vs CPU {err} beyond {TRAIN_STEP_TOL}; the gradient's worst leaves: "
                             + ", ".join(f"{k} {by_leaf[k]:.3e} (its largest {float(gp[k].abs().max()):.3e})"
                                         for k in sorted(by_leaf, key=by_leaf.get)[-5:]) + zeros)
    log(tag, card, f"{cfg_name}: loss {tc:.6f} (CPU {tp:.6f}), components {np.round(cc, 6).tolist()} (CPU "
        f"{np.round(cp, 6).tolist()}); largest differences, as TRAIN_STEP_TOL measures them: {err} (the gradient's at "
        f"{worst_leaf}){zeros}; {apart} gradient elements of opposite sign (near zero); the step took "
        f"{sc:.2f} s on the card (its first) and {sp:.2f} s on the CPU; all {len(gp)} gradients and {len(pp)} tensors held")


def train_step_precision_phase(data, card, cfg_name="yolo12n.yaml", recipe=None):
    """`[train step precision]` (`--profile`): the f32 train step of `[train step f32]` (init(0), the loader's first batch
    of 16 at 640²) on the card with cuDNN, on the card without it and on the CPU, each parameter's gradient against the
    same step in float64 on the card (the BN moments, SiLU's logistic and area attention stay f32 inside it, as the train
    form computes them) as a share of its largest: how closely f32 arithmetic itself resolves each gradient, the floor
    under TRAIN_STEP_TOL's card-against-CPU gate. The leaves `zero_grad_leaves` names are left out."""
    import torch

    from yolo_tpu_torch.cfg import get_cfg
    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset
    from yolo_tpu_torch.engine.trainer import LOSSES
    from yolo_tpu_torch.nn.tasks import guess_model_task, load_train_params, model_class_for, train_leaves, yaml_model_load

    cfg = get_cfg(overrides=recipe or TRAIN_RECIPE)
    d = check_det_dataset(str(data))
    batch = next(iter(build_dataloader(build_yolo_dataset(cfg, d["train"], d, mode="train"), cfg.batch, workers=8, shuffle=True)))
    yaml_cfg = yaml_model_load(cfg_name)
    model_cls, loss_cls = model_class_for(yaml_cfg), LOSSES[guess_model_task(yaml_cfg)]
    runs = {}
    for name, dev, dtype, cudnn in (("f64", "cuda", torch.float64, True), ("card", "cuda", torch.float32, True),
                                    ("card without cuDNN", "cuda", torch.float32, False), ("CPU", "cpu", torch.float32, True)):
        torch.backends.cudnn.enabled = cudnn
        try:
            m = model_cls(cfg_name, nc=d["nc"], device=dev)
            load_train_params(m, m.init(0))
            m.to(dtype).train()
            x = torch.from_numpy(batch["img"]).to(dev, dtype) / 255.0
            tb = {k: torch.from_numpy(batch[k]).to(dev) for k in ("cls", "bboxes", "mask_gt") if k in batch}
            tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
            total, _ = loss_cls(m, cfg)(m.forward_features(x), tb)
            total.backward()
            runs[name] = (float(total.detach()), {k: t.grad.detach().double().cpu() for k, t in train_leaves(m).items()
                                                  if isinstance(t, torch.nn.Parameter)})
        finally:
            torch.backends.cudnn.enabled = True
    (l64, ref), zero = runs.pop("f64"), zero_grad_leaves(m)
    rows = []
    for name, (loss, g) in runs.items():
        share = {k: float((g[k] - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-30)) for k in ref if k not in zero}
        worst = sorted(share, key=share.get)[-3:]
        rows.append(f"{name}: loss {abs(loss - l64) / abs(l64):.2e} relative, gradients at most {share[worst[-1]]:.2e} of their "
                    f"largest (" + ", ".join(f"{k} {share[k]:.2e}, its largest {float(ref[k].abs().max()):.2e}" for k in worst) + ")")
    log("train step precision", card, f"{cfg_name}, each f32 step against the f64 step: " + "; ".join(rows))


def hold_val_runs(tag, card, rk, vk, rp, vp):
    """f32 kernels against f32 twins on one split: metrics within 1e-4, equal confusion matrices, the
    same detections per image → the number of detections and the largest |box / conf| difference."""
    import numpy as np

    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if max(diff.values()) > 1e-4 or not np.array_equal(vk.confusion_matrix.matrix, vp.confusion_matrix.matrix):
        raise AssertionError(f"{tag}: kernels {rk} vs plain {rp}; confusion matrices {vk.confusion_matrix.matrix.tolist()} "
                             f"vs {vp.confusion_matrix.matrix.tolist()}")
    worst = same_val_detections(vk, vp)
    return sum(int((o[:, 6] > 0).sum()) for out in vk.outs for o in out), max(diff.values()), worst


def train_val_kernels_phase(trees, data, card):
    """`[train val kernels]`: the validator in f32 on the held-out split, through the kernels and with
    plain=True, on each trained YOLO of `trees` ({name: YOLO}: `[train]`'s, holding its final best EMA
    tree, and `[train finetune]`'s): the same metrics within 1e-4, the same confusion matrix and the
    same detections per image, or the run fails."""
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    for name, y in trees.items():
        (rk, vk), launches = counted(path, lambda: val_run(data, y, batch=16))
        rp, vp = val_run(data, y, batch=16, plain=True)
        n_det, dm, worst = hold_val_runs(f"train val {name}", card, rk, vk, rp, vp)
        log("train val kernels", card, f"{name}: kernels {rk} | plain: every key within {dm:.2e}, confusion matrix equal "
            f"{vk.confusion_matrix.matrix.tolist()}, {n_det} detections equal per image (max |box/conf diff| {worst:.3e}); "
            f"launches {launches}")


def train_finetune_phase(data, run_dir, card):
    """`[train finetune]` (report only): YOLO(best.npz), the demo's trained weights, validated on the
    held-out split (f32), then one epoch of TRAIN_RECIPE from them (the pretrained path; close_mosaic 1
    makes it a clean epoch) and its own validation → the fine-tuned YOLO."""
    from yolo_tpu_torch import YOLO

    y = YOLO(str(WEIGHTS))
    before, _ = val_run(data, y, batch=16)
    t0 = time.perf_counter()
    after = y.train(data=str(data), project=str(run_dir), name="finetune", exist_ok=True, plots=False,
                    **{**TRAIN_RECIPE, "epochs": 1})
    log("train finetune", card, f"{WEIGHTS.relative_to(ROOT)} on the held-out split: mAP50 {before['mAP50']:.4f} "
        f"mAP50-95 {before['mAP50-95']:.4f}; after one epoch of the recipe ({time.perf_counter() - t0:.1f} s, "
        f"{'bf16' if y.trainer.args.amp else 'f32: check_amp refused bf16'}): mAP50 {after['mAP50']:.4f} "
        f"mAP50-95 {after['mAP50-95']:.4f}")
    return y


# ------------------------------------------- otherplan, tiles, TTA, ensembles, embed --

TILE, TILE_OVERLAP = 256, 0.25  # 9 tiles of a 640x512 frame, one batch padded to B = 16
SLICE_FRAMES = 16  # frames of the `[tiled]`, `[tta]`, `[ensemble]` and `[embed]` phases (cut from 32 to fit the time limit)
ENHANCE_FRAMES, ENHANCE_CPU_FRAMES = 64, 16  # cut to fit the run's time limit (PERF.md §4)
VIDEO_FRAMES = 32  # `[detect_only]` / `[single target]`: the clip's first frames as an mp4v file


def c2f_widths_phase(card):
    """`[c2f widths]`: kernels 1 and 2 against their twins at every published width (`cuda_c2f.C2F_WIDTHS`: the C2f
    and neck-fold instances of yolov8 and yolov10 n-x at 640², yolov8-small n-x at 640x512), f32 and bf16, one frame,
    on seeded weights and N(0, 1) inputs, each held with the live gate; every plan printed at B = 1 and 8 (tile,
    passes, ring chunk, shared bytes). For the widest instance of each model, bf16 at B = 8: the kernel's time beside
    the cuDNN conv walk's and the bound. A disagreement raises → the number of instances held."""
    import numpy as np
    import torch

    from yolo_tpu_torch.nn import modules as PM
    from yolo_tpu_torch.nn.tasks import DetectionModel, yaml_model_load
    from yolo_tpu_torch.ops import cuda_c2f

    def block(c1, cs, c, c2o, n, dtype, seed=0):
        rng = np.random.default_rng(seed)
        mod = PM.C2f(c1, c2o, n=n, shortcut=not cs)
        for m in mod.modules():
            if isinstance(m, PM.ConvBNAct):
                fan_in = m.weight[0].numel()
                m.weight = torch.from_numpy(rng.uniform(-1, 1, tuple(m.weight.shape)) / np.sqrt(fan_in)).float().to("cuda", dtype)
                m.bias = torch.from_numpy(rng.normal(0, 0.1, tuple(m.bias.shape))).float().to("cuda", dtype)
        return mod, rng

    def inputs(rng, B, c1, cs, H, W, dtype):
        skip = torch.from_numpy(rng.normal(0, 1, (B, H, W, c1 - cs))).float().to("cuda", dtype)
        small = torch.from_numpy(rng.normal(0, 1, (B, H // 2, W // 2, cs))).float().to("cuda", dtype) if cs else None
        return small, skip

    held = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for c1, cs, c, c2o, n, H, W in cuda_c2f.C2F_WIDTHS:
            mod, rng = block(c1, cs, c, c2o, n, dtype)
            kw, sc = mod.kernel_weights(), mod.shortcut
            small, skip = inputs(rng, 1, c1, cs, H, W, dtype)
            name, args = ("c2f_upconcat", (small, skip, kw, sc)) if cs else ("c2f", (skip, kw, sc))
            kern, plain = ((cuda_c2f.fused_c2f_upconcat, cuda_c2f.c2f_upconcat_plain) if cs
                           else (cuda_c2f.fused_c2f, cuda_c2f.c2f_plain))
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            desc = f"{H}x{W} {f'up({cs})+{c1 - cs}' if cs else c1}->{c2o} c={c} n={n}"
            err = hold(name, desc, dn, got, want)["output 0"]
            share = live_share(name, plain, args, want)
            if share < LIVE_SHARE:
                raise AssertionError(f"c2f widths {dn}: {desc}: only {share:.3f} of the twin's outputs depend on the input")
            held += 1
            log(f"c2f widths {dn}", card, f"{desc:36s} max_abs_err={err:.3e} live={share:.3f} B=1: "
                f"{c2f_plan_text(1, H, W, c1, cs, kw, dtype)} | B=8: {c2f_plan_text(8, H, W, c1, cs, kw, dtype)}")
    # the widest instance of each model, timed
    for cfg, scale, H, W in cuda_c2f.WIDTH_MODELS:
        d = yaml_model_load(cfg)
        if scale:
            d["scale"] = scale
        insts = DetectionModel(d, device="cpu").c2f_instances(H, W)
        c1, cs, c, c2o, n, h, w = max(insts, key=lambda t: t[5] * t[6] * (t[0] * 2 * t[2] + t[4] * 18 * t[2] ** 2 + (2 + t[4]) * t[2] * t[3]))
        dtype = torch.bfloat16
        mod, rng = block(c1, cs, c, c2o, n, dtype)
        kw, sc = mod.kernel_weights(), mod.shortcut
        small, skip = inputs(rng, 8, c1, cs, h, w, dtype)
        walk = library_c2f(kw, sc, dtype)
        if cs:
            ls, lk = _nchw(small), _nchw(skip)
            kern = lambda: cuda_c2f.fused_c2f_upconcat(small, skip, kw, sc)  # noqa: E731
            lib = lambda: walk(torch.cat([torch.nn.functional.interpolate(ls, scale_factor=2.0), lk], 1))  # noqa: E731
            ins = (small, skip)
            macs = (h // 2) * (w // 2) * cs * 2 * c + h * w * ((c1 - cs) * 2 * c + n * 18 * c * c + (2 + n) * c * c2o)
        else:
            lx = _nchw(skip)
            kern = lambda: cuda_c2f.fused_c2f(skip, kw, sc)  # noqa: E731
            lib = lambda: walk(lx)  # noqa: E731
            ins = (skip,)
            macs = h * w * (c1 * 2 * c + n * 18 * c * c + (2 + n) * c * c2o)
        out = kern()
        wbytes = _nbytes(*(t for k, t in vars(kw).items() if torch.is_tensor(t) and not k.startswith("_")))
        bound, by = _bound(_nbytes(*ins, out) + wbytes, 2.0 * 8 * macs, "bfloat16")
        log("c2f widths bfloat16", card, f"widest of {cfg}{' ' + scale if scale else ''}: B=8 {h}x{w} "
            f"{f'up({cs})+{c1 - cs}' if cs else c1}->{c2o} c={c} n={n} kernel_ms={cuda_ms(kern):.4f} "
            f"library_ms(cudnn walk)={cuda_ms(lib):.4f} bound_ms={bound:.4f} ({by}) {c2f_plan_text(8, h, w, c1, cs, kw, dtype)}")
    return held


LIVE_SHARE = 0.5  # `hold_path_kernels(live=True)`: the least share of a twin's outputs that must depend on its input maps


def bn_calibrated(model, tree, x):
    """`tree` (unfused) with every BN's running moments taken from one train-mode forward of the NHWC images `x`
    through `model` in f32: the batch's mean and unbiased variance (`apply_bn_stats` at momentum 1). An initial
    tree's activations fade through its depth (BN moments 0 and 1 over convs that shrink their input); these keep
    them near unit scale, as a trained tree's are, so that a kernel held on them can fail. → the unfused tree."""
    import torch

    from yolo_tpu_torch.nn.tasks import load_train_params, params_to_jax
    from yolo_tpu_torch.utils.optim import apply_bn_stats

    load_train_params(model, tree)
    model.train()
    with torch.no_grad():
        model.forward_features(x)
    apply_bn_stats(model, 1.0)
    model.eval()
    return params_to_jax(model)


def live_share(name, plain, args, want) -> float:
    """The share of the twin `plain`'s output elements whose input-dependent part (`want` minus its output with the
    instance's maps set to zero) exceeds ten times the f32 tolerance: where it is small, a kernel that ignores or
    misreads its input would still agree with the twin."""
    import torch

    zeroed = [torch.zeros_like(a) if i in ((0, 1) if name == "c2f_upconcat" else (0,)) else a for i, a in enumerate(args)]
    base = plain(*zeroed)
    want, base = (want,) if torch.is_tensor(want) else want, (base,) if torch.is_tensor(base) else base
    atol, rtol = TOL["float32"]
    live = sum(int(((w.float() - b.float()).abs() > 10 * (atol + rtol * w.float().abs())).sum()) for w, b in zip(want, base))
    return live / sum(w.numel() for w in want)


def hold_path_kernels(models, x, tag, card, conf=0.15, iou=0.6, max_nms=1024, nms=True, live=False):
    """Kernels 1, 2, 3 and 5 against their twins on the activations of one f32 forward of the NHWC
    images `x` through each model (loaded in f32 on the card): every C2f and upconcat instance and
    every Detect level at TOL, the NMS keep mask over the models' candidates joined on the anchor
    axis (K = max_nms at `conf`, as the predictor forms them) bit for bit, unless `nms` is False (a
    path without kernel 5). `live`: each instance's twin output must also depend on its input maps
    (`live_share` at least LIVE_SHARE), or the hold could not fail → {kernel: max |err|}."""
    import torch

    from yolo_tpu_torch.ops import cuda_c2f, cuda_head

    kernels = {"c2f": (cuda_c2f.fused_c2f, cuda_c2f.c2f_plain), "c2f_upconcat": (cuda_c2f.fused_c2f_upconcat, cuda_c2f.c2f_upconcat_plain),
               "head_level": (cuda_head.fused_head_level, cuda_head.head_level_plain)}
    worst, parts, n, shares = {}, [], 0, []
    for model in models:
        rec, boxes, scores = capture_instances(model, x)
        parts.append((boxes, scores))
        for name, args in rec:
            kern, plain = kernels[name]
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            desc = f"{tag} {tuple(args[-3 if name == 'c2f_upconcat' else 0].shape)}"
            errs = hold(name, desc, "float32", got, want)
            worst[name] = max(worst.get(name, 0.0), *errs.values())
            n += 1
            if live:
                shares.append(live_share(name, plain, args, want))
                if shares[-1] < LIVE_SHARE:
                    raise AssertionError(f"{name} {desc}: only {shares[-1]:.3f} of the twin's outputs depend on the input "
                                         f"beyond 10x TOL (at least {LIVE_SHARE}): the hold could not fail")
    held = (f"{n} C2f / Detect instances within atol = rtol = 1e-3 (max |err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items() if k != "nms_keep") + ")"
            + (f", each with at least {min(shares):.3f} of its twin's outputs depending on its input beyond 10x that" if shares else ""))
    if not n:
        held = "no C2f or head-kernel instance on this path"
    if not nms:
        log(tag, card, f"f32 kernels against twins on {tuple(x.shape)} through {len(models)} model(s): {held}")
        return worst
    nms = hold_nms(tag, torch.cat([b for b, _ in parts], 1), torch.cat([s for _, s in parts], 1), conf, iou, max_nms, live)
    worst["nms_keep"] = 0.0
    log(tag, card, f"f32 kernels against twins on {tuple(x.shape)} through {len(models)} model(s): {held}, NMS "
        f"B={nms['B']} K={nms['K']} kept {nms['kept']} of {nms['valid']} valid, bit for bit"
        + (f" (live share {nms['live']:.3f})" if live else ""))
    return worst


def letterboxed(frame, imgsz=640):
    """One BGR frame as the predictor feeds the device: the native letterbox, RGB in [0, 1], f32 (1, H, W, 3)."""
    import torch

    from yolo_tpu_torch import native

    img, _ = native.letterbox(frame, (imgsz, imgsz))
    return torch.from_numpy(img[None]).cuda().flip(-1).float() / 255.0


def merged_rows(out):
    """tiled_predict's (boxes, scores, cls) → (M, 6) rows, as same_dets takes them."""
    import numpy as np

    boxes, scores, cls = out
    return np.concatenate([boxes, scores[:, None], cls[:, None]], 1)


def timed_frames(fn, frames):
    """`fn(frame)` over the frames (each call ends in its device wait) → (outputs, seconds on the host clock)."""
    t0 = time.perf_counter()
    out = [fn(f) for f in frames]
    return out, time.perf_counter() - t0


def tiled_phase(clip, card):
    """`[tiled]`: the clip's first 32 frames as BGR through `ops.tiling.tiled_predict` (tile 256, overlap
    0.25: 9 tiles, one batch padded to B = 16 a frame), f32 through the kernels against the same
    calls through the twins (merged boxes at the f32 gates), kernels 1, 2, 3 and 5 held against their
    twins on one frame's tile batch, then bf16, timed: frames/s, the padded B, the launches."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.engine.predictor import _snap_batch
    from yolo_tpu_torch.ops.tiling import slice_tiles, tile_grid, tiled_predict

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    grid = tile_grid(*HW, TILE, TILE_OVERLAP)
    kw = dict(tile=TILE, overlap=TILE_OVERLAP, conf=0.15, iou=0.6)
    yk, yp = YOLO(str(WEIGHTS)), YOLO(str(WEIGHTS))
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: tiled_predict(yk, f, compute_dtype="float32", **kw), frames))
    want, wp = timed_frames(lambda f: tiled_predict(yp, f, compute_dtype="float32", plain=True, **kw), frames)
    worst = same_dets([merged_rows(g) for g in got], [merged_rows(w) for w in want], "tiled kernels vs twins")
    n_det = sum(len(g[0]) for g in got)
    if n_det <= 0 or launches["c2f"] != 6 * SLICE_FRAMES:
        raise AssertionError(f"[tiled] {n_det} detections, launches {launches} (one batch a frame expected)")
    log("tiled f32", card, f"{len(grid)} tiles a frame; kernels {n_det} merged detections in {wk:.2f} s | twins in {wp:.2f} s | equal "
        f"counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}")
    tiles = np.zeros((_snap_batch(len(grid)), TILE, TILE, 3), np.uint8)
    tiles[: len(grid)] = slice_tiles(frames[-1], grid, TILE)
    import torch

    hold_path_kernels([yk.model], torch.from_numpy(tiles).cuda().flip(-1).float() / 255.0, "tiled f32", card)

    yb = YOLO(str(WEIGHTS))
    tiled_predict(yb, frames[0], **kw)  # warm-up: the plans of B = 16 at 256x256, the allocator
    yb.predictor.timings = []
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: tiled_predict(yb, f, **kw), frames))
    padded = sorted({t["B"] for t in yb.predictor.timings})
    same = sum(len(a[0]) == len(b[0]) for a, b in zip(bf, got))
    log("tiled bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock; one predict of "
        f"{len(grid)} tiles a frame, padded B {padded}); {sum(len(b[0]) for b in bf)} detections, counts equal to f32 on "
        f"{same}/{SLICE_FRAMES} frames; launches {launches}")
    if padded != [16]:
        raise AssertionError(f"[tiled] the tiles went in batches of {padded}, not one of 16")


def launches_by_shape(model):
    """Count each kernel's launches per input size of `model.predict` (an instance attribute
    wraps the method until `del model.predict`) → {(H, W): {kernel: launches}}."""
    counters, per, real = launch_counters(), {}, model.predict

    def predict(x, *a, **k):
        before = {n: f.launches for n, f in counters.items()}
        out = real(x, *a, **k)
        d = per.setdefault(tuple(x.shape[1:3]), dict.fromkeys(counters, 0))
        for n, f in counters.items():
            d[n] += f.launches - before[n]
        return out

    model.predict = predict
    return per


def tta_phase(clip, card):
    """`[tta]`: 32 BGR frames through `YOLO(best.npz).predict(augment=True, imgsz=640)` (the scales 1,
    0.83 flipped and 0.67: 640x640, 544x544 and 448x448 on the device), f32 through the kernels against
    the twins (the f32 gates), the launches per shape, kernels 1, 2, 3 and 5 held against their twins
    at each scaled image of one frame; then bf16, timed."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import AUGMENT_FLIPS, AUGMENT_SCALES, _scale_img

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    kw = dict(augment=True, imgsz=640, conf=0.15, iou=0.6, verbose=False)
    yk, yp = YOLO(str(WEIGHTS)), YOLO(str(WEIGHTS))
    per = launches_by_shape(yk.model)
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(
        lambda f: yk.predict(f, compute_dtype="float32", **kw)[0].boxes.data, frames))
    del yk.model.predict
    want, wp = timed_frames(lambda f: yp.predict(f, compute_dtype="float32", plain=True, **kw)[0].boxes.data, frames)
    worst = same_dets(got, want, "tta kernels vs twins")
    if sum(len(g) for g in got) <= 0 or sorted(per) != [(448, 448), (544, 544), (640, 640)]:
        raise AssertionError(f"[tta] {sum(len(g) for g in got)} detections, shapes {sorted(per)}")
    log("tta f32", card, f"kernels {sum(len(g) for g in got)} detections in {wk:.2f} s ({SLICE_FRAMES / wk:.1f} frames/s) | twins in "
        f"{wp:.2f} s | equal counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}; per shape "
        + "; ".join(f"{h}x{w}: " + ", ".join(f"{k} {v}" for k, v in d.items() if v) for (h, w), d in sorted(per.items(), reverse=True)))
    x = letterboxed(frames[-1])
    gs = int(max(yk.model.stride))
    for ratio, flip in zip(AUGMENT_SCALES, AUGMENT_FLIPS):
        hold_path_kernels([yk.model], _scale_img(x.flip(2) if flip else x, ratio, gs), f"tta f32 scale {ratio}", card)

    yb = YOLO(str(WEIGHTS))
    yb.predict(frames[0], **kw)  # warm-up: the three shapes' plans
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yb.predict(f, **kw)[0].boxes.data, frames))
    log("tta bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock, one predict a frame, "
        f"three forwards); {sum(len(b) for b in bf)} detections; launches {launches}")


def ensemble_phase(clip, card):
    """`[ensemble]`: `YOLO([best.npz, last.npz])`, the two members' predictions in one NMS, over 32 BGR
    frames: f32 through the kernels against the twins (the f32 gates), kernels 1, 2, 3 and 5 held against
    their twins through both members on one frame (NMS over the joined candidates); then bf16, timed."""
    import numpy as np

    from yolo_tpu_torch import YOLO

    members = [str(WEIGHTS), str(WEIGHTS.with_name("last.npz"))]
    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    kw = dict(imgsz=640, conf=0.15, iou=0.6, verbose=False)
    yk, yp = YOLO(members), YOLO(members)
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yk.predict(f, compute_dtype="float32", **kw)[0].boxes.data, frames))
    want, wp = timed_frames(lambda f: yp.predict(f, compute_dtype="float32", plain=True, **kw)[0].boxes.data, frames)
    worst = same_dets(got, want, "ensemble kernels vs twins")
    if sum(len(g) for g in got) <= 0 or launches["c2f"] != 2 * 6 * SLICE_FRAMES:
        raise AssertionError(f"[ensemble] {sum(len(g) for g in got)} detections, launches {launches}")
    log("ensemble f32", card, f"2 members; kernels {sum(len(g) for g in got)} detections in {wk:.2f} s ({SLICE_FRAMES / wk:.1f} "
        f"frames/s) | twins in {wp:.2f} s | equal counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}")
    hold_path_kernels(yk.model.models, letterboxed(frames[-1]), "ensemble f32", card)
    yb = YOLO(members)
    yb.predict(frames[0], **kw)
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yb.predict(f, **kw)[0].boxes.data, frames))
    log("ensemble bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock, one predict a "
        f"frame); {sum(len(b) for b in bf)} detections; launches {launches}")


def embed_phase(clip, card):
    """`[embed]`: `YOLO(best.npz).embed` of 32 BGR frames (square letterbox to 640, f32, the layer before
    the head, the neck folded): through the kernels against through the twins within 1e-4, kernels 1 and
    2 launched (no head, no NMS); ms/frame; kernels 1, 2, 3 and 5 held on the embed input of one frame."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.ops.letterbox import LetterBox

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    y = YOLO(str(WEIGHTS))
    y.embed(frames[0])  # warm-up
    (got, wk), launches = counted({"c2f", "c2f_upconcat"}, lambda: timed_frames(lambda f: y.embed(f)[0], frames))
    want, wp = timed_frames(lambda f: y.embed(f, plain=True)[0], frames)
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    if diff > 1e-4 or got[0].ndim != 1 or not all(np.isfinite(g).all() for g in got):
        raise AssertionError(f"[embed] kernels vs twins differ by {diff}, or shape {got[0].shape}")
    log("embed f32", card, f"{SLICE_FRAMES} vectors of {got[0].shape[0]} in {wk * 1e3 / SLICE_FRAMES:.3f} ms/frame (twins "
        f"{wp * 1e3 / SLICE_FRAMES:.3f}); max |diff| {diff:.3e} (gate 1e-4); launches {launches}")
    import torch

    x = torch.from_numpy(np.ascontiguousarray(LetterBox((640, 640), auto=False)(frames[-1])[None, ..., ::-1], np.float32) / 255.0).cuda()
    hold_path_kernels([y.model], x, "embed f32", card)


def enhance_phase(clip, card):
    """`[enhance]`: `otherplan.enhance_small_targets_torch` on a 128-frame 640x512 batch on the card against
    the host's cv2 `enhance_small_targets` frame by frame (ms/frame each), the largest difference from the
    same torch function on the CPU (16 frames), and `classical_detect` on the card's and the CPU's
    enhancement of those frames (equal box lists required), and on the host's cv2 enhancement (reported)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.otherplan import classical_detect, enhance_small_targets, enhance_small_targets_torch

    gray = np.ascontiguousarray(clip[:ENHANCE_FRAMES, ..., 0])
    dev = torch.from_numpy(gray).cuda()
    card_out = enhance_small_targets_torch(dev)
    ms = cuda_ms(lambda: enhance_small_targets_torch(dev), iters=3, warmup=1) / ENHANCE_FRAMES
    t0 = time.perf_counter()
    host = [enhance_small_targets(g) for g in gray]
    host_ms = (time.perf_counter() - t0) * 1e3 / ENHANCE_FRAMES
    cpu = enhance_small_targets_torch(torch.from_numpy(gray[:ENHANCE_CPU_FRAMES]))
    ours = card_out[:ENHANCE_CPU_FRAMES].cpu()
    diff = float((ours - cpu).abs().max())
    boxes_card = [classical_detect(g, enhanced=e.numpy().astype(np.uint8)) for g, e in zip(gray, ours)]
    boxes_cpu = [classical_detect(g, enhanced=e.numpy().astype(np.uint8)) for g, e in zip(gray, cpu)]
    boxes_host = [classical_detect(g, enhanced=e) for g, e in zip(gray, host)]
    if card_out.shape != dev.shape or not torch.isfinite(card_out).all() or diff > 1e-3 or boxes_card != boxes_cpu:
        raise AssertionError(f"[enhance] card vs CPU differ by {diff} (gate 1e-3 on 0-255) or in classical_detect's boxes")
    host_diff = float(np.abs(card_out.cpu().numpy() - np.stack(host).astype(np.float32)).max())
    log("enhance", card, f"{ENHANCE_FRAMES} frames of 640x512: card {ms:.4f} ms/frame (events) | host cv2 {host_ms:.3f} ms/frame; "
        f"card vs CPU torch max |diff| {diff:.3e} on {ENHANCE_CPU_FRAMES} frames (gate 1e-3), classical_detect box lists equal "
        f"({sum(len(b) for b in boxes_card)} boxes); vs the cv2 enhancement (another border and kernel): max |diff| {host_diff:.1f}, "
        f"box lists equal on {sum(a == b for a, b in zip(boxes_card, boxes_host))}/{ENHANCE_CPU_FRAMES} frames")


def video_phases(clip, card):
    """`[detect_only]`: the clip's first 64 frames as an mp4v file through `otherplan.detect_only` with
    its default detector (`YOLO(best.npz)`, fused, bf16, on the card), timed, and with f32 detectors
    through the kernels and the twins (equal stats). `[single target]`: `run_single_target_tracking` over
    the file with the port's YOLO (bf16) as the detector: frames/s, stats and the CSV's rows."""
    import csv

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.kalman.pipeline import yolo_detector
    from yolo_tpu_torch.otherplan import detect_only, run_single_target_tracking

    with tempfile.TemporaryDirectory() as tmp:
        vid = write_bgr_video(Path(tmp) / "clip.mp4", clip[:VIDEO_FRAMES])
        detect_only(vid, model=str(WEIGHTS), max_frames=2)  # warm-up
        t0 = time.perf_counter()
        stats, launches = counted(SERVE_PATH, lambda: detect_only(vid, model=str(WEIGHTS), output_video=Path(tmp) / "det.mp4"))
        wall = time.perf_counter() - t0
        f32 = []
        for plain in (False, True):
            y = YOLO(str(WEIGHTS)).fuse()
            f32.append(detect_only(vid, detector=lambda f, y=y, plain=plain: y.predict(
                f, conf=0.15, compute_dtype="float32", plain=plain, verbose=False)[0].boxes.data))
        if f32[0] != f32[1] or stats["frames"] != VIDEO_FRAMES or stats["total_detections"] <= 0:
            raise AssertionError(f"[detect_only] bf16 {stats}; f32 kernels {f32[0]} vs twins {f32[1]}")
        log("detect_only", card, f"{stats} in {wall:.2f} s = {stats['frames'] / wall:.1f} frames/s (decode, bf16 predict, drawing "
            f"and writing); f32 kernels {f32[0]} = twins'; launches {launches}")

        det = yolo_detector(YOLO(str(WEIGHTS)).fuse(), 0.15, imgsz=640)
        det(clip[0])
        t0 = time.perf_counter()
        stats, launches = counted(SERVE_PATH, lambda: run_single_target_tracking(vid, detector=det, csv_path=Path(tmp) / "traj.csv"))
        wall = time.perf_counter() - t0
        with open(Path(tmp) / "traj.csv") as f:
            rows = list(csv.DictReader(f))
        by = {s: sum(r["source"] == s for r in rows) for s in ("yolo", "classical", "none")}
        if len(rows) != stats["frames"] or stats["frames"] <= 0:
            raise AssertionError(f"[single target] {stats}, {len(rows)} CSV rows")
        log("single target", card, f"{stats} in {wall:.2f} s = {stats['frames'] / wall:.1f} frames/s; {len(rows)} CSV rows by source "
            f"{by}; launches {launches}")


def benchmark_phase(model, params, clip, card):
    """`[benchmark]`: best.npz's decoded forward (`DetectionModel.predict`, no NMS) on the clip's first
    frames letterboxed to 640x640 at B = 8 and 32, f32 through the kernels against the twins (boxes
    1e-2 px, scores 1e-4), with kernels 1, 2, 3 and 5 held against their twins on those activations;
    then `YOLO(best.npz).benchmark(imgsz=640)` (bf16) and `half=False` (f32): latency and frames/s at
    B = 1, 8, 32 with the launches of each call (no NMS); then `benchmark_formats` at 640, B = 1."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import install_params
    from yolo_tpu_torch.utils.benchmarks import benchmark_formats

    frames = np.repeat(clip[:32], 3, -1)
    x32 = torch.cat([letterboxed(f) for f in frames])
    install_params(model, params, model.device, torch.float32)
    for B in (8, 32):
        x = x32[:B]
        got, want = model.predict(x), model.predict(x, plain=True)
        torch.cuda.synchronize()
        box, score = float((got[:, :4] - want[:, :4]).abs().max()), float((got[:, 4:] - want[:, 4:]).abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or box > 1e-2 or score > 1e-4:
            raise AssertionError(f"benchmark B={B}: decoded forward kernels vs twins: boxes {box} px, scores {score}, {tuple(got.shape)}")
        log("benchmark f32", card, f"B={B} 640x640 decoded forward {tuple(got.shape)}: kernels against twins max |box| {box:.3e} px, "
            f"|score| {score:.3e}")
        hold_path_kernels([model], x, f"benchmark B={B}", card)
    y = YOLO(str(WEIGHTS))
    path = {"c2f", "c2f_upconcat", "head_level"}
    for half in (True, False):
        rows, launches = counted(path, lambda: y.benchmark(imgsz=640, half=half))
        if [r["batch"] for r in rows] != [1, 8, 32] or not all(r["fps"] > 0 for r in rows):
            raise AssertionError(f"benchmark: rows {rows}")
        log(f"benchmark {'bf16' if half else 'f32'}", card, "; ".join(f"B={r['batch']} {r['latency_ms']} ± {r['std_ms']} ms = "
                                                                      f"{r['fps']} frames/s" for r in rows)
            + f" (2 warm-ups + 10 timed calls a batch, each ended by torch.cuda.synchronize); launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        rows, launches = counted(path, lambda: benchmark_formats(y.model, y.params, imgsz=640, batch=1, workdir=tmp))
    status = [(r["format"], r["status"]) for r in rows]
    if status != [("native-jit", "✅"), ("npz", "✅"), ("orbax", "❌ NotImplementedError"), ("stablehlo", "❌ NotImplementedError")]:
        raise AssertionError(f"benchmark_formats: {rows}")
    log("benchmark formats", card, "; ".join(f"{r['format']} {r['status']} {r['size_MB']} MB {r['latency_ms']} ms {r['fps']} frames/s"
                                            for r in rows) + f" (f32, B=1, 640); launches {launches}")


def pipeline_options_phase(model, params, clip, card, want_outs, want_stats):
    """`[pipeline options]`: `run_clip` of the 256-frame clip in bf16 with collect_outputs=False (no
    outputs kept), and with prefetch 1 and 4 (the pinned ring's depth): the stats must equal `[pipeline]`'s
    bf16 run's, and the outputs too where they are kept; frames/s each."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    for opts in (dict(collect_outputs=False), dict(prefetch=1), dict(prefetch=4)):
        ft = make_pipeline(model, params, torch.bfloat16, plain=False)
        ft.run_clip(clip[:CHUNK], collect_outputs=False)
        ft.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (outs, stats), launches = counted(path, lambda: ft.run_clip(clip, **opts))
        wall = time.perf_counter() - t0
        if stats != want_stats or len(outs) != (0 if opts.get("collect_outputs") is False else len(want_outs)):
            raise AssertionError(f"[pipeline options] {opts}: stats {stats} vs {want_stats}, {len(outs)} outputs")
        same = sum(all(np.array_equal(o[k], w[k]) for k in o) for o, w in zip(outs, want_outs))
        log("pipeline options", card, f"{opts}: {stats} = [pipeline]'s; {len(outs)} chunk outputs"
            + (f", {same} of them equal to [pipeline]'s in every column" if outs else "")
            + f"; {FRAMES} frames in {wall:.3f} s = {FRAMES / wall:.1f} frames/s; launches {launches}")


def int8_pipeline_phase(model, params, clip, card, default_f32, default_fps):
    """`[pipeline int8]`: FusedDetectTrack(int8=True) calibrated on the clip's first chunk, on the 256-frame
    clip: f32 through the kernels against f32 through the twins (tracks, ids, statuses, detection counts and
    stats equal, boxes 1e-2 px), the frames whose detection count differs from `[pipeline]`'s f32 run
    (reported, not gated), then the timed bf16 run with its launches (the NMS kernel only), beside
    `[pipeline]`'s frames/s from this call."""
    import numpy as np
    import torch

    from yolo_tpu_torch import FusedDetectTrack

    tag = "pipeline int8"

    def make(dtype, plain):
        return FusedDetectTrack(model, params, frame_hw=HW, chunk=CHUNK, conf=0.15, iou=0.6, n_max=64, d_max=16, dtype=dtype,
                                plain=plain, int8=True, int8_calib=clip[:CHUNK])

    t0 = time.perf_counter()
    fk = make(torch.float32, plain=False)
    t_make = time.perf_counter() - t0
    if not fk.model.int8:
        raise AssertionError(f"[{tag}] the model holds no int8 conv")
    ok_, sk, wk = timed_run(fk, clip)
    op_, sp, wp = timed_run(make(torch.float32, plain=True), clip)
    worst = compare_runs(ok_, op_, sk, sp)
    d_outs, d_stats = default_f32
    differ = sum(int((a["det_count"] != b["det_count"]).sum()) for a, b in zip(ok_, d_outs))
    log(f"{tag} f32", card, f"kernels {sk} in {wk:.2f} s | plain equal in tracks, ids, statuses, detection counts, stats "
        f"(max |box/conf/vel diff| {worst:.3e}; plain {wp:.2f} s); against [pipeline] f32: stats {sk} vs {d_stats}, detection "
        f"count differs on {differ}/{FRAMES} frames (not gated); calibrated and built in {t_make:.2f} s")
    ft = make(torch.bfloat16, plain=False)
    ft.run_clip(clip[:CHUNK])  # warm-up
    ft.reset()
    ft.timings = []
    (ob, sb, wb), launches = counted({"nms_keep"}, lambda: timed_run(ft, clip))
    split = {}
    for marks in ft.timings:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    same = sum(int((a["det_count"] == b["det_count"]).sum()) for a, b in zip(ob, ok_))
    if not all(np.isfinite(o["bbox"]).all() for o in ob):
        raise AssertionError(f"[{tag}] non-finite boxes in the bf16 run")
    log(f"{tag} bf16", card, f"{sb}; {FRAMES} frames in {wb:.3f} s = {FRAMES / wb:.1f} frames/s end to end against [pipeline]'s "
        f"{default_fps:.1f} in this call; device split per {FRAMES} frames: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; det_count equal to its f32 run on {same}/{FRAMES} frames; launches {launches}")


def predict_settings_phase(clip, card):
    """`[predict int8]`: YOLO(best.npz).predict(int8=True) on 16 BGR frames of the clip (dynamic
    activation scales, the int8 convs; the NMS kernel the only kernel), f32 kernel against its twin
    (equal detections, boxes 1e-2 px), then bf16 timed. `[predict visualize]`: one frame with
    visualize=True, the files written (a .npy per layer before the head, and a .png where matplotlib
    imports). `[predict show]`: show=True with no display named: one warning, `show` off, the Results
    of show=False."""
    import io
    import logging
    import os
    import tempfile

    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.utils import LOGGER

    frames = list(np.repeat(clip[:16], 3, -1))
    kw = dict(conf=0.15, iou=0.6, imgsz=640, verbose=False, batch=16)

    def dets(results):
        return [r.boxes.data for r in results]

    y = YOLO(str(WEIGHTS))
    (rk, launches) = counted({"nms_keep"}, lambda: y.predict(frames, int8=True, compute_dtype="float32", **kw))
    rp = YOLO(str(WEIGHTS)).predict(frames, int8=True, compute_dtype="float32", plain=True, **kw)
    worst = 0.0
    for a, b in zip(dets(rk), dets(rp)):
        if a.shape != b.shape:
            raise AssertionError(f"[predict int8] detections differ: kernel {a.shape} vs plain {b.shape}")
        if len(a):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()))
    if worst > 1e-2 or not y.model.int8 or sum(len(d) for d in dets(rk)) == 0:
        raise AssertionError(f"[predict int8] max |diff| {worst}, int8 {y.model.int8}, {sum(len(d) for d in dets(rk))} detections")
    f32 = YOLO(str(WEIGHTS)).predict(frames, compute_dtype="float32", **kw)
    y.predict(frames, int8=True, **kw)  # warm-up in bf16
    t0 = time.perf_counter()
    rb = y.predict(frames, int8=True, **kw)
    wb = time.perf_counter() - t0
    log("predict int8", card, f"f32 kernel = plain ({sum(len(d) for d in dets(rk))} detections, max |diff| {worst:.3e}); against the float "
        f"model: counts {[len(r) for r in rk]} vs {[len(r) for r in f32]}; bf16 {len(frames) / wb:.1f} frames/s ({len(frames)} frames, one "
        f"predict), {sum(len(r) for r in rb)} detections; launches in the f32 kernel run {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        YOLO(str(WEIGHTS)).predict(frames[0], visualize=True, project=tmp, name="vis", **{**kw, "batch": 1})
        files = sorted(p.name for p in (Path(tmp) / "vis").iterdir())
    n_npy = sum(f.endswith(".npy") for f in files)
    if n_npy != 25:  # every layer of best.npz's 26 but the head
        raise AssertionError(f"[predict visualize] {n_npy} feature arrays: {files}")
    log("predict visualize", card, f"{len(files)} files: {n_npy} .npy and {len(files) - n_npy} .png (matplotlib {'present' if len(files) > n_npy else 'absent'})")

    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    h = Catch(level=logging.WARNING)
    LOGGER.addHandler(h)
    try:
        with environ(DISPLAY="", WAYLAND_DISPLAY=""):
            ys = YOLO(str(WEIGHTS))
            with contextlib.redirect_stdout(io.StringIO()):
                shown = ys.predict(frames[:4], show=True, **{**kw, "batch": 4})
                ys.predict(frames[:4], show=True, **{**kw, "batch": 4})
    finally:
        LOGGER.removeHandler(h)
    plain_run = YOLO(str(WEIGHTS)).predict(frames[:4], **{**kw, "batch": 4})
    if len(seen) != 1 or ys.predictor.args.show or [r.boxes.data.tolist() for r in shown] != [r.boxes.data.tolist() for r in plain_run]:
        raise AssertionError(f"[predict show] warnings {seen}, show {ys.predictor.args.show}")
    log("predict show", card, f"headless (DISPLAY and WAYLAND_DISPLAY empty, was {os.environ.get('DISPLAY')!r}): one warning "
        f"({seen[0]!r}), show turned off, the Results of show=False")


# `train(batch=-1)` at 640: one epoch, no validation; the split holds 256 images, so a pick up to 256
# trains in full batches (the loader resizes the small frames to 640)
AUTOBATCH_RUN = dict(batch=-1, epochs=1, imgsz=640, amp=True, val=False, plots=False, workers=8, close_mosaic=0, exist_ok=True)
AUTOBATCH_IMAGES = 256


def autobatch_split(root: Path) -> Path:
    """256 seeded 160x128 IR frames with their labels under root/images/train and 4 under images/val → the yaml."""
    write_split(root, AUTOBATCH_IMAGES, 5, w=160, h=128, split="train")
    return write_split(root, 4, 6, w=160, h=128)


def _peak_after_search():
    """A DetectionTrainer that empties the cache and restarts the peak count once autobatch has picked (its
    failed probe peaks near the card's memory), so the run's peak is the training's own."""
    import torch

    from yolo_tpu_torch.engine.trainer import DetectionTrainer

    class PeakAfterSearch(DetectionTrainer):
        def _autobatch(self, trainset):
            b = super()._autobatch(trainset)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return b

    return PeakAfterSearch


def train_settings_phase(data, run_dir, card):
    """`[train settings]`: one epoch (4 steps of 16, no validation) of the recipe from yolov8-small.yaml with
    each of the trainer's last settings: the default, remat (peak memory beside the default's), and
    multi_scale with cache='ram', mosaic 1.0 with mosaic_n = 9 and cutmix 0.5: finite losses, device ms a
    step, peak memory. Then `train(batch=-1)` at 640 on a 256-image split: autobatch's pick (the trainer's
    own step as its probe, at least 16 and at most the split) and one epoch of full batches at it."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.data import augment as PA

    base_kw = {**TRAIN_RECIPE, "epochs": 1, "close_mosaic": 0, "val": False, "plots": False}
    runs = {"default": {}, "remat": dict(remat=True),
            "multi_scale + RAM cache + mosaic9 + cutmix": dict(multi_scale=True, cache="ram", mosaic=1.0, cutmix=0.5),
            "batch=-1": None}
    peaks = {}
    for name, kw in runs.items():
        y = YOLO("yolov8-small.yaml")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        PA.TrainTransforms.mosaic_n = 9 if "mosaic9" in name else 4
        try:
            t0 = time.perf_counter()
            if kw is None:
                y.train(data=str(autobatch_split(run_dir / "autobatch_split")), trainer=_peak_after_search(), project=str(run_dir),
                        name="settings_auto", **AUTOBATCH_RUN)
            else:
                y.train(data=str(data), project=str(run_dir), name=f"settings_{len(peaks)}", exist_ok=True, **{**base_kw, **kw})
            wall = time.perf_counter() - t0
        finally:
            PA.TrainTransforms.mosaic_n = 4
        t = y.trainer
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        row = t._last_row
        losses = [row[f"train/{k}_loss"] for k in ("box", "cls", "dfl")]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[train settings] {name}: losses {losses}")
        if kw is None and not (16 <= t.args.batch <= AUTOBATCH_IMAGES and len(t.timings) == len(t.train_loader) >= 1):
            raise AssertionError(f"[train settings] batch=-1 picked {t.args.batch}, {len(t.timings)} steps")
        steps = t.timings[1:]
        step_ms = sum(s["forward"] + s["backward"] + s["optimizer"] for s in steps) / max(len(steps), 1)
        log("train settings", card, f"{name}: {len(t.timings)} steps of {t.args.batch}, losses box/cls/dfl "
            + "/".join(f"{v:.4f}" for v in losses) + f"; epoch {t.epoch_time:.2f} s, the .train call {wall:.1f} s; device per step after "
            f"the first {step_ms:.1f} ms (events); peak memory {peaks[name]:.2f} GiB")
    log("train settings", card, f"remat peak memory {peaks['remat']:.2f} GiB against the default's {peaks['default']:.2f} GiB "
        f"({peaks['remat'] / peaks['default']:.2f}x); batch=-1 at 640 trained at its pick, peak {peaks['batch=-1']:.2f} GiB after the "
        f"search (the probes' peaks in the autobatch lines above) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")


TUNE_SET = (32, 30_000)  # `[tune]`: frames and seed of its split (the same frames as train and val)
TUNE_RUN = dict(iterations=2, epochs=1, imgsz=640, batch=16, workers=8, plots=False)


def tune_phase(root: Path, card):
    """`[tune]`: YOLO("yolov8-small.yaml").tune(TUNE_RUN) on a seeded 32-frame 640x512 split (write_split,
    its frames both the train and the val split): each iteration a fresh model trained one epoch in bf16
    and validated (kernels 1, 2, 3 and 5 on the card); the fitness of both iterations, the CSV's columns,
    the seconds of the whole call and of each training's loop, best_hyperparameters.yaml and best.npz written."""
    import csv

    import numpy as np

    from yolo_tpu_torch import YOLO

    write_split(root, *TUNE_SET, split="train")
    data = write_split(root, *TUNE_SET, split="val")
    t0 = time.perf_counter()
    best, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: YOLO("yolov8-small.yaml").tune(
        data=str(data), project=str(root / "runs"), **TUNE_RUN))
    wall = time.perf_counter() - t0
    tune_dir = root / "runs" / "tune"

    def csv_rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    rows = csv_rows(tune_dir / "tune_results.csv")
    spent = [float(csv_rows(tune_dir / f"iter{r['iteration']}" / "results.csv")[-1]["time"]) for r in rows]
    if len(rows) != TUNE_RUN["iterations"] or not all(np.isfinite(float(r["fitness"])) for r in rows) \
            or not (tune_dir / "best_hyperparameters.yaml").exists() or not (tune_dir / "best.npz").exists():
        raise AssertionError(f"tune: rows {rows}, files {sorted(p.name for p in tune_dir.iterdir())}")
    log("tune", card, f"{len(rows)} iterations in {wall:.1f} s (each training's loop {', '.join(f'{t:.1f}' for t in spent)} s, "
        f"results.csv): fitness "
        + ", ".join(f"iter {r['iteration']} {float(r['fitness']):.4f}" for r in rows) + f"; best iteration {best['best_iteration']}; "
        f"CSV columns {list(rows[0])}; launches {launches}")


def coco_annotations(data) -> Path:
    """annotations/instances_val2017.json beside a write_split dataset, from its val labels: image ids
    the numeric file stems, boxes (ltwh) in the 640x512 frames' pixels, category 0 → the file."""
    root = Path(data).parent
    images, anns = [], []
    for f in sorted((root / "labels" / "val").glob("*.txt"), key=lambda f: int(f.stem)):
        images.append({"id": int(f.stem), "width": HW[1], "height": HW[0]})
        for line in f.read_text().splitlines():
            c, x, y, w, h = (float(v) for v in line.split())
            box = [(x - w / 2) * HW[1], (y - h / 2) * HW[0], w * HW[1], h * HW[0]]
            anns.append({"id": len(anns), "image_id": int(f.stem), "category_id": int(c), "iscrowd": 0, "bbox": box,
                         "area": box[2] * box[3]})
    out = root / "annotations" / "instances_val2017.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"images": images, "annotations": anns, "categories": [{"id": 0, "name": "aircraft"}]}))
    return out


def val_coco_phase(data, run_dir: Path, card):
    """`[val coco]`: `[val]`'s 256-frame split with annotations/instances_val2017.json written from its labels,
    YOLO(best.npz).val(save_json=True) at imgsz 640, batch 32, f32 (the kernels): predictions.json holds as
    many rows as the validator kept detections; the coco/* keys beside the validator's mAP50 / mAP50-95, each
    equal to the port's coco_evaluate rerun on the written files; the seconds of each. The annotations file
    is removed afterwards."""
    from yolo_tpu_torch.utils.coco_eval import coco_evaluate

    anno = coco_annotations(data)
    try:
        t0 = time.perf_counter()
        (res, v), launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: val_run(
            data, batch=32, save_json=True, project=str(run_dir), exist_ok=True))
        wall = time.perf_counter() - t0
        written = run_dir / "val" / "predictions.json"
        rows = json.loads(written.read_text())
        kept = sum(int((o[..., 6] > 0).sum()) for o in v.outs)
        t1 = time.perf_counter()
        again = coco_evaluate(str(anno), str(written))
        t_coco = time.perf_counter() - t1
    finally:
        anno.unlink()
    coco = {k: res[k] for k in res if k.startswith("coco/")}
    if len(rows) != kept or not coco or coco != {f"coco/{k}": x for k, x in again.items()}:
        raise AssertionError(f"val coco: {len(rows)} json rows for {kept} kept detections; coco keys {coco} vs rerun {again}")
    log("val coco", card, f"{len(rows)} json rows = the validator's kept detections; validator mAP50 {res['mAP50']:.4f} mAP50-95 "
        f"{res['mAP50-95']:.4f}; COCOeval " + " ".join(f"{k[5:]} {x:.4f}" for k, x in coco.items()) + f" (equal to the rerun on the "
        f"written files, {t_coco:.1f} s); the .val call {wall:.1f} s; launches {launches}")


CLS_SHAPES = ("bright_circle", "bright_triangle", "dark_bar", "dark_square")
CLS_TRAIN, CLS_VAL = (512, 0), (128, 1)  # `[classify]`'s folder dataset: images and seed of each split
# 3 epochs of the 512 images at batch 8, lr0 1e-3 (the cfg's 0.01 otherwise), bf16, RandAugment and erasing off as
# tests/test_classify.py trains its toy set. At batch 32 the 48 steps leave the BN running moments (momentum 0.03)
# 23% at their initial values, and validation (eval mode) read top1 0.25-0.75 in CPU rehearsals at lr0 1e-3 and 0.01
CLS_RUN = dict(epochs=3, imgsz=224, batch=8, lr0=1e-3, amp=True, auto_augment="", erasing=0.0, plots=False, exist_ok=True)


def write_cls_split(root: Path, n: int, seed: int, imgsz: int = 224, split: str = "train") -> Path:
    """n seeded imgsz x imgsz images under root/<split>/<class>/, the classes in turn, drawn like
    tests/test_classify.py's toy set (a noisy grey field, one filled shape) with four separable
    shapes at a random place and size: a bright circle or triangle, a dark bar or square → root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    s = imgsz / 64
    for k in range(n):
        cname = CLS_SHAPES[k % len(CLS_SHAPES)]
        d = root / split / cname
        d.mkdir(parents=True, exist_ok=True)
        img = rng.normal(120, 10, (imgsz, imgsz, 3)).clip(0, 255).astype(np.uint8)
        (x, y), r = (int(v) for v in rng.uniform(24, 40, 2) * s), int(rng.uniform(12, 18) * s)
        if cname == "dark_square":
            cv2.rectangle(img, (x - r, y - r), (x + r, y + r), (10, 10, 10), -1)
        elif cname == "dark_bar":
            cv2.rectangle(img, (x - r, y - r // 4), (x + r, y + r // 4), (10, 10, 10), -1)
        elif cname == "bright_circle":
            cv2.circle(img, (x, y), r, (250, 250, 250), -1)
        else:
            cv2.fillPoly(img, [np.array([[x, y - r], [x - r, y + r], [x + r, y + r]], np.int32)], (250, 250, 250))
        write_png(d / f"{k}.png", img)
    flush_pngs()
    return root


def classify_c2f_holds(y, frames, card):
    """The C2f kernel against its twin at yolov8n-cls's four instances (c = 16, 32, 64, 128 on 56², 28², 14²
    and 7² maps at 224), captured from the model's own forward of the frames resized to 224, in f32 and bf16,
    at B = 1 and 32, with each instance's plan."""
    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch.nn.tasks import install_params
    from yolo_tpu_torch.ops import cuda_c2f

    x224 = np.stack([cv2.resize(f, (224, 224), interpolation=cv2.INTER_LINEAR) for f in frames[:32]])
    plain = cuda_c2f.c2f_plain
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        install_params(y.model, y.params, y.device, dtype)
        for B in (1, 32):
            rec = []
            cuda_c2f.c2f_plain = lambda x, kw, shortcut: (rec.append((x, kw, shortcut)), plain(x, kw, shortcut))[1]
            try:
                y.model.predict(torch.from_numpy(x224[:B]).to(y.device).flip(-1).to(dtype) / 255.0, plain=True)
            finally:
                cuda_c2f.c2f_plain = plain
            if len(rec) != 4:
                raise AssertionError(f"classify: {len(rec)} C2f instances captured, expected 4")
            for x, kw, shortcut in rec:
                got, want = cuda_c2f.fused_c2f(x, kw, shortcut), plain(x, kw, shortcut)
                torch.cuda.synchronize()
                _, H, W, c1 = x.shape
                desc = f"B={B} {H}x{W} {c1}->{kw.w2.shape[1]} c={kw.c} n={kw.n}{' shortcut' if shortcut else ''}"
                errs = hold("c2f", f"classify {desc}", dn, got, want)
                log(f"classify c2f {dn}", card, f"{desc:36s} max_abs_err={max(errs.values()):.3e} "
                    f"{c2f_plan_text(B, H, W, c1, 0, kw, dtype)}")


def classify_phase(clip, root: Path, card):
    """`[classify]`: yolov8n-cls at full width (scale n, nc 1000, the JAX package's initial tree), imgsz 224.
    32 frames of the clip as BGR through `predict`, one per call (a square resize, softmax probabilities,
    no NMS): f32 through the C2f kernel against the twin (probabilities 1e-4, top-1 equal), then bf16,
    frames/s; the C2f kernel held against its twin at the model's four instances (`classify_c2f_holds`).
    Then a seeded 4-class folder dataset (write_cls_split: 512 train and 128 val images at 224) trained
    with CLS_RUN (bf16, batch 8, lr0 1e-3; RandAugment and erasing off, as tests/test_classify.py trains
    its toy set): per-epoch loss, top1 / top5 of each epoch's f32 validation, images/s over the whole train call,
    peak memory; top1 >= 0.9 required. `val` of the trained model on the val split, f32 through the
    kernel against the twin (equal metrics). Kernel 1's launches in each run (the only kernel there)."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    frames = np.repeat(clip[:PREDICT_FRAMES], 3, -1)
    y = YOLO("yolov8n-cls.yaml")
    if (y.task, y.model.nc, y.model.stride) != ("classify", 1000, [1]):
        raise AssertionError(f"classify: task {y.task}, nc {y.model.nc}, stride {y.model.stride}")

    def probs(half, plain):
        return lambda f: y.predict(f, imgsz=224, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False)[0].probs.data

    probs(False, False)(frames[0])  # warm-up
    (pk, wk), launches_f32 = counted({"c2f"}, lambda: timed_frames(probs(False, False), frames))
    pp, wp = timed_frames(probs(False, True), frames)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(pk, pp))
    top1 = sum(int(a.argmax() == b.argmax()) for a, b in zip(pk, pp))
    if diff > 1e-4 or top1 != PREDICT_FRAMES or pk[0].shape != (1000,) or not all(np.isfinite(a).all() for a in pk):
        raise AssertionError(f"classify predict f32: kernels vs twins differ by {diff}, top-1 equal on {top1}/{PREDICT_FRAMES}")
    log("classify predict f32", card, f"{PREDICT_FRAMES} frames, one per call: kernels {PREDICT_FRAMES / wk:.1f} frames/s, twins "
        f"{PREDICT_FRAMES / wp:.1f}; probabilities max |diff| {diff:.3e} (gate 1e-4), top-1 equal on every frame; launches {launches_f32}")
    probs(True, False)(frames[0])
    (pb, wb), launches = counted({"c2f"}, lambda: timed_frames(probs(True, False), frames))
    same = sum(int(a.argmax() == b.argmax()) for a, b in zip(pb, pk))
    log("classify predict bf16", card, f"{PREDICT_FRAMES} frames in {wb:.3f} s = {PREDICT_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per predict call); top-1 equal to f32 on {same}/{PREDICT_FRAMES}; launches {launches}")
    classify_c2f_holds(y, frames, card)

    cls_split(root)
    yt = YOLO("yolov8n-cls.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted({"c2f"}, lambda: yt.train(data=str(root), project=str(root / "runs"), name="train", **CLS_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    losses = yt.trainer.losses
    if not all(np.isfinite(losses)) or metrics["top1"] < 0.9 or yt.model.nc != len(CLS_SHAPES):
        raise AssertionError(f"classify train: losses {losses}, metrics {metrics}, nc {yt.model.nc}")
    n = CLS_RUN["epochs"] * CLS_TRAIN[0]
    log("classify train", card, f"{CLS_RUN['epochs']} epochs of {CLS_TRAIN[0]} images at batch {CLS_RUN['batch']}, bf16: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; best top1 {metrics['top1']:.4f} top5 {metrics['top5']:.4f}; {n / wall:.1f} "
        f"images/s over the whole .train call ({wall:.1f} s: loading and augmenting on the host, the steps, each epoch's f32 "
        f"validation of {CLS_VAL[0]} images); peak memory {peak:.2f} GiB (max_memory_allocated, over the {base / 2**30:.2f} GiB "
        f"held before); launches {launches}")
    vk, launches = counted({"c2f"}, lambda: yt.val(data=str(root), imgsz=224, batch=32))
    vp = yt.val(data=str(root), imgsz=224, batch=32, plain=True)
    if {k: float(x) for k, x in vk.items()} != {k: float(x) for k, x in vp.items()} or vk["top1"] < 0.9:
        raise AssertionError(f"classify val: kernels {vk} vs twins {vp}")
    log("classify val", card, f"{CLS_VAL[0]} images, f32: top1 {vk['top1']:.4f} top5 {vk['top5']:.4f} fitness {vk['fitness']:.4f}, "
        f"equal through the twin; launches {launches}")


# ------------------------------------------------------------------------ the segment task --

SEG_TRAIN, SEG_VAL = (256, 40_000), (64, 40_001)  # `[segment ...]`'s polygon splits: frames and seed
SEG_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
# yolov8n-seg from the JAX package's init(0), rebuilt at nc 1: the IR recipe's optimizer, lr0 and batch at 640 in bf16,
# 3 epochs (close_mosaic 1), the cfg's augmentations otherwise
SEG_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
               plots=False, exist_ok=True)
# `[segment predict]`: each frame's ten best detections (a 3-epoch model's scores sit near 0.01, its box mAP50 near 0.07)
SEG_PREDICT = dict(conf=0.001, max_det=10)


def write_seg_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>,
    each with 1-4 bright filled ellipses (radii 12-60 px; about a third placed over the one before, so
    instances overlap), their 30-point polygons as YOLO segment labels under root/labels/<split>, nc 1 →
    the dataset yaml, which names every split written under root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines, prev = [], None
        for _ in range(rng.integers(1, 5)):
            ax, ay = (int(v) for v in rng.uniform(12, 60, 2))
            if prev is not None and rng.uniform() < 0.35:
                cx, cy = (int(v) for v in np.clip(prev + rng.uniform(-40, 40, 2), [ax, ay], [w - ax, h - ay]))
            else:
                cx, cy = int(rng.uniform(ax, w - ax)), int(rng.uniform(ay, h - ay))
            pts = cv2.ellipse2Poly((cx, cy), (ax, ay), int(rng.uniform(0, 180)), 0, 360, 12)[:-1]
            cv2.fillPoly(img, [pts], float(rng.uniform(140, 220)))
            lines.append("0 " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts))
            prev = np.array([cx, cy], np.float64)
        gray = np.clip(img, 0, 255).astype(np.uint8)
        write_png(root / f"images/{split}/{i}.png", cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    flush_pngs()
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: target\n")
    return root / "data.yaml"


def segment_train_phase(data, run_dir, card):
    """`[segment train]`: YOLO("yolov8n-seg.yaml").train with SEG_RUN on the 256-frame polygon split, validating
    on the 64 held-out frames each epoch: per epoch the four loss components and the box and mask metrics; images/s
    over the whole .train call; peak memory; the launches of check_amp and the validations → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-seg.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(SEG_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                          project=str(run_dir), name="segment", **SEG_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "segment" or y.model.nc != 1 or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"segment train: task {y.task}, nc {y.model.nc}, amp {y.trainer.args.amp}, metrics {metrics}")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in ("box", "seg", "cls", "dfl")]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"segment train: epoch {r['epoch']} losses {losses}")
        log("segment train", card, f"epoch {r['epoch'] + 1}/{SEG_RUN['epochs']}: box {losses[0]:.4f} seg {losses[1]:.4f} cls "
            f"{losses[2]:.4f} dfl {losses[3]:.4f}; box mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}, mask mAP50 "
            f"{r['metrics/mask_mAP50']:.4f} mAP50-95 {r['metrics/mask_mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = SEG_RUN["epochs"] * SEG_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("segment train", card, f"{SEG_RUN['epochs']} epochs of {SEG_TRAIN[0]} frames at batch {SEG_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {SEG_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events); peak memory {peak:.2f} GiB (max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def segment_val_kernels_phase(y, data, card):
    """`[segment val kernels]`: the trained model on the held-out split, f32 through the kernels against f32
    through the twins (every box and mask key within 1e-4), then bf16 images/s over a warmed .val call."""
    path = SEG_PATH
    rk, launches = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4 or "mask_mAP50-95" not in rk:
        raise AssertionError(f"segment val: kernels {rk} vs twins {rp}")
    log("segment val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("segment val bf16", card, f"{SEG_VAL[0]} frames in {wall:.2f} s = {SEG_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); box mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50-95']:.4f}), mask mAP50-95 {rb['mask_mAP50-95']:.4f} "
        f"(f32 {rk['mask_mAP50-95']:.4f}); launches {launches}")


def _mask_iou(a, b) -> float:
    inter, union = (a & b).sum(), (a | b).sum()
    return 1.0 if union == 0 else float(inter / union)


def segment_predict_phase(y, frames, card):
    """`[segment predict]`: the trained model over held-out BGR frames, one per predict call, at SEG_PREDICT's
    conf and max_det, f32 through the kernels against f32 through the twins: equal detection counts, boxes within
    1e-2 px, conf within 1e-4, every mask's IoU with the twin's at least 0.99; with retina_masks off and on. Then
    bf16 frames/s (host clock) with the host split: the predict call and, inside it, the masks' upsampling."""
    import numpy as np

    def run(half, plain, retina):
        out = []
        for f in frames:
            r = y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), retina_masks=retina, verbose=False,
                          **SEG_PREDICT)[0]
            out.append((r.boxes.data.copy(), r.masks.data.copy()))
        return out

    for retina in (False, True):
        run(False, False, retina)  # warm-up
        pk, launches = counted(SEG_PATH, lambda: run(False, False, retina))
        pp = run(False, True, retina)
        n_det, worst_box, worst_conf, worst_iou = 0, 0.0, 0.0, 1.0
        for (bk, mk), (bp, mp) in zip(pk, pp):
            if bk.shape != bp.shape or mk.shape != mp.shape:
                raise AssertionError(f"segment predict retina={retina}: {bk.shape} / {mk.shape} vs twins {bp.shape} / {mp.shape}")
            if len(bk):
                worst_box = max(worst_box, float(np.abs(bk[:, :4] - bp[:, :4]).max()))
                worst_conf = max(worst_conf, float(np.abs(bk[:, 4] - bp[:, 4]).max()))
                worst_iou = min(worst_iou, *(_mask_iou(a, b) for a, b in zip(mk, mp)))
            n_det += len(bk)
        if n_det == 0 or worst_box > 1e-2 or worst_conf > 1e-4 or worst_iou < 0.99:
            raise AssertionError(f"segment predict retina={retina}: {n_det} detections, |box| {worst_box}, |conf| {worst_conf}, "
                                 f"mask IoU {worst_iou}")
        confs = np.concatenate([b[:, 4] for b, _ in pk])
        areas = np.concatenate([m.sum((1, 2)) for _, m in pk])
        log("segment predict f32", card, f"retina_masks={retina}: {len(frames)} frames, {n_det} detections equal to the twins' "
            f"(max |box| {worst_box:.3e} px, |conf| {worst_conf:.3e}, least mask IoU {worst_iou:.6f}), masks {pk[0][1].shape[1:]} "
            f"a frame; conf {confs.min():.4f}-{confs.max():.4f}, mask areas {int(areas.min())}-{int(areas.max())} px; "
            f"launches {launches}")
    y.predictor.timings = []
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **SEG_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(SEG_PATH, lambda: run(True, False, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    call = sum(t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"] for t in ts) / len(ts) * 1e3
    up = sum(t.get("masks_s", 0.0) for t in ts) / len(ts) * 1e3
    log("segment predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + upload + forward + NMS + masks + copy-back + Results {call:.3f}, of "
        f"which the masks' upsampling (cv2, valid masks only) {up:.3f}; launches {launches}")


def segment_forward_phase(frames, card):
    """`[segment forward]`: yolov8n-seg at full width (nc 80, the JAX package's init(0)) at 640x640, B = 8 and 32, f32
    through the kernels against the twins: boxes within 1e-2 px, scores 1e-4, mask coefficients and prototypes 1e-3;
    kernels 1, 2, 3 and 5 held against their twins on those activations (`hold_path_kernels`); NMS with the
    coefficients as extra columns, kernel against twin: equal kept slots, extras equal for the same slots. NMS runs
    at conf 0, since the initial tree's scores sit near 1e-3: every anchor is a candidate, K = 1024."""
    import torch

    from yolo_tpu_torch.nn.tasks import SegmentationModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m = SegmentationModel("yolov8n-seg.yaml")
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])

    def forward_nms(x, plain):
        preds, protos = m.predict(x, plain=plain)
        return preds, protos, non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, max_det=300, nc=m.nc, plain=plain)

    for B in (8, 32):
        x = x32[:B]
        (pk, prk, ok), launches = counted(SEG_PATH, lambda: forward_nms(x, False))
        pp, prp, op = forward_nms(x, True)
        torch.cuda.synchronize()
        err = {"box": float((pk[:, :4] - pp[:, :4]).abs().max()), "score": float((pk[:, 4:84] - pp[:, 4:84]).abs().max()),
               "coef": float((pk[:, 84:] - pp[:, 84:]).abs().max()), "proto": float((prk - prp).abs().max())}
        same = bool(torch.equal(ok["valid"], op["valid"]))
        ex = float((ok["extra"] - op["extra"]).abs().max())
        if (pk.shape != (B, 116, 8400) or prk.shape != (B, 160, 160, 32) or not torch.isfinite(pk).all() or err["box"] > 1e-2
                or err["score"] > 1e-4 or err["coef"] > 1e-3 or err["proto"] > 1e-3 or not same or ex > 1e-3):
            raise AssertionError(f"segment forward B={B}: {err}, NMS valid equal {same}, extras {ex}, {tuple(pk.shape)}, {tuple(prk.shape)}")
        log("segment forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}, protos {tuple(prk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; NMS {int(ok['valid'].sum())} kept slots equal, extras "
            f"within {ex:.3e}; launches {launches}")
        hold_path_kernels([m], x, f"segment forward B={B}", card, conf=0.0, iou=0.7)


def segment_phases(root: Path, card):
    """The segment task's four phases on the polygon splits written under `root` → (the trained YOLO, the val
    frames), which `[pose track]` tracks with."""
    import cv2
    import numpy as np

    data = seg_split(root)
    y = segment_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-seg.yaml", tag="segment train step f32", recipe=SEG_RUN)
    segment_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(SEG_VAL[0])]
    segment_predict_phase(y, frames, card)
    segment_forward_phase(np.stack(frames), card)
    return y, frames


POSE_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
POSE_TRAIN, POSE_VAL = (256, 50_000), (64, 50_001)  # `[pose ...]`'s keypoint splits: frames and seed
# yolov8n-pose from the JAX package's init(0) (nc 1, COCO's 17 keypoints): the IR recipe's optimizer, lr0 and batch
# at 640 in bf16, 3 epochs (close_mosaic 1), the cfg's augmentations otherwise
POSE_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
                plots=False, exist_ok=True)
# `[pose predict]`, `[pose track]`: each frame's ten best detections (a 3-epoch model's scores are low, as
# `[segment predict]`'s; conf 0 keeps ten a frame however low)
POSE_PREDICT = dict(conf=0.0, max_det=10)
# COCO's 17 keypoints in coco8-pose.yaml's order (nose, eyes, ears, shoulders, elbows, wrists, hips, knees, ankles;
# left before right) on a figure one unit tall, x to the figure's left, y down from its hips; and coco8-pose's flip_idx
POSE_TEMPLATE = ((0.0, -0.44), (0.025, -0.46), (-0.025, -0.46), (0.05, -0.45), (-0.05, -0.45), (0.11, -0.32), (-0.11, -0.32),
                 (0.16, -0.15), (-0.16, -0.15), (0.18, 0.0), (-0.18, 0.0), (0.07, 0.0), (-0.07, 0.0), (0.08, 0.25),
                 (-0.08, 0.25), (0.09, 0.5), (-0.09, 0.5))
POSE_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
POSE_LIMBS = ((16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13), (6, 7), (6, 8), (7, 9), (8, 10), (9, 11),
              (1, 6), (1, 7))  # 1-based pairs: COCO's skeleton below the face, the nose to each shoulder


def write_pose_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>, each with
    1-3 bright stick figures 90-240 px tall (limbs drawn between COCO's 17 keypoints, jittered, a head disc at the
    nose), their pose rows (`0 cx cy w h` then 17 × `x y v`, normalized; the box the keypoints' extent padded by 5% of
    the height) under root/labels/<split>: about 75% of the keypoints at visibility 2, 15% at 1 and 10% at 0 (x = y =
    0, COCO's unlabelled form), nc 1 → the dataset yaml, with kpt_shape [17, 3] and coco8-pose's flip_idx."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    tpl = np.array(POSE_TEMPLATE, np.float64)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines = []
        for _ in range(rng.integers(1, 4)):
            H = rng.uniform(90, 240)
            cx, cy = rng.uniform(0.25 * H, w - 0.25 * H), rng.uniform(0.55 * H, h - 0.55 * H)
            pts = (tpl + rng.normal(0, 0.02, tpl.shape)) * H * [rng.choice([-1, 1]) * rng.uniform(0.8, 1.1), 1.0] + [cx, cy]
            val = float(rng.uniform(140, 220))
            th = max(2, int(H / 30))
            for a, b in POSE_LIMBS:
                cv2.line(img, tuple(int(v) for v in pts[a - 1]), tuple(int(v) for v in pts[b - 1]), val, th, cv2.LINE_AA)
            cv2.circle(img, tuple(int(v) for v in pts[0]), int(H * 0.06), val, -1, cv2.LINE_AA)
            x1, y1 = np.clip(pts.min(0) - 0.05 * H, 0, [w, h])
            x2, y2 = np.clip(pts.max(0) + 0.05 * H, 0, [w, h])
            vis = rng.choice([2, 1, 0], 17, p=[0.75, 0.15, 0.10])
            kp = np.where(vis[:, None] > 0, pts / [w, h], 0.0)
            lines.append(f"0 {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f} "
                         + " ".join(f"{x:.6f} {y:.6f} {v}" for (x, y), v in zip(kp, vis)))
        gray = np.clip(img, 0, 255).astype(np.uint8)
        write_png(root / f"images/{split}/{i}.png", cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    flush_pngs()
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}kpt_shape: [17, 3]\nflip_idx: {POSE_FLIP_IDX}\n"
                                    "names:\n  0: person\n")
    return root / "data.yaml"


def pose_train_phase(data, run_dir, card):
    """`[pose train]`: YOLO("yolov8n-pose.yaml").train with POSE_RUN on the 256-frame keypoint split, validating on
    the 64 held-out frames each epoch: per epoch the five loss components and the box and pose metrics; images/s over
    the whole .train call; the step's split in events; peak memory; the launches of check_amp and the validations
    → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-pose.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(POSE_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                           project=str(run_dir), name="pose", **POSE_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "pose" or y.model.head.kpt_shape != (17, 3) or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"pose train: task {y.task}, kpt_shape {y.model.head.kpt_shape}, amp {y.trainer.args.amp}, metrics {metrics}")
    names = ("box", "pose", "kobj", "cls", "dfl")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in names]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"pose train: epoch {r['epoch']} losses {losses}")
        log("pose train", card, f"epoch {r['epoch'] + 1}/{POSE_RUN['epochs']}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, losses))
            + f"; box mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}, pose mAP50 {r['metrics/pose_mAP50']:.4f} "
            f"mAP50-95 {r['metrics/pose_mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = POSE_RUN["epochs"] * POSE_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("pose train", card, f"{POSE_RUN['epochs']} epochs of {POSE_TRAIN[0]} frames at batch {POSE_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {POSE_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events; {sum(mean[k] for k in ('forward', 'backward', 'optimizer')):.2f} ms a step); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def pose_val_kernels_phase(y, data, card):
    """`[pose val kernels]`: the trained model on the held-out split, f32 through the kernels against f32 through the
    twins (every box and `pose_` key within 1e-4), then bf16 images/s over a warmed .val call."""
    rk, launches = counted(POSE_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4 or "pose_mAP50-95" not in rk:
        raise AssertionError(f"pose val: kernels {rk} vs twins {rp}")
    log("pose val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(POSE_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("pose val bf16", card, f"{POSE_VAL[0]} frames in {wall:.2f} s = {POSE_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); box mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50-95']:.4f}), pose mAP50-95 {rb['pose_mAP50-95']:.4f} "
        f"(f32 {rk['pose_mAP50-95']:.4f}); launches {launches}")


def _kpt_diffs(a, b):
    """Largest |x, y| and |visibility| differences of two (n, 17, 3) keypoint sets."""
    import numpy as np

    if not len(a):
        return 0.0, 0.0
    return float(np.abs(a[..., :2] - b[..., :2]).max()), float(np.abs(a[..., 2] - b[..., 2]).max())


def _paired(bk, bp, box_tol=1e-2, tie=1e-6):
    """Pair each kernel row with the twin's row of the nearest box, each used once: two detections whose scores
    differ by less than f32's rounding may leave NMS in either order. The rows without a twin within `box_tol` px
    must match the twin's unpaired rows score for score within `tie`: of two overlapping candidates of one score
    (an undertrained model predicts the same box at neighbouring anchors), NMS keeps whichever its sort put first,
    and the kernel and the twin may put them the other way round → (kernel rows, twin rows, unpaired rows)."""
    import numpy as np

    d = np.abs(bk[:, None, :4] - bp[None, :, :4]).max(-1) if len(bk) else np.zeros((0, len(bp)))
    pairs, free = [], set(range(len(bp)))
    for i in np.argsort(d.min(1) if len(bp) else np.zeros(len(bk)), kind="stable"):
        j = min(free, key=lambda j: d[i, j])
        if d[i, j] <= box_tol:
            pairs.append((i, j))
            free.discard(j)
    ki = sorted(set(range(len(bk))) - {i for i, _ in pairs})
    sk, sp = np.sort(bk[ki, 4]), np.sort(bp[sorted(free), 4])
    if len(sk) != len(sp) or (len(sk) and float(np.abs(sk - sp).max()) > tie):
        raise AssertionError(f"rows without a twin: kernel {bk[ki]}, twin {bp[sorted(free)]}")
    pairs.sort()
    return np.array([i for i, _ in pairs], int), np.array([j for _, j in pairs], int), len(ki)


def pose_predict_phase(y, frames, card):
    """`[pose predict]`: the trained model over held-out BGR frames, one per predict call, at POSE_PREDICT's conf and
    max_det, f32 through the kernels against f32 through the twins: equal detection counts, and for each kernel row
    the twin's with the nearest box (`_paired`; of two overlapping candidates of one score either may be kept): equal
    classes, boxes within 1e-2 px, conf 1e-4, keypoint x, y 1e-2 px,
    visibilities 1e-4. Then bf16 frames/s (host clock) with the host's
    split per frame (letterbox + assembly, enqueue, the wait for the device, the Results with the keypoints'
    inverse letterbox) → each frame's f32 kernel rows."""
    import numpy as np

    def run(half, plain):
        out = []
        for f in frames:
            r = y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False, **POSE_PREDICT)[0]
            out.append((r.boxes.data.copy(), r.keypoints.data.copy()))
        return out

    run(False, False)  # warm-up
    pk, launches = counted(POSE_PATH, lambda: run(False, False))
    pp = run(False, True)
    n_det, n_tied, worst = 0, 0, {"box": 0.0, "conf": 0.0, "kpt": 0.0, "vis": 0.0}
    for (bk, kk), (bp, kp) in zip(pk, pp):
        if bk.shape != bp.shape or kk.shape != kp.shape or kk.shape[1:] != (17, 3):
            raise AssertionError(f"pose predict: {bk.shape} / {kk.shape} vs twins {bp.shape} / {kp.shape}")
        if len(bk):
            i, j, tied = _paired(bk, bp)
            bk, kk, bp, kp = bk[i], kk[i], bp[j], kp[j]
            n_tied += tied
            if not np.array_equal(bk[:, 5], bp[:, 5]):
                raise AssertionError(f"pose predict: classes {bk[:, 5]} vs twins {bp[:, 5]}")
            worst["box"] = max(worst["box"], float(np.abs(bk[:, :4] - bp[:, :4]).max()))
            worst["conf"] = max(worst["conf"], float(np.abs(bk[:, 4] - bp[:, 4]).max()))
            dk, dv = _kpt_diffs(kk, kp)
            worst["kpt"], worst["vis"] = max(worst["kpt"], dk), max(worst["vis"], dv)
        n_det += len(bk)
    if n_det == 0 or worst["box"] > 1e-2 or worst["conf"] > 1e-4 or worst["kpt"] > 1e-2 or worst["vis"] > 1e-4:
        raise AssertionError(f"pose predict: {n_det} detections, {worst}")
    confs = np.concatenate([b[:, 4] for b, _ in pk])
    vis = np.concatenate([k[..., 2].ravel() for _, k in pk])
    log("pose predict f32", card, f"{len(frames)} frames, {n_det} detections equal to the twins' ({n_tied} of them replaced "
        f"by an overlapping one of the same score; max |box| {worst['box']:.3e} px, "
        f"|conf| {worst['conf']:.3e}, |keypoint x, y| {worst['kpt']:.3e} px, |visibility| {worst['vis']:.3e}); conf "
        f"{confs.min():.4f}-{confs.max():.4f}, visibility {vis.min():.3f}-{vis.max():.3f}; launches {launches}")
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **POSE_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(POSE_PATH, lambda: run(True, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    split = {k: sum(t[f"{k}_s"] for t in ts) / len(ts) * 1e3 for k in ("pre", "enqueue", "wait", "post")}
    log("pose predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + assembly {split['pre']:.3f}, enqueue {split['enqueue']:.3f}, wait "
        f"{split['wait']:.3f}, Results with the keypoints {split['post']:.3f}; launches {launches}")
    return pk


def pose_forward_phase(frames, card):
    """`[pose forward]`: yolov8n-pose at full width (nc 1, the JAX package's init(0)) at 640x640, B = 8 and 32, f32
    through the kernels against the twins: boxes within 1e-2 px, scores 1e-4, keypoint x, y 1e-2 px, visibilities
    1e-4; NMS with the 51 keypoint rows as extra columns, the kernel against its twin on the same predictions: every
    output equal, bit for bit; kernels 1, 2, 3 and 5 held against their twins on those activations
    (`hold_path_kernels`). NMS runs at conf 0, since the initial tree's scores sit near 1e-3: every anchor is a
    candidate, K = 1024."""
    import torch

    from yolo_tpu_torch.nn.tasks import PoseModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m = PoseModel("yolov8n-pose.yaml")
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])
    xy = torch.zeros(56, dtype=torch.bool)
    xy[5:] = torch.arange(51) % 3 != 2

    def nms(preds, plain):
        return non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, max_det=300, nc=m.nc, plain=plain)

    for B in (8, 32):
        x = x32[:B]
        (pk, ok), launches = counted(POSE_PATH, lambda: (lambda p: (p, nms(p, False)))(m.predict(x)))
        pp = m.predict(x, plain=True)
        op = nms(pk, True)
        torch.cuda.synchronize()
        d = (pk - pp).abs()
        err = {"box": float(d[:, :4].max()), "score": float(d[:, 4].max()), "kpt": float(d[:, xy].max()),
               "vis": float(d[:, 5:][:, ~xy[5:]].max())}
        same = all(torch.equal(ok[k], op[k]) for k in ok) and set(ok) == set(op)
        if (pk.shape != (B, 56, 8400) or not torch.isfinite(pk).all() or err["box"] > 1e-2 or err["score"] > 1e-4
                or err["kpt"] > 1e-2 or err["vis"] > 1e-4 or not same or ok["extra"].shape != (B, 300, 51)):
            raise AssertionError(f"pose forward B={B}: {err}, NMS kernel == twin {same}, {tuple(pk.shape)}")
        log("pose forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; NMS with 51 extras: kernel and twin equal in every "
            f"output ({int(ok['valid'].sum())} kept slots); launches {launches}")
        hold_path_kernels([m], x, f"pose forward B={B}", card, conf=0.0, iou=0.7)


def track_yaml_for(y, frames, path: Path, decimals: int = 6, **kw) -> tuple:
    """A ByteTrack yaml for a briefly trained model (its scores sit far below bytetrack.yaml's 0.25): the high and
    new-track thresholds at the median over `frames` of each frame's best f32 score, the low one at a quarter of it,
    written with `decimals` digits, and no score fused into the IoU cost (at scores near 0.01 it leaves every cost
    above match_thresh) → (the yaml, the predict conf: that quarter). An obb model a few steps old scores ~3e-4 on
    every frame alike, where six digits can round the high threshold above every score: `[obb track]` writes ten."""
    import numpy as np

    best = [float((r.obb if r.obb is not None else r.boxes).conf.max()) if len(r) else 0.0
            for f in frames for r in y.predict(f, half=False, plain=False, compute_dtype="float32", verbose=False, **kw, **POSE_PREDICT)]
    hi = float(np.median(best))
    text = (ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "bytetrack.yaml").read_text()
    for key, v in (("track_high_thresh", f"{hi:.{decimals}f}"), ("track_low_thresh", f"{hi / 4:.{decimals}f}"),
                   ("new_track_thresh", f"{hi:.{decimals}f}"), ("fuse_score", "False")):
        text = "\n".join(f"{key}: {v}" if line.startswith(f"{key}:") else line for line in text.splitlines())
    path.write_text(text + "\n")
    return path, hi / 4


def moving_clip(frames, n: int, steps: int = 16, dx: int = 3):
    """n frames that move: each of `frames` in turn rolled right by dx px a frame for `steps` frames (the held-out
    frames are independent images, on which no track would live past its first frame)."""
    import numpy as np

    return [np.ascontiguousarray(np.roll(frames[(i // steps) % len(frames)], dx * (i % steps), axis=1)) for i in range(n)]


def pose_track_phase(y, frames, seg, tmp: Path, card):
    """`[pose track]`: YOLO.track of the trained pose model over a 64-frame clip made of the held-out frames
    (`moving_clip`), one frame per call with persist=True, ByteTrack at thresholds fitted to the model's scores
    (`track_yaml_for`), f32 through the kernels against f32 through the twins: equal rows and ids per frame (boxes
    1e-2 px, conf 1e-4) and each track's keypoints (x, y 1e-2 px, visibility 1e-4); then bf16 frames/s. `[segment
    track]`: the same with the trained yolov8n-seg of the segment phases over a clip of its frames, the tracks' masks
    against the twins' (their summed intersection over their summed union >= 0.99; the least IoU of one track's mask
    printed: a box edge within 1e-4 px of a prototype pixel's centre crops a whole column of a small mask one way or
    the other)."""
    import numpy as np

    def run(model, frames, yaml, conf, half, plain, extra):
        model._tracker = None
        out = []
        for f in frames:
            r = model.track(f, persist=True, tracker=str(yaml), conf=conf, max_det=POSE_PREDICT["max_det"], half=half, plain=plain,
                            compute_dtype=compute_dtype(half), verbose=False, **extra)[0]
            out.append((r.boxes.data.copy(), (r.keypoints if r.keypoints is not None else r.masks).data.copy()))
        return out

    fitted = {}
    frames = moving_clip(frames, TASK_TRACK_FRAMES)
    for tag, model, fr, extra in (("pose track", y, frames, {}),
                                  ("segment track", seg[0], moving_clip(seg[1], TASK_TRACK_FRAMES), {"retina_masks": False})):
        yaml, conf = fitted[tag] = track_yaml_for(model, fr, tmp / f"{tag.split()[0]}_bytetrack.yaml", **extra)
        rk, launches = counted(POSE_PATH, lambda: run(model, fr, yaml, conf, False, False, extra))
        rp = run(model, fr, yaml, conf, False, True, extra)
        worst, n_rows, ids = compare_tracks([b for b, _ in rk], [b for b, _ in rp], 1e-2, 1e-4, f"{tag}: kernels against plain")
        least = {"kpt": 0.0, "vis": 0.0, "iou": 1.0}
        inter = union = 0
        for (bk, ek), (bp, ep) in zip(rk, rp):
            ok, op = np.argsort(bk[:, 4], kind="stable"), np.argsort(bp[:, 4], kind="stable")
            if tag == "pose track":
                dk, dv = _kpt_diffs(ek[ok], ep[op])
                least["kpt"], least["vis"] = max(least["kpt"], dk), max(least["vis"], dv)
            else:
                least["iou"] = min(least["iou"], *(_mask_iou(a, b) for a, b in zip(ek[ok], ep[op])), 1.0)
                inter, union = inter + int((ek[ok] & ep[op]).sum()), union + int((ek[ok] | ep[op]).sum())
        overall = inter / union if union else 1.0
        if n_rows <= 0 or least["kpt"] > 1e-2 or least["vis"] > 1e-4 or overall < 0.99:
            raise AssertionError(f"{tag}: {n_rows} tracked rows, per-track {least}, masks' summed IoU {overall}")
        per = (f"keypoints per track within {least['kpt']:.3e} px / visibility {least['vis']:.3e}" if tag == "pose track"
               else f"the tracks' masks: summed IoU with the twins' {overall:.6f}, the least one track's {least['iou']:.6f}")
        log(f"{tag} f32", card, f"ByteTrack at high/new {conf * 4:.4f}, low {conf:.4f}: rows and ids equal on every frame "
            f"({n_rows} tracked rows, {len(ids)} ids), max |box diff| {worst:.3e} px; {per}; launches {launches}")
    yaml, conf = fitted["pose track"]
    run(y, frames[:2], yaml, conf, True, False, {})  # warm: bf16 weights
    t0 = time.perf_counter()
    rb, launches = counted(POSE_PATH, lambda: run(y, frames, yaml, conf, True, False, {}))
    wall = time.perf_counter() - t0
    log("pose track bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per track call); {sum(len(b) for b, _ in rb)} tracked rows; launches {launches}")


def pose_phases(root: Path, card, seg):
    """The pose task's six phases on the keypoint splits written under `root`; `seg` is the segment phases' trained
    YOLO and its frames, which `[segment track]` tracks."""
    import cv2
    import numpy as np

    data = pose_split(root)
    y = pose_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-pose.yaml", tag="pose train step f32", recipe=POSE_RUN)
    pose_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(POSE_VAL[0])]
    pose_predict_phase(y, frames, card)
    pose_forward_phase(np.stack(frames), card)
    pose_track_phase(y, frames, seg, root, card)


OBB_PATH = {"c2f", "c2f_upconcat", "head_level"}  # the rotated NMS is plain torch: kernel 5 must not launch
OBB_TRAIN, OBB_VAL = (256, 60_000), (64, 60_001)  # `[obb ...]`'s rotated splits: frames and seed
# yolov8n-obb from the JAX package's init(0), rebuilt at nc 2: the pose recipe (AdamW lr0 8e-4, batch 16, 640, bf16,
# 3 epochs with close_mosaic 1), the cfg's augmentations otherwise
OBB_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
               plots=False, exist_ok=True)
OBB_PREDICT = dict(conf=0.0, max_det=10)  # `[obb predict]`, `[obb track]`: each frame's ten best, however low


def _obb_target(rng, w, h, near=None):
    """A rotated rectangle elongated like an aircraft seen from above (20-160 px long, aspect 2-6, a uniform angle)
    inside a w x h frame, or, given `near`, one overlapping it (its centre a quarter to half a length along its axis,
    its angle within 0.2 rad, its size within 20%) → (cx, cy, long side, short side, angle in radians)."""
    import math

    import numpy as np

    if near is None:
        L = rng.uniform(20, 160)
        S, a = L / rng.uniform(2, 6), rng.uniform(0, math.pi)
        r = 0.5 * math.hypot(L, S)
        return rng.uniform(r, w - r), rng.uniform(r, h - r), L, S, a
    cx, cy, L, S, a = near
    d = rng.uniform(0.25, 0.5) * L * rng.choice([-1, 1])
    L2, S2, a2 = L * rng.uniform(0.8, 1.2), S * rng.uniform(0.8, 1.2), a + rng.uniform(-0.2, 0.2)
    r = 0.5 * math.hypot(L2, S2)
    return (float(np.clip(cx + d * math.cos(a), r, w - r)), float(np.clip(cy + d * math.sin(a), r, h - r)), L2, S2, a2)


def write_obb_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>, each with
    1-4 bright rotated rectangles (`_obb_target`), a third of the frames with one overlapping pair; class 0 solid,
    class 1 hollow (its outline a quarter of its short side, at least 2 px); their DOTA rows (`cls x1 y1 ... x4 y4`,
    the corners of cv2.boxPoints normalized) under root/labels/<split>; nc 2 → the dataset yaml."""
    import math

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        targets = [_obb_target(rng, w, h) for _ in range(rng.integers(1, 4))]
        if i % 3 == 0:
            targets.append(_obb_target(rng, w, h, near=targets[0]))
        lines = []
        for t in targets:
            c = int(rng.integers(0, 2))
            pts = cv2.boxPoints(((t[0], t[1]), (t[2], t[3]), math.degrees(t[4])))
            poly = [np.round(pts).astype(np.int32)]
            val = float(rng.uniform(150, 230))
            if c == 0:
                cv2.fillPoly(img, poly, val)
            else:
                cv2.polylines(img, poly, True, val, max(2, int(t[3] / 4)), cv2.LINE_AA)
            lines.append(f"{c} " + " ".join(f"{v:.6f}" for v in (pts / [w, h]).ravel()))
        gray = np.clip(img, 0, 255).astype(np.uint8)
        write_png(root / f"images/{split}/{i}.png", cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    flush_pngs()
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: solid\n  1: hollow\n")
    return root / "data.yaml"


def obb_train_phase(data, run_dir, card):
    """`[obb train]`: YOLO("yolov8n-obb.yaml").train with OBB_RUN on the 256-frame rotated split, validating on the 64
    held-out frames each epoch: per epoch the three loss components and the metrics; images/s over the whole .train
    call; the step's split in events; peak memory; the launches of check_amp and the validations → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-obb.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(OBB_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                          project=str(run_dir), name="obb", **OBB_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "obb" or y.model.nc != 2 or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"obb train: task {y.task}, nc {y.model.nc}, amp {y.trainer.args.amp}, metrics {metrics}")
    names = ("box", "cls", "dfl")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in names]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"obb train: epoch {r['epoch']} losses {losses}")
        log("obb train", card, f"epoch {r['epoch'] + 1}/{OBB_RUN['epochs']}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, losses))
            + f"; P {r['metrics/precision']:.4f} R {r['metrics/recall']:.4f} mAP50 {r['metrics/mAP50']:.4f} "
            f"mAP50-95 {r['metrics/mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = OBB_RUN["epochs"] * OBB_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("obb train", card, f"{OBB_RUN['epochs']} epochs of {OBB_TRAIN[0]} frames at batch {OBB_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {OBB_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events; {sum(mean[k] for k in ('forward', 'backward', 'optimizer')):.2f} ms a step); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def obb_val_kernels_phase(y, data, card):
    """`[obb val kernels]`: the trained model on the held-out split, f32 through the kernels against f32 through the
    twins (every key within 1e-4), then bf16 images/s over a warmed .val call."""
    rk, launches = counted(OBB_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4:
        raise AssertionError(f"obb val: kernels {rk} vs twins {rp}")
    log("obb val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(OBB_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("obb val bf16", card, f"{OBB_VAL[0]} frames in {wall:.2f} s = {OBB_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); mAP50 {rb['mAP50']:.4f} mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50']:.4f} / {rk['mAP50-95']:.4f}); "
        f"launches {launches}")


def _obb_rows(data):
    """OBBoxes rows [cx, cy, w, h, angle, conf, cls] → [cx, cy, w, h, conf, cls, angle], the column order `_paired`
    reads (the box first, then the score)."""
    return data[:, [0, 1, 2, 3, 5, 6, 4]]


def obb_predict_phase(y, frames, card):
    """`[obb predict]`: the trained model over held-out BGR frames, one per predict call, at OBB_PREDICT's conf and
    max_det, f32 through the kernels against f32 through the twins: equal detection counts, and for each kernel row
    the twin's with the nearest box (`_paired`): equal classes, centres and sizes within 1e-2 px, angles 1e-4 rad,
    conf 1e-4. Then bf16 frames/s (host clock) with the host's split per frame (letterbox + assembly, enqueue, the
    wait for the device, the Results with the inverse letterbox) → each frame's f32 kernel rows."""
    import numpy as np

    def run(half, plain):
        return [_obb_rows(y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False,
                                    **OBB_PREDICT)[0].obb.data.copy()) for f in frames]

    run(False, False)  # warm-up
    pk, launches = counted(OBB_PATH, lambda: run(False, False))
    pp = run(False, True)
    n_det, n_tied, worst = 0, 0, {"box": 0.0, "angle": 0.0, "conf": 0.0}
    for bk, bp in zip(pk, pp):
        if bk.shape != bp.shape:
            raise AssertionError(f"obb predict: {bk.shape} vs twins {bp.shape}")
        if len(bk):
            i, j, tied = _paired(bk, bp)
            bk, bp = bk[i], bp[j]
            n_tied += tied
            if not np.array_equal(bk[:, 5], bp[:, 5]):
                raise AssertionError(f"obb predict: classes {bk[:, 5]} vs twins {bp[:, 5]}")
            worst["box"] = max(worst["box"], float(np.abs(bk[:, :4] - bp[:, :4]).max()))
            worst["conf"] = max(worst["conf"], float(np.abs(bk[:, 4] - bp[:, 4]).max()))
            worst["angle"] = max(worst["angle"], float(np.abs(bk[:, 6] - bp[:, 6]).max()))
        n_det += len(bk)
    if n_det == 0 or worst["box"] > 1e-2 or worst["conf"] > 1e-4 or worst["angle"] > 1e-4:
        raise AssertionError(f"obb predict: {n_det} detections, {worst}")
    rows = np.concatenate(pk)
    log("obb predict f32", card, f"{len(frames)} frames, {n_det} detections equal to the twins' ({n_tied} of them replaced "
        f"by an overlapping one of the same score; max |centre, size| {worst['box']:.3e} px, |angle| {worst['angle']:.3e} "
        f"rad, |conf| {worst['conf']:.3e}); conf {rows[:, 4].min():.4f}-{rows[:, 4].max():.4f}, angle {rows[:, 6].min():.3f}-"
        f"{rows[:, 6].max():.3f} rad, classes {sorted(set(rows[:, 5].astype(int).tolist()))}; launches {launches}")
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **OBB_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(OBB_PATH, lambda: run(True, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    split = {k: sum(t[f"{k}_s"] for t in ts) / len(ts) * 1e3 for k in ("pre", "enqueue", "wait", "post")}
    log("obb predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + assembly {split['pre']:.3f}, enqueue {split['enqueue']:.3f}, wait "
        f"{split['wait']:.3f}, Results with the oriented boxes {split['post']:.3f}; launches {launches}")
    return pk


def rotated_nms_near_ties(preds, conf, iou, max_nms=1024):
    """The pairs of candidates of one image, in the rotated NMS's own order (the top K by score, the class offset on the
    centres), whose probiou lies within 1e-6 of `iou`: where a card and the CPU may round either way → per image."""
    import torch

    from yolo_tpu_torch.ops.boxes import probiou
    from yolo_tpu_torch.ops.nms import MAX_WH

    nc = preds.shape[1] - 5
    out = []
    for p in preds:
        scores, cls = p[4 : 4 + nc].T.max(-1)
        scores = torch.where(scores > conf, scores, -1.0)
        top, idx = torch.sort(scores, descending=True, stable=True)
        top, idx = top[:max_nms], idx[:max_nms]
        rb = torch.cat([p[:4].T, p[4 + nc :].T], -1)[idx]
        rb = torch.cat([rb[:, :2] + (cls[idx].to(rb.dtype) * MAX_WH)[:, None], rb[:, 2:]], -1)
        pi = probiou(rb[:, None], rb[None])[..., 0]
        live = (top > 0)[:, None] & (top > 0)[None] & torch.ones_like(pi, dtype=torch.bool).triu(1)
        out.append(int(((pi - iou).abs() <= 1e-6)[live].sum()))
    return out


def obb_forward_phase(frames, card):
    """`[obb forward]`: yolov8n-obb at full width with nc 15 (DOTAv1's class count; the JAX package's init(0)) at
    640x640, B = 8 and 32, f32 through the kernels against the twins: boxes within 1e-2 px, scores and angles 1e-4;
    kernels 1, 2 and 3 held against their twins on those activations (`hold_path_kernels`, no kernel 5); the card's
    rotated NMS (conf 0: K = 1024 candidates, iou 0.7) against the same function on the CPU on the same predictions:
    equal outputs on every image with no candidate pair's probiou within 1e-6 of the threshold (counted and printed);
    the rotated NMS's device time against the forward's (CUDA events)."""
    import torch

    from yolo_tpu_torch.nn.tasks import OBBModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression_rotated

    m = OBBModel("yolov8n-obb.yaml", nc=15)
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])

    def nms(preds):
        return non_max_suppression_rotated(preds, conf_thres=0.0, iou_thres=0.7, max_det=300)

    for B in (8, 32):
        x = x32[:B]
        pk, launches = counted(OBB_PATH, lambda: m.predict(x))
        pp = m.predict(x, plain=True)
        ok = nms(pk)
        oc = nms(pk.cpu())
        torch.cuda.synchronize()
        d = (pk - pp).abs()
        err = {"box": float(d[:, :4].max()), "score": float(d[:, 4:-1].max()), "angle": float(d[:, -1].max())}
        if pk.shape != (B, 4 + 15 + 1, 8400) or not torch.isfinite(pk).all() or err["box"] > 1e-2 or err["score"] > 1e-4 \
                or err["angle"] > 1e-4:
            raise AssertionError(f"obb forward B={B}: {err}, {tuple(pk.shape)}")
        ties = rotated_nms_near_ties(pk.cpu(), 0.0, 0.7)
        same = [all(torch.equal(ok[k][b].cpu(), oc[k][b]) for k in ok) for b in range(B)]
        if not all(s for s, t in zip(same, ties) if t == 0):
            raise AssertionError(f"obb forward B={B}: the card's rotated NMS differs from the CPU's on images without near "
                                 f"ties: {[b for b in range(B) if not same[b] and ties[b] == 0]}")
        fwd_ms = cuda_ms(lambda: m.predict(x))
        nms_ms = cuda_ms(lambda: nms(pk))
        log("obb forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; rotated NMS (K 1024, iou 0.7) on the card equal to the "
            f"CPU's on {sum(same)}/{B} images ({int(ok['valid'].sum())} kept slots; {sum(ties)} candidate pairs within 1e-6 "
            f"of the threshold, on {sum(t > 0 for t in ties)} images); device ms: forward {fwd_ms:.3f}, rotated NMS "
            f"{nms_ms:.3f} (({B}, 1024, 1024) probiou); launches {launches}")
        hold_path_kernels([m], x, f"obb forward B={B}", card, conf=0.0, iou=0.7, nms=False)


def obb_track_phase(y, frames, tmp: Path, card):
    """`[obb track]`: YOLO.track of the trained obb model over a 64-frame clip made of the held-out frames
    (`moving_clip`), one frame per call with persist=True, ByteTrack at thresholds fitted to the model's scores
    (`track_yaml_for`), f32 through the kernels against f32 through the twins: equal rows (centres and sizes 1e-2 px,
    angles and conf 1e-4), ids and classes per frame; then bf16 frames/s."""
    import numpy as np

    def run(yaml, conf, half, plain):
        y._tracker = None
        out = []
        for f in clip:
            r = y.track(f, persist=True, tracker=str(yaml), conf=conf, max_det=OBB_PREDICT["max_det"], half=half, plain=plain,
                        compute_dtype=compute_dtype(half), verbose=False)[0]
            out.append(r.obb.data.copy() if r.obb is not None else np.zeros((0, 8), np.float32))
        return out

    clip = moving_clip(frames, TASK_TRACK_FRAMES)
    yaml, conf = track_yaml_for(y, clip, tmp / "obb_bytetrack.yaml", decimals=10)
    rk, launches = counted(OBB_PATH, lambda: run(yaml, conf, False, False))
    rp = run(yaml, conf, False, True)
    def rows7(rows):  # [cx, cy, w, h, id, conf, cls]: compare_tracks' tracked-box form
        return [r[:, [0, 1, 2, 3, 5, 6, 7]] if r.shape[-1] == 8 else r for r in rows]

    worst, n_rows, ids = compare_tracks(rows7(rk), rows7(rp), 1e-2, 1e-4, "obb track: kernels against plain")
    angle = 0.0
    for a, b in zip(rk, rp):
        if len(a) and a.shape[-1] == 8:
            a, b = a[np.argsort(a[:, 5], kind="stable")], b[np.argsort(b[:, 5], kind="stable")]
            angle = max(angle, float(np.abs(a[:, 4] - b[:, 4]).max()))
    if n_rows <= 0 or angle > 1e-4:
        raise AssertionError(f"obb track: {n_rows} tracked rows, max |angle| {angle}")
    log("obb track f32", card, f"ByteTrack at high/new {conf * 4:.4f}, low {conf:.4f}: rows and ids equal on every frame "
        f"({n_rows} tracked rows, {len(ids)} ids), max |centre, size| {worst:.3e} px, |angle| {angle:.3e} rad; launches {launches}")
    run(yaml, conf, True, False)  # warm: bf16 weights
    t0 = time.perf_counter()
    rb, launches = counted(OBB_PATH, lambda: run(yaml, conf, True, False))
    wall = time.perf_counter() - t0
    log("obb track bf16", card, f"{len(clip)} frames in {wall:.3f} s = {len(clip) / wall:.1f} frames/s (host clock, one frame "
        f"per track call); {sum(len(b) for b in rb)} tracked rows; launches {launches}")


def obb_phases(root: Path, card):
    """The obb task's six phases on the rotated splits written under `root`."""
    import cv2
    import numpy as np

    data = obb_split(root)
    y = obb_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-obb.yaml", tag="obb train step f32", recipe={**OBB_RUN, "task": "obb"})
    obb_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(OBB_VAL[0])]
    obb_predict_phase(y, frames, card)
    obb_forward_phase(np.stack(frames), card)
    obb_track_phase(y, frames, root, card)


# ---------------------------------------------------------------- slice 17 --

TASK_YAMLS = {"segment": "yolov8n-seg.yaml", "pose": "yolov8n-pose.yaml", "obb": "yolov8n-obb.yaml"}
TASK_FORWARD_PATH = {"c2f", "c2f_upconcat", "head_level"}  # a task model's predict: kernels 1-3, no NMS
TASK_PREDICT = dict(conf=0.0, max_det=10, verbose=False)  # each frame's ten best: an untrained model scores near its bias prior
TASK_INT8_FRAMES = 4  # cut to fit the run's time limit (PERF.md §4)
TASK_SERVE_FRAMES = 4  # `[task serve]`: frames a client, two clients a lane
GHOST_P2_FRAMES = 64  # `[pipeline ghost-p2]`: one 64-frame chunk of the clip
GHOST_P2_CONF = 1e-6  # below every score of the init(0) tree (its bias prior at P2 is 2.4e-6): 16 detections every frame


def task_preds_err(model, got, want) -> dict:
    """|kernel − twin| of a task model's decoded predictions (a segment model's (preds, protos)): `px` over the box rows
    and pose keypoints' x, y (pixels), `unit` over the scores, coefficients, visibilities, angles and prototypes; both
    must be finite (`column_errors`)."""
    errs = column_errors(model, got, want)
    return {"px": errs["px"][0], "unit": max(e for k, (e, _) in errs.items() if k != "px")}


def check_preds(tag, err, px=1e-2, unit=1e-4):
    if err["px"] > px or err["unit"] > unit:
        raise AssertionError(f"{tag}: kernels against twins {err} (gates {px} px, {unit})")


def result_rows(r):
    """One Results as rows: an obb result's (n, 7) oriented boxes, else boxes.data with a pose result's keypoints
    flattened beside them."""
    import numpy as np

    if getattr(r, "obb", None) is not None:
        return np.asarray(r.obb.data, np.float64)
    rows = np.asarray(r.boxes.data, np.float64)
    if getattr(r, "keypoints", None) is not None:
        rows = np.concatenate([rows, np.asarray(r.keypoints.data, np.float64).reshape(len(rows), -1)], 1)
    return rows


def task_benchmark_phase(frames, card):
    """`[task benchmark]`: YOLO("yolov8n-{seg,pose,obb}.yaml") (the JAX package's init(0) trees, full width) at 640²:
    the decoded forward of 8 letterboxed frames f32 through kernels 1-3 against the twins (boxes and keypoint x, y within
    1e-2 px, scores, coefficients, visibilities, angles and prototypes 1e-4), then `YOLO.benchmark(imgsz=640)` in bf16:
    its rows at B = 1 / 8 / 32 and the launches (kernels 1-3; no NMS in a benchmark)."""
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import params_from_jax

    x = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(8)])
    for task, name in TASK_YAMLS.items():
        y = YOLO(name)
        params_from_jax(y.model, y.params, torch.float32)
        got, launches = counted(TASK_FORWARD_PATH, lambda: y.model.predict(x))
        err = task_preds_err(y.model, got, y.model.predict(x, plain=True))
        check_preds(f"task benchmark {task}", err)
        t0 = time.perf_counter()
        rows, lb = counted(TASK_FORWARD_PATH, lambda: y.benchmark(imgsz=640))
        wall = time.perf_counter() - t0
        if [r["batch"] for r in rows] != [1, 8, 32] or not all(r["fps"] > 0 for r in rows):
            raise AssertionError(f"task benchmark {task}: rows {rows}")
        log(f"task benchmark {task}", card, f"f32 B=8 640x640 kernels against twins max |px| {err['px']:.3e}, |rest| {err['unit']:.3e} "
            f"(launches {launches}); YOLO.benchmark(imgsz=640) bf16 in {wall:.1f} s: " + ", ".join(
                f"B={r['batch']} {r['latency_ms']} ms ({r['std_ms']}) = {r['fps']} frames/s" for r in rows) + f"; launches {lb}")


def task_int8_phase(frames, card):
    """`[task int8]`: predict(int8=True) (dynamic activation scales: the int8 convs, no kernel 1-3; the NMS kernel on the
    segment and pose routes, none on the obb route's rotated NMS) of the three init(0) models on 8 BGR frames at 640,
    each frame's ten best: f32 through the NMS kernel against its twin (equal rows, 1e-2 px, 1e-4); then the int8 tree's
    decoded predictions of one frame on the card against the CPU's, whose convs are the same exact int8 products: a
    dynamic code may flip where the card's f32 rounds an activation to the other side of a code boundary, so the gate
    is on the 99.9th percentile (boxes 0.05 px, the rest 1e-3) and the largest difference is printed; then bf16 timed."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.quantize import quantize_params
    from yolo_tpu_torch.nn.tasks import fuse, params_from_jax

    x = letterboxed(frames[0])
    for task, name in TASK_YAMLS.items():
        path = set() if task == "obb" else {"nms_keep"}
        y = YOLO(name)
        rk, launches = counted(path, lambda: y.predict(frames, int8=True, compute_dtype="float32", imgsz=640, batch=16, **TASK_PREDICT))
        rp = YOLO(name).predict(frames, int8=True, compute_dtype="float32", imgsz=640, batch=16, plain=True, **TASK_PREDICT)
        if not y.model.int8:
            raise AssertionError(f"task int8 {task}: the model does not walk int8")
        worst = 0.0
        for a, b in zip(rk, rp):
            a, b = result_rows(a), result_rows(b)
            if a.shape != b.shape or len(a) == 0:
                raise AssertionError(f"task int8 {task}: {a.shape} vs twin {b.shape}")
            worst = max(worst, float(np.abs(a - b).max()))
        if worst > 1e-2:
            raise AssertionError(f"task int8 {task}: kernel against twin max |diff| {worst}")
        q = quantize_params(fuse(y.params))
        mc, mh = type(y.model)(name), type(y.model)(name, device="cpu")
        params_from_jax(mc, q, torch.float32)
        params_from_jax(mh, q, torch.float32)
        with torch.no_grad():
            gc, gh = mc.predict(x, neck_opt=False), mh.predict(x.cpu(), neck_opt=False)
        pc, ph = (gc[0], gh[0]) if isinstance(gc, tuple) else (gc, gh)
        d = (pc.cpu().float() - ph.float()).abs()
        box, rest = d[:, :4].flatten(), d[:, 4:].flatten()
        q999 = {k: float(torch.quantile(v[:: max(1, v.numel() // 2**24)], 0.999)) for k, v in (("box", box), ("rest", rest))}
        if not torch.isfinite(pc).all() or q999["box"] > 0.05 or q999["rest"] > 1e-3:
            raise AssertionError(f"task int8 {task}: card against CPU 99.9th percentiles {q999}")
        y.predict(frames, int8=True, imgsz=640, batch=16, **TASK_PREDICT)  # warm: bf16
        t0 = time.perf_counter()
        rb, lb = counted(path, lambda: y.predict(frames, int8=True, imgsz=640, batch=16, **TASK_PREDICT))
        wall = time.perf_counter() - t0
        log(f"task int8 {task}", card, f"f32 kernel = twin on {len(frames)} frames ({sum(len(r) for r in rk)} rows, max |diff| {worst:.3e}; "
            f"launches {launches}); card against CPU on one frame: |box| max {float(box.max()):.3e} px, 99.9% {q999['box']:.3e}; "
            f"|rest| max {float(rest.max()):.3e}, 99.9% {q999['rest']:.3e}; bf16 {len(frames) / wall:.1f} frames/s ({len(frames)} "
            f"frames, one predict); launches {lb}")


def task_tiled_phase(frame, card):
    """`[task tiled]`: segment and pose (init(0) trees) through `ops.tiling.tiled_predict` on one 640x512 BGR frame (tile
    256, overlap 0.25: 9 tiles, one batch), each tile's ten best: f32 through the kernels against the twins (the merged
    boxes at the f32 gates), kernels 1, 2, 3 and 5 held against their twins on the tile batch, then bf16 timed over 16
    calls."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.ops.tiling import slice_tiles, tile_grid, tiled_predict

    grid = tile_grid(frame.shape[0], frame.shape[1], 256, 0.25)
    tiles = torch.from_numpy(np.stack(slice_tiles(frame, grid, 256))).cuda().flip(-1).float() / 255.0
    kw = dict(tile=256, overlap=0.25, conf=0.0, max_det=10)
    for task in ("segment", "pose"):
        y, yp = YOLO(TASK_YAMLS[task]), YOLO(TASK_YAMLS[task])
        rk, launches = counted(SEG_PATH, lambda: tiled_predict(y, frame, compute_dtype="float32", **kw))
        rp = tiled_predict(yp, frame, compute_dtype="float32", plain=True, **kw)
        worst = same_dets([merged_rows(rk)], [merged_rows(rp)], f"task tiled {task}")
        hold_path_kernels([y.model], tiles, f"task tiled {task}", card, conf=0.0)
        tiled_predict(y, frame, **kw)  # warm: bf16
        t0 = time.perf_counter()
        rb, lb = counted(SEG_PATH, lambda: [tiled_predict(y, frame, **kw) for _ in range(16)])
        wall = time.perf_counter() - t0
        log(f"task tiled {task}", card, f"{len(grid)} tiles of 256: f32 kernels = twins ({len(rk[0])} merged boxes, max |diff| "
            f"{worst:.3e}; launches {launches}); bf16 {wall / 16 * 1e3:.2f} ms a frame (16 calls), {len(rb[0][0])} merged boxes; "
            f"launches {lb}")


def task_serve_phase(frames, card):
    """`[task serve]`: one DetectionServer with a segment lane 0, a pose lane 1 (init(0) trees saved as .npz, conf 0,
    ten detections a frame) and an obb lane 2, which is out of service (its Results hold no axis-aligned boxes). f32
    through the kernels against a second server f32 through the twins: two clients a lane, 16 frames each, equal
    replies at the f32 gates; then the bf16 server (the default), timed, with its launches."""
    from yolo_tpu_torch import YOLO

    with tempfile.TemporaryDirectory() as tmp:
        src = {i: str(YOLO(TASK_YAMLS[t]).save(str(Path(tmp) / f"{t}.npz"))) for i, t in enumerate(TASK_YAMLS)}
        jobs = [[(lane, frames[(2 * lane + c) * TASK_SERVE_FRAMES + k]) for k in range(TASK_SERVE_FRAMES)]
                for lane in (0, 1) for c in (0, 1)]
        kw = dict(conf=0.0, max_det=10, out_of_service=(2,))
        f32 = {"compute_dtype": "float32"}
        with serving(src, predict_args=f32, **kw) as srv:
            if "obb" not in (srv.lanes[2].error or ""):
                raise AssertionError(f"task serve: the obb lane is not out of service: {srv.lanes[2].error}")
            (out, wall), launches = counted(SERVE_PATH, lambda: run_clients(srv.port, jobs))
        with serving(src, predict_args={**f32, "plain": True}, **kw) as srv:
            (twin, _), none = counted(set(), lambda: run_clients(srv.port, jobs))
        worst = same_dets([r for rs, _ in out for r in rs], [r for rs, _ in twin for r in rs], "task serve kernels vs twins")
        with serving(src, **kw) as srv:
            run_clients(srv.port, [j[:2] for j in jobs])  # warm
            (out_b, wall_b), lb = counted(SERVE_PATH, lambda: run_clients(srv.port, jobs))
    n = sum(len(j) for j in jobs)
    log("task serve", card, f"segment and pose lanes, f32 kernels = twins on {n} requests ({sum(len(r) for rs, _ in out for r in rs)} "
        f"rows, max |diff| {worst:.3e}; launches {launches}, the twins' server {none}); obb lane out of service; bf16 {n} requests "
        f"from {len(jobs)} clients in {wall_b:.3f} s = {n / wall_b:.1f} frames/s; launches {lb}")


def task_tune_phase(root: Path, card):
    """`[task tune]`: YOLO("yolov8n-seg.yaml").tune(iterations=2, epochs=1) at 640 on a 32-frame polygon split
    (write_seg_split, its frames both the train and the val split): each iteration a fresh model trained one epoch in
    bf16 and validated with the segment validator (kernels 1, 2, 3 and 5); the fitness of both iterations, best.npz a
    segment checkpoint whose predict of 4 frames f32 through the kernels equals the twins' (1e-2 px, 1e-4)."""
    import csv

    import cv2
    import numpy as np

    from yolo_tpu_torch import YOLO

    write_seg_split(root, *TUNE_SET, split="train")
    data = write_seg_split(root, *TUNE_SET, split="val")
    t0 = time.perf_counter()
    best, launches = counted(SEG_PATH, lambda: YOLO("yolov8n-seg.yaml").tune(data=str(data), project=str(root / "runs"), **TUNE_RUN))
    wall = time.perf_counter() - t0
    tune_dir = root / "runs" / "tune"
    with open(tune_dir / "tune_results.csv") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != TUNE_RUN["iterations"] or not all(np.isfinite(float(r["fitness"])) for r in rows):
        raise AssertionError(f"task tune: rows {rows}")
    y = YOLO(str(tune_dir / "best.npz"))
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(4)]
    kw = dict(compute_dtype="float32", **SEG_PREDICT)
    rk = [result_rows(y.predict(f, **kw)[0]) for f in frames]
    rp = [result_rows(y.predict(f, plain=True, **kw)[0]) for f in frames]
    worst = same_dets(rk, rp, "task tune best.npz")
    if y.task != "segment":
        raise AssertionError(f"task tune: best.npz is a {y.task} checkpoint")
    log("task tune", card, f"yolov8n-seg, {len(rows)} iterations in {wall:.1f} s: fitness " + ", ".join(
        f"iter {r['iteration']} {float(r['fitness']):.4f}" for r in rows) + f"; best iteration {best['best_iteration']}; launches "
        f"{launches}; best.npz f32 kernels = twins on 4 frames ({sum(len(r) for r in rk)} rows, max |diff| {worst:.3e})")


VARIANT_RUNS = (  # (yaml, predict imgsz, kernels of its predict path)
    ("yolov8n-p6.yaml", 1280, {"c2f", "head_level", "nms_keep"}),  # the neck is C2: no fold, no kernel 2
    ("yolov8n-seg-p6.yaml", 1280, {"c2f", "head_level", "nms_keep"}),
    ("yolov8n-pose-p6.yaml", 1280, {"c2f", "head_level", "nms_keep"}),
    ("yolov8n-ghost-p2.yaml", (512, 640), {"head_level", "nms_keep"}),  # C3Ghost and GhostConv only: no C2f
    ("yolov8n-ghost.yaml", (512, 640), {"head_level", "nms_keep"}),
    ("yolov8n-cls-resnet50.yaml", 224, set()),  # ResNetLayer and Classify: plain torch convs, no kernel
)
HELD_VARIANTS = ("yolov8n-p6.yaml", "yolov8n-ghost-p2.yaml")  # kernels 1, 3 and 5 held at their new shapes


def variants_phase(frames, card):
    """`[variants]`: each v8 variant's init(0) tree (full width; nc 80, pose nc 1, classify nc 1000) at its predict
    size; a p6 model takes the frames upscaled to 1280x1024 first, outside the timing, as its users feed it frames
    of its size. The decoded forward of 2 letterboxed frames f32 through the kernels against the twins (boxes and
    keypoint x, y 1e-2 px, the rest 1e-4; a classify model's probabilities on the card against the CPU, 1e-5); at
    the p6 (1280²) and ghost-p2 (640x512) shapes, kernels 1, 3 and 5 held against their twins on 2 images of seeded
    uniform noise through the tree with its BN moments from them (`bn_calibrated`), each instance's twin depending
    on its input (`live`): the initial tree's activations fade through its depth, and on the clip's frames, mostly
    a uniform sky, moments from the frames leave most of each map near zero (0.11 of P3's head outputs at 1280² live on
    an H100); then bf16 `predict` of 8 frames one per call, timed, with the launches of that run."""
    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import params_from_jax

    for name, imgsz, path in VARIANT_RUNS:
        y = YOLO(name)
        h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
        sized = [cv2.resize(f, (1280, 1024)) for f in frames[:8]] if h == 1280 else frames[:8]
        if y.task == "classify":
            x = torch.from_numpy(np.stack([cv2.resize(f, (w, h)) for f in sized[:2]])).cuda().flip(-1).float() / 255.0
        elif (h, w) == sized[0].shape[:2]:  # the frame as the predictor feeds it at its own size: no letterbox
            x = torch.from_numpy(np.ascontiguousarray(sized[:2])).cuda().flip(-1).float() / 255.0
        else:
            x = torch.cat([letterboxed(f, h) for f in sized[:2]])
        params_from_jax(y.model, y.params, torch.float32)
        got, launches = counted(path - {"nms_keep"}, lambda: y.model.predict(x))
        if y.task == "classify":
            cpu = type(y.model)(name, device="cpu")
            params_from_jax(cpu, y.params, torch.float32)
            err = {"px": 0.0, "unit": float((got.cpu() - cpu.predict(x.cpu())).abs().max())}
            check_preds(f"variants {name}", err, unit=1e-5)
        else:
            err = task_preds_err(y.model, got, y.model.predict(x, plain=True))
            check_preds(f"variants {name}", err)
        if name in HELD_VARIANTS:
            noise = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)).cuda()
            params_from_jax(y.model, bn_calibrated(y.model, y.params, noise), torch.float32)  # predict reloads y.params
            hold_path_kernels([y.model], noise, f"variants {name}", card, conf=0.0, live=True)
        kw = {"imgsz": imgsz, **({"verbose": False} if y.task == "classify" else TASK_PREDICT)}
        y.predict(sized[0], **kw)  # warm: bf16
        y.predictor.timings = []
        t0 = time.perf_counter()
        res, lb = counted(path, lambda: [y.predict(f, **kw)[0] for f in sized])
        wall = time.perf_counter() - t0
        ts, y.predictor.timings = y.predictor.timings, None
        split = {k: sum(t[f"{k}_s"] for t in ts) / len(ts) * 1e3 for k in ("pre", "enqueue", "wait", "post")}
        what = f"top1 {[int(r.probs.top1) for r in res[:4]]}" if y.task == "classify" else f"{sum(len(r) for r in res)} detections"
        log("variants", card, f"{name} at {h}x{w} ({sized[0].shape[1]}x{sized[0].shape[0]} frames): {len(y.model.layers)} layers, strides {y.model.stride}; f32 kernels against twins "
            f"max |px| {err['px']:.3e}, |rest| {err['unit']:.3e} (launches {launches}); bf16 predict {len(sized) / wall:.1f} frames/s ({len(sized)} "
            f"frames, one per call; host ms/frame: letterbox + assembly {split['pre']:.2f}, enqueue {split['enqueue']:.2f}, wait "
            f"{split['wait']:.2f}, Results {split['post']:.2f}), {what}; launches {lb}")


def ghost_p2_pipeline_phase(clip, card):
    """`[pipeline ghost-p2]`: FusedDetectTrack with yolov8n-ghost-p2's init(0) tree (full width, nc 80) over the clip's
    first GHOST_P2_FRAMES frames, one chunk, conf 1e-6 (below every score of the untrained tree, whose features fade
    through its depth so that its scores sit at the bias prior: 16 detections a frame): f32 through the kernels (3 and
    5; the model has no C2f) against f32 through the twins: tracks, ids, statuses, detection counts and stats equal;
    then bf16 frames/s with its launches."""
    import torch

    from yolo_tpu_torch import FusedDetectTrack, YOLO

    y = YOLO("yolov8n-ghost-p2.yaml")
    sub = clip[:GHOST_P2_FRAMES]

    def pipe(dtype, plain):
        return FusedDetectTrack(y.model, y.params, frame_hw=HW, chunk=len(sub), conf=GHOST_P2_CONF, iou=0.6, n_max=64, d_max=16,
                                dtype=dtype, plain=plain)

    (ok_, sk, wk), launches = counted({"head_level", "nms_keep"}, lambda: timed_run(pipe(torch.float32, False), sub))
    op_, sp, wp = timed_run(pipe(torch.float32, True), sub)
    worst = compare_runs(ok_, op_, sk, sp)
    per_frame = [int(c) for o in ok_ for c in o["det_count"]]
    if sk["detection_frames"] <= 0 or min(per_frame) <= 0:
        raise AssertionError(f"pipeline ghost-p2: stats {sk}, frames without detections {per_frame.count(0)}")
    ft = pipe(torch.bfloat16, False)
    ft.run_clip(sub)  # warm-up
    ft.reset()
    (ob, sb, wb), lb = counted({"head_level", "nms_keep"}, lambda: timed_run(ft, sub))
    log("pipeline ghost-p2", card, f"f32 kernels {sk} in {wk:.2f} s = twins {sp} in {wp:.2f} s: tracks, ids, statuses, detection "
        f"counts and stats equal (max |box/conf/vel diff| {worst:.3e}); detections on every frame ({min(per_frame)}-{max(per_frame)} a "
        f"frame, {sum(per_frame)} in all); "
        f"launches {launches}; bf16 {len(sub)} frames in {wb:.3f} s = {len(sub) / wb:.1f} frames/s end to end; {sb}; launches {lb}")


def variants_train_phase(data, run_dir, card):
    """`[variants train]`: one epoch of YOLO("yolov8n-ghost-p2.yaml").train on the detect split at 640, batch 16,
    bf16 with the IR recipe, validating once (kernels 3 and 5): the losses, the metrics, the mean step (forward +
    loss, backward, optimizer in CUDA events) and the launches; then the trained tree's decoded forward of 2 val
    frames f32 through the head kernel against its twin (1e-2 px, 1e-4). The train step itself runs no kernel; it
    is held against JAX's on the CPU (tests/test_torch_v8_variants.py)."""
    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import params_from_jax

    epochs = []
    y = YOLO("yolov8n-ghost-p2.yaml")
    t0 = time.perf_counter()
    _, launches = counted({"head_level", "nms_keep"}, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                          project=str(run_dir), name="ghost_p2", exist_ok=True, **{**TRAIN_RECIPE, "epochs": 1}))
    wall = time.perf_counter() - t0
    e = epochs[-1]
    r, steps = e["row"], e["timings"][1:]
    if not all(np.isfinite(r[f"train/{k}_loss"]) for k in ("box", "cls", "dfl")) or not steps:
        raise AssertionError(f"variants train: {r}")
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    span = e["t_end"] - e["timings"][1]["start"]
    frames = sorted((Path(data).parent / "images" / "val").glob("*.png"))[:2]
    x = torch.cat([letterboxed(cv2.imread(str(f))) for f in frames])
    params_from_jax(y.model, y.params, torch.float32)
    got, lk = counted({"head_level"}, lambda: y.model.predict(x))
    err = task_preds_err(y.model, got, y.model.predict(x, plain=True))
    check_preds("variants train", err)
    log("variants train", card, f"yolov8n-ghost-p2, 1 epoch of {len(e['timings'])} steps at batch {TRAIN_RECIPE['batch']}, 640, "
        f"bf16: box {r['train/box_loss']:.4f} cls {r['train/cls_loss']:.4f} dfl {r['train/dfl_loss']:.4f}; mAP50 "
        f"{r['metrics/mAP50']:.4f}; a step {span / len(steps) * 1e3:.1f} ms (host clock, after the first): forward+loss "
        f"{mean['forward']:.2f}, backward {mean['backward']:.2f}, optimizer+BN+EMA {mean['optimizer']:.2f} ms (events), loader "
        f"wait {mean['loader']:.2f} ms; the .train call {wall:.1f} s; launches {launches}; the trained tree f32 kernel against "
        f"twin on 2 val frames max |px| {err['px']:.3e}, |rest| {err['unit']:.3e} (launches {lk})")


def slice17_phases(clip, root: Path, train_data, card):
    """The seventeenth slice's phases: the task entry points, then the v8 variants (about 150 s together)."""
    import numpy as np

    bgr = np.repeat(clip[:TASK_SERVE_FRAMES * 4], 3, -1)
    t0 = time.perf_counter()
    task_benchmark_phase(bgr, card)
    task_int8_phase(bgr[:TASK_INT8_FRAMES], card)
    task_tiled_phase(bgr[0], card)
    task_serve_phase(bgr, card)
    task_tune_phase(root / "task_tune", card)
    variants_phase(bgr, card)
    ghost_p2_pipeline_phase(clip, card)
    variants_train_phase(train_data, root / "runs", card)
    train_step_f32_phase(train_data, card, cfg_name="yolov8n-ghost-p2.yaml", tag="variants train step f32")
    print(f"[slice 17] its phases took {time.perf_counter() - t0:.1f} s")


SLICE18_FAMILIES = ("yolo11n.yaml", "yolo12n.yaml")
SLICE18_TASKS = tuple(f"yolo{v}n-{t}.yaml" for v in (11, 12) for t in ("seg", "pose", "obb", "cls"))
SLICE18_B1_FRAMES, SLICE18_B8_FRAMES = 8, 16  # `[yolo11]` / `[yolo12]`: bf16 predict one frame a call, then 8 a call
SLICE18_TRACK_FRAMES = 4  # cut to fit the run's time limit (PERF.md §4)
SLICE18_RUN = dict(epochs=1, workers=8, seed=0)  # `[yolo11 train]`: one epoch of the 64-frame split at TRAIN_RECIPE's batch 16


def calibrated_yolo(name, x):
    """YOLO(name) on the card holding its init(0) tree with every BN's moments taken from the NHWC images `x`
    (`bn_calibrated`): features near unit scale through the depth, so that a hold on them can fail."""
    from yolo_tpu_torch import YOLO

    y = YOLO(name)
    y.params = bn_calibrated(y.model, y.params, x)
    return y


def column_errors(model, got, want) -> dict:
    """|card − CPU| of a model's decoded predictions by column group → {group: (largest difference, largest |value|)}:
    `px` the boxes and pose keypoints' x, y, `score` the class scores, `rest` the coefficients, visibilities or angles,
    `protos` a segment model's prototypes, `probs` a classify model's probabilities."""
    import torch

    if model.task == "classify":
        return {"probs": (float((got.float() - want.float()).abs().max()), 1.0)}
    if isinstance(got, tuple):
        out = column_errors(model, got[0], want[0])
        if not torch.isfinite(got[1]).all():
            raise AssertionError("non-finite prototypes")
        out["protos"] = (float((got[1].float() - want[1].float()).abs().max()), float(want[1].float().abs().max()))
        return out
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"predictions {tuple(got.shape)} vs {tuple(want.shape)}, finite {bool(torch.isfinite(got).all())}")
    if getattr(model, "end2end", False):
        return end2end_errors(got, want)
    g, w, nc = got.float(), want.float(), model.nc
    groups = {"px": [slice(0, 4)], "score": [slice(4, 4 + nc)], "rest": []}
    if model.task == "pose":
        K, nd = model.head.kpt_shape
        idx = torch.arange(4 + nc, g.shape[1], device=g.device)
        groups["px"].append(idx[(idx - 4 - nc) % nd < 2])
        groups["rest"].append(idx[(idx - 4 - nc) % nd >= 2])
    elif g.shape[1] > 4 + nc:
        groups["rest"].append(slice(4 + nc, g.shape[1]))
    out = {}
    for k, parts in groups.items():
        if parts:
            d = torch.cat([(g[:, p] - w[:, p]).abs().flatten() for p in parts])
            out[k] = (float(d.max()), float(torch.cat([w[:, p].abs().flatten() for p in parts]).max()))
    return out


END2END_ROWS = 100  # `end2end_errors`: the reference's best rows of each image that are paired and held


def end2end_errors(got, want) -> dict:
    """|got − want| of an end-to-end head's (B, k, 6) rows (xyxy box, score, class; ranked by score): each of the
    reference's END2END_ROWS best rows of an image paired with the nearest row of `got` of its class (two near-equal
    scores may rank either way, and a row near the k-th may drop out of the other's k) → {"px": (largest box difference,
    largest |coordinate|), "score": (largest score difference, 1)}; a row without a partner of its class raises."""
    import torch

    px = sc = 0.0
    for g, w in zip(got.float(), want.float()):
        for row in w[:END2END_ROWS]:
            same = g[g[:, 5] == row[5]]
            if not len(same):
                raise AssertionError(f"end-to-end rows: class {int(row[5])} (score {float(row[4]):.4f}) has no partner")
            j = int((same[:, :4] - row[:4]).abs().sum(-1).argmin())
            px, sc = max(px, float((same[j, :4] - row[:4]).abs().max())), max(sc, float((same[j, 4] - row[4]).abs()))
    return {"px": (px, float(want[..., :4].abs().max())), "score": (sc, 1.0)}


# `card_against_f64`: the least gate of each group, by the group's largest |value| m: boxes 1e-2 px, scores 1e-4,
# probabilities 1e-5, the rest 1e-4 of m (at least 1e-4; the module gate of tests/test_torch_v8_variants.py)
F64_FLOOR = {"px": lambda m: 1e-2, "score": lambda m: 1e-4, "rest": lambda m: 1e-4 * max(m, 1.0),
             "protos": lambda m: 1e-4 * max(m, 1.0), "probs": lambda m: 1e-5}


def card_against_f64(y, x, tag, path) -> dict:
    """`y`'s decoded f32 forward of `x` on the card through the kernels of `path` (an empty path: every layer walked
    in torch) against the same tree's f64 forward (the twins, on the card), with the same tree's f32 forward on the
    CPU as the yardstick of f32 rounding through this depth: each `column_errors` group of the card within 4x the
    CPU's distance from the f64 forward, and F64_FLOOR at least. A calibrated tree amplifies f32 rounding through its
    depth (yolov9t at 640²: 0.34 px in boxes between an H100 and the CPU, both f32), so a fixed gate on two f32 runs
    can fail where neither is wrong. RT-DETR's CPU and f64 decoders take the card's selected anchors (`selection_check`
    holds the selection on its own): the rows of the same queries in one order, which a near-tie at the nq-th encoder
    score would otherwise change, moving every row through the self-attention (`query_errors`) → {group: (card's
    distance, CPU's distance)}."""
    import copy

    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    params_from_jax(y.model, y.params, torch.float32)
    got, _ = counted(path, lambda: y.model.predict(x))
    cpu = type(y.model)(y.model.yaml, device="cpu")
    if hasattr(y.model, "prompts"):  # a World or YOLOE model: the card's class prompts (the f64 copy keeps them)
        cpu._set_prompts(y.model.prompts)
    params_from_jax(cpu, y.params, torch.float32)
    m64 = copy.deepcopy(y.model).double()
    params_from_jax(m64, y.params, torch.float64)
    if getattr(y.model, "is_rtdetr", False):
        ind = rtdetr_selection(y.model, x, plain=False)[1]
        with torch.no_grad():
            ref = cpu.head(cpu._walk(x.cpu(), True)[0], ind=ind.cpu()).cuda()
            exact = m64.head(m64._walk(x.double(), True)[0], ind=ind)
        del m64
        ek, er = query_errors(got, exact, x.shape[1:3]), query_errors(ref, exact, x.shape[1:3])
    else:
        ref = cpu.predict(x.cpu())
        ref = tuple(t.cuda() for t in ref) if isinstance(ref, tuple) else ref.cuda()
        exact = m64.predict(x.double(), plain=True)
        del m64
        ek, er = column_errors(y.model, got, exact), column_errors(y.model, ref, exact)
    bad = {k: (e, er[k][0]) for k, (e, m) in ek.items() if e > max(4 * er[k][0], F64_FLOOR[k](m))}
    if bad:
        raise AssertionError(f"{tag}: card farther from the f64 forward than 4x the CPU's f32 (card, CPU): {bad}")
    return {k: (e, er[k][0]) for k, (e, _) in ek.items()}


def without_cls_prior(model, tree) -> dict:
    """`tree` with the head's class-logit biases (Detect.bias_init's prior, log(5 / nc / (640 / stride)²): -11 to -13
    at nc 80) set to zero: a head level held at TOL (1e-3 of |logit| besides 1e-3) then measures the logits' part that
    depends on the input, which a calibrated yolov9e head leaves small beside the prior (its P3 twin's live share
    0.34 with the prior at 640², an H100; 0.90 without it)."""
    import numpy as np

    head = str(len(model.layers) - 1)
    cv3 = {l: {**branch, "2": {**branch["2"], "bias": np.zeros_like(np.asarray(branch["2"]["bias"]))}}
           for l, branch in tree["model"][head]["cv3"].items()}
    return {**tree, "model": {**tree["model"], head: {**tree["model"][head], "cv3": cv3}}}


def hold_nms(tag, boxes, scores, conf=0.0, iou=0.7, max_nms=1024, live=True) -> dict:
    """Kernel 5 against its twin on the K = max_nms candidates of these decoded predictions, as the predictor forms
    them: the keep mask bit for bit, and with `live` the share of slots whose flag the boxes decide (`live_share`: the
    slots that the twin suppresses, which boxes set to zero would all keep) above 0, or the hold could not fail."""
    import torch

    from yolo_tpu_torch.ops import cuda_nms

    cand, top = nms_candidates(boxes, scores, conf, max_nms)
    got, want = cuda_nms.nms_keep(cand, top, iou), cuda_nms.nms_keep_plain(cand, top, iou)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"nms_keep {tag}: keep mask differs from the plain twin in {int((got != want).sum())} slots")
    share = live_share("nms_keep", cuda_nms.nms_keep_plain, (cand, top, iou), want) if live else None
    if live and share <= 0:
        raise AssertionError(f"nms_keep {tag}: no slot's flag depends on the boxes: the hold could not fail")
    return {"B": cand.shape[0], "K": cand.shape[1], "kept": int(got.sum()), "valid": int((top > 0).sum()), "live": share}


def device_launches(run) -> tuple:
    """`run()` under torch.profiler (the device only) → (its result, the device's kernels, copies and sets, their
    summed time in ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    return out, sum(e.count for e in on_card), sum(dev(e) for e in on_card) / 1e3


def host_split(timings) -> str:
    n = sum(t["n"] for t in timings)
    return ", ".join(f"{k} {sum(t[f'{k}_s'] for t in timings) / n * 1e3:.2f}" for k in ("pre", "enqueue", "wait", "post"))


def family_phase(name, frames, card):
    """`[yolo11]` / `[yolo12]`: YOLO("yolo11n.yaml") or YOLO("yolo12n.yaml") at full width (nc 80) with its init(0) tree
    calibrated on two seeded noise images (`bn_calibrated`): the decoded forward of those images f32 on the card
    against the f64 forward (`card_against_f64`; kernels 1-4 launch no time), kernel 5 against its twin on those
    scores (K = 1024 at conf 0, `hold_nms`); then bf16 `predict` of the clip's frames, one a call and 8 a call (each
    frame's ten best; kernel 5 launched), frames/s with the host's ms a frame, and the device's launches and busy
    time over one call of each size (torch.profiler); then `track` of 16 frames (ByteTrack), launching kernel 5 → the YOLO."""
    import torch

    tag = name.split("n.")[0]
    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y = calibrated_yolo(name, noise)
    err = card_against_f64(y, noise, tag, set())
    nms = hold_nms(tag, *y.model.predict_parts(noise))
    kw = dict(TASK_PREDICT)
    rates = []
    for B, n in ((1, SLICE18_B1_FRAMES), (8, SLICE18_B8_FRAMES)):
        sub = list(frames[:n])
        y.predict(sub[:B], batch=B, **kw)  # warm: bf16 weights and this batch's plans
        y.predictor.timings = []
        t0 = time.perf_counter()
        res, lb = counted({"nms_keep"}, lambda: y.predict(sub, batch=B, **kw))
        wall = time.perf_counter() - t0
        ts, y.predictor.timings = y.predictor.timings, None
        _, kernels, busy = device_launches(lambda: y.predict(sub[:B], batch=B, **kw))
        if len(res) != n or not all(len(r) for r in res):
            raise AssertionError(f"{tag}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rates.append(f"B={B}: {n / wall:.1f} frames/s ({n} frames; host ms a frame: {host_split(ts)}); one call: {kernels} "
                     f"device launches = {kernels / B:.0f} a frame, {busy:.3f} ms busy; nms_keep {lb['nms_keep']} in the run")
    _, lt = counted({"nms_keep"}, lambda: [y.track(f, persist=True, tracker="bytetrack.yaml", **kw) for f in frames[:SLICE18_TRACK_FRAMES]])
    log(tag, card, f"{name}: {len(y.model.layers)} layers, strides {y.model.stride}; f32 on 2 noise images at 640² "
        f"against the f64 forward (card / CPU): " + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items())
        + f"; nms_keep B={nms['B']} K={nms['K']} kept "
        f"{nms['kept']} of {nms['valid']} bit for bit, live share {nms['live']:.3f}; bf16 predict " + "; ".join(rates)
        + f"; track (ByteTrack, {SLICE18_TRACK_FRAMES} frames) nms_keep {lt['nms_keep']}")
    return y


def family_tasks_phase(frames, seg_data, pose_data, card):
    """`[yolo11 tasks]`: the seg, pose, obb and cls yamls of both families at full width (nc 80, pose 1, obb 15, cls
    1000), init(0) calibrated on 8 seeded noise images (224² for classify): the decoded forward at B = 8 f32 on the
    card against the f64 forward (`card_against_f64`); for the seg and pose
    models kernel 5 against its twin on those predictions (`hold_nms`), then `predict` of 4 frames, `val` of the
    task's 64-frame held-out split and `track` of 16 frames (ByteTrack), each launching kernel 5 (each frame's ten
    best); the obb models predict with the rotated NMS in plain torch: no kernel launches."""
    import torch

    rows = []
    for name in SLICE18_TASKS:
        size = 224 if name.endswith("-cls.yaml") else 640
        noise = torch.rand((8, size, size, 3), generator=torch.Generator().manual_seed(1)).cuda()
        y = calibrated_yolo(name, noise)
        err = card_against_f64(y, noise[:1], f"yolo11 tasks {name}", set())  # one image: the time limit
        what = f"{name} max |diff| " + " ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in err.items())
        if y.task in ("segment", "pose"):
            nms = hold_nms(name, *y.model.predict_parts(noise))
            data = seg_data if y.task == "segment" else pose_data
            kw = dict(TASK_PREDICT)
            _, lp = counted({"nms_keep"}, lambda: y.predict(list(frames[:4]), **kw))
            metrics, lv = counted({"nms_keep"}, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
            _, lt = counted({"nms_keep"}, lambda: [y.track(f, persist=True, tracker="bytetrack.yaml", **kw) for f in frames[:SLICE18_TRACK_FRAMES]])
            if not all(map(math.isfinite, metrics.values())):
                raise AssertionError(f"yolo11 tasks {name}: val {metrics}")
            what += (f", nms_keep K={nms['K']} kept {nms['kept']} bit for bit (live {nms['live']:.3f}); nms_keep launches: "
                     f"predict {lp['nms_keep']}, val {lv['nms_keep']}, track {lt['nms_keep']}")
        elif y.task == "obb":
            _, lp = counted(set(), lambda: y.predict(list(frames[:4]), **TASK_PREDICT))
        rows.append(what)
    log("yolo11 tasks", card, "f32 B=8 against the f64 forward (card / CPU): " + "; ".join(rows))


def family_train_phase(name, data, run_dir, card, path=frozenset({"nms_keep"})):
    """`[yolo11 train]` / `[yolo12 train]` (and the later families'): one epoch of YOLO(name).train on the 64-frame
    detect split at 640, batch 16, bf16 with the IR recipe, validating once (the path's kernels): every loss item finite
    (yolov10's six: box, cls, dfl of each branch), the mean step (forward + loss, backward,
    optimizer in CUDA events); then `val` of the trained tree f32 through kernel 5 against its twin (every key within
    1e-4). The train step itself runs no kernel; `[yolo11 train step f32]` holds it against the CPU. The model comes from
    the facade its name routes to (`facade_for`: YOLOWorld and YOLOE fine-tune close-set, the data's names embedded)."""
    import numpy as np

    from yolo_tpu_torch.engine.model import facade_for

    tag = name.split("n.")[0] + " train"
    epochs = []
    y = facade_for(name)(name)
    t0 = time.perf_counter()
    _, launches = counted(path, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data), project=str(run_dir),
                                                name=tag.replace(" ", "_"), exist_ok=True, **{**TRAIN_RECIPE, **SLICE18_RUN}))
    wall = time.perf_counter() - t0
    e = epochs[-1]
    r, steps = e["row"], e["timings"][1:]
    items = {k[len("train/"): -len("_loss")]: v for k, v in r.items() if k.startswith("train/") and k.endswith("_loss")}
    if len(items) < 3 or not all(np.isfinite(v) for v in items.values()) or not steps:
        raise AssertionError(f"{tag}: {r}")
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    span = e["t_end"] - e["timings"][1]["start"]
    rk, lk = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    if set(rk) != set(rp) or max(abs(rk[k] - rp[k]) for k in rk) > 1e-4:
        raise AssertionError(f"{tag}: val kernels {rk} vs twins {rp}")
    log(tag, card, f"{name}, 1 epoch of {len(e['timings'])} steps at batch {TRAIN_RECIPE['batch']}, 640, bf16: "
        + " ".join(f"{k} {v:.4f}" for k, v in items.items()) + f"; a step {span / len(steps) * 1e3:.1f} "
        f"ms (host clock, after the first): forward+loss {mean['forward']:.2f}, backward {mean['backward']:.2f}, "
        f"optimizer+BN+EMA {mean['optimizer']:.2f} ms (events), loader wait {mean['loader']:.2f} ms; the .train call "
        f"{wall:.1f} s; launches {launches}; f32 val through the path's kernels = twins (mAP50 {rk['mAP50']:.4f}; launches {lk})")


def slice18_phases(clip, train_data, seg_data, pose_data, root: Path, card):
    """The eighteenth slice's phases: yolo11n and yolo12n, their task models, their training (about 40 s on an H100)."""
    import numpy as np

    bgr = np.repeat(clip[: max(SLICE18_B8_FRAMES, SLICE18_TRACK_FRAMES)], 3, -1)
    t0 = time.perf_counter()
    for name in SLICE18_FAMILIES:
        family_phase(name, bgr, card)
    family_tasks_phase(bgr, seg_data, pose_data, card)
    for name in SLICE18_FAMILIES:
        family_train_phase(name, train_data, root / "runs", card)
    # yolo12n's f32 step is not held here: two f32 runs of it cannot agree within TRAIN_STEP_TOL on the gradient of its
    # stem's BN bias, a sum over 1.6M terms that cancel (card against CPU 2.8e-3 of its largest; each 0.7-1.6e-3 from
    # the same step in f64: `train_step_precision_phase`, `--profile`). tests/test_torch_yolo11_12.py holds it against
    # JAX at 128².
    train_step_f32_phase(train_data, card, cfg_name="yolo11n.yaml", tag="yolo11 train step f32")
    print(f"[slice 18] its phases took {time.perf_counter() - t0:.1f} s")


SLICE19_FAMILIES = ("yolov9t.yaml", "yolov9c.yaml", "yolov3.yaml", "yolov3-tiny.yaml", "yolov6n.yaml", "yolo_nas_s.yaml")
SLICE19_OTHERS = ("yolov3-spp.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9e.yaml", "yolov6s.yaml", "yolov6m.yaml",
                  "yolov6l.yaml", "yolov6x.yaml", "yolo_nas_m.yaml", "yolo_nas_l.yaml", "yolov9c-seg.yaml", "yolov9e-seg.yaml")
SLICE19_B1_FRAMES, SLICE19_B8_FRAMES, SLICE19_OTHER_FRAMES = 4, 8, 1  # `[v3 v6 v9 nas]`: bf16 predict a frame a call, 8 a call
SLICE19_TRACK_FRAMES = 2  # cut to fit the run's time limit (PERF.md §4)
SLICE19_PIPELINE_FRAMES = 64  # `[pipeline v9 head_cm]`, `[pipeline nas]`: one chunk of 64 frames


def slice19_path(y) -> set:
    """The kernels a predict of `y` launches: the head kernel (3) where its head is legacy and SiLU (yolov3, yolov9),
    none of 1-4 for a ReLU head (yolov6, YOLO-NAS: walked conv by conv); the NMS kernel (5) always."""
    return {"head_level", "nms_keep"} if y.model.head.kernel_branches else {"nms_keep"}


def slice19_family_phase(name, frames, data, card):
    """`[v3 v6 v9 nas]` for one model: YOLO(name) at full width (nc 80) with its init(0) tree calibrated on two seeded
    noise images at 640² (`bn_calibrated`): the decoded f32 forward through the kernels against the f64 twins
    (`card_against_f64`), kernels 3 and 5 against their twins on those images with live inputs (`hold_path_kernels` on
    the tree `without_cls_prior`: each head level's twin depends on its input; a ReLU head has none to hold); then bf16 `predict` of the clip's frames, one a call and 8 a
    call (each frame's ten best), frames/s with the host's ms a frame and the device's launches and busy time over one
    call; `val` of the held-out split (bf16, batch 16) and `track` (ByteTrack; the init(0) tree), each launching the
    path's kernels."""
    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    tag = "v3 v6 v9 nas"
    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y = calibrated_yolo(name, noise)
    path = slice19_path(y)
    err = card_against_f64(y, noise, f"{tag} {name}", path - {"nms_keep"})
    params_from_jax(y.model, without_cls_prior(y.model, y.params), torch.float32)
    held = hold_path_kernels([y.model], noise, f"{tag} {name}", card, conf=0.0, iou=0.7, live=True)
    kw = dict(TASK_PREDICT)
    rates = []
    for B, n in ((1, SLICE19_B1_FRAMES), (8, SLICE19_B8_FRAMES)):
        sub = list(frames[:n])
        y.predict(sub[:B], batch=B, **kw)  # warm: bf16 weights and this batch's plans
        y.predictor.timings = []
        t0 = time.perf_counter()
        res, lb = counted(path, lambda: y.predict(sub, batch=B, **kw))
        wall = time.perf_counter() - t0
        ts, y.predictor.timings = y.predictor.timings, None
        _, kernels, busy = device_launches(lambda: y.predict(sub[:B], batch=B, **kw))
        if len(res) != n or not all(len(r) for r in res):
            raise AssertionError(f"{name}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rates.append(f"B={B}: {n / wall:.1f} frames/s (host ms a frame: {host_split(ts)}); one call {kernels} device launches "
                     f"({kernels / B:.0f} a frame), {busy:.3f} ms busy; launches {lb}")
    metrics, lv = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{name}: val {metrics}")
    from yolo_tpu_torch import YOLO

    yt = YOLO(name)  # the init(0) tree: a calibrated one predicts boxes of zero height in the padding, which ByteTrack
    # (the JAX package's too) turns into NaN costs
    _, lt = counted(path, lambda: [yt.track(f, persist=True, tracker="bytetrack.yaml", **kw) for f in frames[:SLICE19_TRACK_FRAMES]])
    log(tag, card, f"{name}: {len(y.model.layers)} layers, strides {y.model.stride}, head kernel "
        f"{'yes' if 'head_level' in path else 'no (ReLU head, walked)'}; f32 on 2 noise images at 640² against the f64 "
        f"forward (card / CPU, both f32): " + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items())
        + f" (held: {held}); bf16 predict " + "; ".join(rates)
        + f"; val mAP50 {metrics['mAP50']:.4f} (launches {lv}); track {SLICE19_TRACK_FRAMES} frames (launches {lt})")


def slice19_models_phase(frames, card):
    """`[v3 v6 v9 nas others]`: the other published scales and graphs at full width (yolov3-spp, yolov9s / m / e, yolov6s
    to x, yolo_nas_m / l, yolov9c-seg / e-seg; init(0) calibrated on two noise images at 640²): kernels 3 and 5 against
    their twins with live inputs (on the tree `without_cls_prior`), then bf16 `predict` of 4 frames one a call with the path's launches."""
    import torch

    from yolo_tpu_torch.nn.tasks import param_count, params_from_jax

    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    rows = []
    for name in SLICE19_OTHERS:
        t0 = time.perf_counter()
        y = calibrated_yolo(name, noise)
        path = slice19_path(y)
        params_from_jax(y.model, without_cls_prior(y.model, y.params), torch.float32)
        held = hold_path_kernels([y.model], noise, f"v3 v6 v9 nas others {name}", card, conf=0.0, iou=0.7, live=True)
        sub = list(frames[:SLICE19_OTHER_FRAMES])
        y.predict(sub[:1], **TASK_PREDICT)
        t1 = time.perf_counter()
        res, lp = counted(path, lambda: y.predict(sub, **TASK_PREDICT))
        rate = len(sub) / (time.perf_counter() - t1)
        if len(res) != len(sub) or not all(len(r) for r in res):
            raise AssertionError(f"{name}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rows.append(f"{name} ({len(y.model.layers)} layers, {param_count(y.params):,} values): held {held}; "
                    f"bf16 predict {rate:.1f} frames/s, launches {lp}; {time.perf_counter() - t0:.1f} s")
    log("v3 v6 v9 nas others", card, "; ".join(rows))


def slice19_pipeline_phase(clip, card):
    """`[pipeline v9 head_cm]`: FusedDetectTrack(pallas_head2=True) with yolov9t's init(0) tree over the clip's first
    64 frames at conf 1e-6 (its scores sit at the bias prior: 16 detections a frame), f32 kernels 4 and 5 against the
    twins (tracks, ids, statuses, counts, stats equal), then bf16 frames/s with its launches; kernel 4 against its twin
    at yolov9t's three levels on a calibrated tree with live inputs. `[pipeline nas]`: yolo_nas_s's ReLU head walks its
    convs (kernels 1-4 launch no time, kernel 5 does) and `pallas_head2=True` refuses it."""
    import torch

    from yolo_tpu_torch import FusedDetectTrack, YOLO
    from yolo_tpu_torch.ops import cuda_head_cm

    sub = clip[:SLICE19_PIPELINE_FRAMES]
    for name, head_cm in (("yolov9t.yaml", True), ("yolo_nas_s.yaml", False)):
        y = YOLO(name)
        tag = "pipeline v9 head_cm" if head_cm else "pipeline nas"
        path = {"head_level_cm", "nms_keep"} if head_cm else {"nms_keep"}

        def pipe(dtype, plain, y=y, head_cm=head_cm):
            return FusedDetectTrack(y.model, y.params, frame_hw=HW, chunk=len(sub), conf=GHOST_P2_CONF, iou=0.6, n_max=64, d_max=16,
                                    dtype=dtype, plain=plain, pallas_head2=head_cm)

        (ok_, sk, wk), launches = counted(path, lambda: timed_run(pipe(torch.float32, False), sub))
        op_, sp, wp = timed_run(pipe(torch.float32, True), sub)
        worst = compare_runs(ok_, op_, sk, sp)
        per_frame = [int(c) for o in ok_ for c in o["det_count"]]
        if min(per_frame) <= 0:
            raise AssertionError(f"{tag}: frames without detections {per_frame.count(0)}")
        ft = pipe(torch.bfloat16, False)
        ft.run_clip(sub)  # warm-up
        ft.reset()
        (ob, sb, wb), lb = counted(path, lambda: timed_run(ft, sub))
        extra = ""
        if head_cm:
            noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(3)).cuda()
            cal = calibrated_yolo(name, noise)
            from yolo_tpu_torch.nn.tasks import params_from_jax

            params_from_jax(cal.model, cal.params, torch.float32)
            rec, _, _ = capture_instances(cal.model, noise)
            errs, shares = [], []
            for _, args in rec:
                got, want = cuda_head_cm.head_level_cm(*args), cuda_head_cm.head_level_cm_plain(*args)
                torch.cuda.synchronize()
                errs.append(max(hold("head_level_cm", f"{tag} {tuple(args[0].shape)}", "float32", got, want).values()))
                # the scores are probabilities near the prior: their logits (as kernel 3 gives them) carry the input's part
                as_logits = lambda *a: (lambda d, c: (d, _logit(c)))(*cuda_head_cm.head_level_cm_plain(*a))  # noqa: E731
                shares.append(live_share("head_level_cm", as_logits, args, as_logits(*args)))
                if shares[-1] < LIVE_SHARE:
                    raise AssertionError(f"{tag}: only {shares[-1]:.3f} of kernel 4's twin outputs depend on its input")
            extra = (f"; kernel 4 on the calibrated tree's {len(rec)} levels within atol = rtol = 1e-3 of its twin (max |err| "
                     f"{max(errs):.3e}), live share (dist and the scores' logits) at least {min(shares):.3f}")
        else:
            try:
                pipe(torch.bfloat16, False, head_cm=True)
            except NotImplementedError as e:
                extra = f"; pallas_head2=True refuses it: {e}"
            else:
                raise AssertionError(f"{tag}: pallas_head2=True took a ReLU head")
        log(tag, card, f"{name}: f32 kernels {sk} in {wk:.2f} s = twins {sp} in {wp:.2f} s (tracks, ids, statuses, counts, "
            f"stats equal, max |box/conf/vel diff| {worst:.3e}; {sum(per_frame)} detections); launches {launches}; bf16 "
            f"{len(sub)} frames in {wb:.3f} s = {len(sub) / wb:.1f} frames/s end to end; {sb}; launches {lb}" + extra)


def slice19_phases(clip, train_data, root: Path, card):
    """The nineteenth slice's phases: yolov3, yolov6, YOLO-NAS and yolov9 at full width (predict, val, track, the
    pipeline), the other scales, and one epoch of yolov9t and yolo_nas_s."""
    import numpy as np

    bgr = np.repeat(clip[: max(SLICE19_B8_FRAMES, SLICE19_TRACK_FRAMES)], 3, -1)
    t0 = time.perf_counter()
    for name in SLICE19_FAMILIES:
        slice19_family_phase(name, bgr, train_data, card)
    slice19_models_phase(bgr, card)
    slice19_pipeline_phase(clip, card)
    family_train_phase("yolov9t.yaml", train_data, root / "runs", card, path={"head_level", "nms_keep"})
    family_train_phase("yolo_nas_s.yaml", train_data, root / "runs", card, path={"nms_keep"})
    print(f"[slice 19] its phases took {time.perf_counter() - t0:.1f} s")


V8_SCALES = [(f"yolov8{s}.yaml", None) for s in "smlx"] + [("yolov8-small.yaml", s) for s in "mlx"]  # `[v8 scales]`
V8_SCALE_FRAMES = 2  # cut to fit the run's time limit (PERF.md §4)
V10_FAMILIES = ("yolov10n.yaml", "yolov10s.yaml")  # `[v10]`: predict, val and track
V10_OTHERS = ("yolov10m.yaml", "yolov10b.yaml", "yolov10l.yaml", "yolov10x.yaml")  # `[v10]`: predict 4 frames
V10_B1_FRAMES, V10_B8_FRAMES, V10_OTHER_FRAMES, V10_TRACK_FRAMES = 8, 16, 2, 4  # cut to fit the run's time limit (PERF.md §4)
V10_PATH = {"c2f", "c2f_upconcat"}  # every v10 model folds its layer 16 (and 13 at n-m) and keeps plain C2f rows; no NMS


def scaled_yolo(cfg, scale, x):
    """YOLO(cfg) at `scale` (a scale of the yaml's `scales`; None: the one the name picks) on the card, its init(0)
    tree calibrated on the NHWC images `x` (`bn_calibrated`)."""
    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import DetectionModel, yaml_model_load

    y = YOLO(cfg)
    if scale:
        d = yaml_model_load(cfg)
        d["scale"] = scale
        y.model = DetectionModel(d)
        y.overrides["model"] = f"{cfg} (scale {scale})"
    y.params = bn_calibrated(y.model, y.model.init(0), x)
    return y


def v8_scales_phase(frames, card):
    """`[v8 scales]`: yolov8 s-x (640²) and the repo's yolov8-small at m-x (640x512 frames), whose wide C2f blocks take
    the kernel's general plan (N chunks, split passes): each at full width (nc 80 / 1), init(0) calibrated on two seeded
    noise images (`bn_calibrated`), the decoded f32 forward through kernels 1, 2 and 3 against the f64 forward
    (`card_against_f64`), kernels 1-3 against their twins there with the live gate (`hold_path_kernels`, on the tree
    `without_cls_prior`), then bf16 `predict` of 4 frames at 640 (each frame's ten best), launching kernels 1, 2, 3 and 5."""
    import torch

    from yolo_tpu_torch.nn.tasks import param_count, params_from_jax

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    rows = []
    for cfg, scale in V8_SCALES:
        t0 = time.perf_counter()
        h, w = (512, 640) if cfg == "yolov8-small.yaml" else (640, 640)
        noise = torch.rand((2, h, w, 3), generator=torch.Generator().manual_seed(0)).cuda()
        y = scaled_yolo(cfg, scale, noise)
        err = card_against_f64(y, noise[:1], f"v8 scales {cfg} {scale or ''}", path - {"nms_keep"})  # one image: the time limit
        params_from_jax(y.model, without_cls_prior(y.model, y.params), torch.float32)
        held = hold_path_kernels([y.model], noise, f"v8 scales {cfg} {scale or ''}", card, conf=0.0, iou=0.7, live=True)
        sub = [f[:h, :w] for f in frames[:V8_SCALE_FRAMES]]
        y.predict(sub[:1], **TASK_PREDICT)
        t1 = time.perf_counter()
        res, lp = counted(path, lambda: y.predict(sub, **TASK_PREDICT))
        rate = len(sub) / (time.perf_counter() - t1)
        if len(res) != len(sub) or not all(len(r) for r in res):
            raise AssertionError(f"{cfg} {scale}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rows.append(f"{cfg}{' ' + scale if scale else ''} ({param_count(y.params):,} values, {len(y.model.c2f_instances(h, w))} "
                    f"C2f instances): f32 against f64 (card / CPU) " + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items())
                    + f"; held {held}; bf16 predict {rate:.1f} frames/s, launches {lp}; {time.perf_counter() - t0:.1f} s")
    log("v8 scales", card, "; ".join(rows))


def v10_phase(name, frames, data, card):
    """`[v10]` for yolov10n / s: YOLO(name) at full width (nc 80), init(0) calibrated on two seeded noise images at 640²:
    the end-to-end (B, 300, 6) rows of the f32 forward through kernels 1 and 2 against the f64 forward's
    (`card_against_f64`, rows paired by class and box), kernels 1 and 2 against their twins with the live gate (no NMS:
    the head is NMS-free, and kernels 3-5 launch no time on any v10 path); then bf16 `predict` of the clip's frames one
    a call and 8 a call (each frame's ten best), frames/s with the host's ms a frame and the device's launches and busy
    time over one call; `val` of the held-out split (bf16, batch 16) and `track` (ByteTrack, the init(0) tree)."""
    import torch

    from yolo_tpu_torch import YOLO

    tag = "v10"
    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y = calibrated_yolo(name, noise)
    err = card_against_f64(y, noise, f"{tag} {name}", V10_PATH)
    held = hold_path_kernels([y.model], noise, f"{tag} {name}", card, live=True, nms=False)
    kw = dict(TASK_PREDICT)
    rates = []
    for B, n in ((1, V10_B1_FRAMES), (8, V10_B8_FRAMES)):
        sub = list(frames[:n])
        y.predict(sub[:B], batch=B, **kw)  # warm: bf16 weights and this batch's plans
        y.predictor.timings = []
        t0 = time.perf_counter()
        res, lb = counted(V10_PATH, lambda: y.predict(sub, batch=B, **kw))
        wall = time.perf_counter() - t0
        ts, y.predictor.timings = y.predictor.timings, None
        _, kernels, busy = device_launches(lambda: y.predict(sub[:B], batch=B, **kw))
        if len(res) != n or not all(len(r) for r in res) or not all((r.boxes.conf <= 1).all() and (r.boxes.cls < 80).all() for r in res):
            raise AssertionError(f"{name}: {len(res)} results, {sum(not len(r) for r in res)} without detections, or rows out of range")
        rates.append(f"B={B}: {n / wall:.1f} frames/s (host ms a frame: {host_split(ts)}); one call {kernels} device launches "
                     f"({kernels / B:.0f} a frame), {busy:.3f} ms busy; launches {lb}")
    metrics, lv = counted(V10_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{name}: val {metrics}")
    yt = YOLO(name)
    _, lt = counted(V10_PATH, lambda: [yt.track(f, persist=True, tracker="bytetrack.yaml", **kw) for f in frames[:V10_TRACK_FRAMES]])
    log(tag, card, f"{name}: {len(y.model.layers)} layers, strides {y.model.stride}, NMS-free; f32 rows on 2 noise images at "
        f"640² against the f64 forward's (card / CPU, both f32): " + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items())
        + f" (held: {held}); bf16 predict " + "; ".join(rates)
        + f"; val mAP50 {metrics['mAP50']:.4f} (launches {lv}); track {V10_TRACK_FRAMES} frames (launches {lt})")


def v10_models_phase(frames, card):
    """`[v10 others]`: yolov10 m, b, l and x at full width (init(0) calibrated on two noise images at 640², their wide
    C2f blocks on the kernel's general plan): the rows of the f32 forward against the f64 forward's, kernels 1 and 2
    against their twins with the live gate, then bf16 `predict` of 4 frames one a call with the path's launches."""
    import torch

    from yolo_tpu_torch.nn.tasks import param_count

    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    rows = []
    for name in V10_OTHERS:
        t0 = time.perf_counter()
        y = calibrated_yolo(name, noise)
        err = card_against_f64(y, noise[:1], f"v10 others {name}", V10_PATH)  # one image: the time limit
        held = hold_path_kernels([y.model], noise, f"v10 others {name}", card, live=True, nms=False)
        sub = list(frames[:V10_OTHER_FRAMES])
        y.predict(sub[:1], **TASK_PREDICT)
        t1 = time.perf_counter()
        res, lp = counted(V10_PATH, lambda: y.predict(sub, **TASK_PREDICT))
        rate = len(sub) / (time.perf_counter() - t1)
        if len(res) != len(sub) or not all(len(r) for r in res):
            raise AssertionError(f"{name}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rows.append(f"{name} ({len(y.model.layers)} layers, {param_count(y.params):,} values): rows against f64 (card / CPU) "
                    + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items()) + f"; held {held}; bf16 predict "
                    f"{rate:.1f} frames/s, launches {lp}; {time.perf_counter() - t0:.1f} s")
    log("v10 others", card, "; ".join(rows))


def slice20_phases(clip, train_data, root: Path, card):
    """The twentieth slice's phases: the yolov8 / yolov8-small scales that the widened C2f kernel takes, yolov10 at every
    scale (predict, val, track), and one epoch of yolov10n. `[c2f widths]` runs with the other kernel holds."""
    import numpy as np

    bgr = np.repeat(clip[: max(V10_B8_FRAMES, V10_TRACK_FRAMES, V8_SCALE_FRAMES)], 3, -1)
    t0 = time.perf_counter()
    v8_scales_phase(bgr, card)
    for name in V10_FAMILIES:
        v10_phase(name, bgr, train_data, card)
    v10_models_phase(bgr, card)
    family_train_phase("yolov10n.yaml", train_data, root / "runs", card, path=V10_PATH)
    print(f"[slice 20] its phases took {time.perf_counter() - t0:.1f} s")

# `[rtdetr]` / `[rtdetr others]`: rtdetr-l predicts 16 frames one a call and 32 eight a call, validates and tracks 8;
# rtdetr-x, -resnet50, -resnet101 and yolov8l-rtdetr predict 4 (the slice's ~300 s budget)
RTDETR_B1_FRAMES, RTDETR_B8_FRAMES, RTDETR_TRACK_FRAMES, RTDETR_OTHER_FRAMES = 8, 16, 4, 2  # cut to fit the run's time limit (PERF.md §4)
RTDETR_OTHERS = ("rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml", "yolov8l-rtdetr.yaml")
RTDETR_V8_PATH = {"c2f", "c2f_upconcat"}  # yolov8-rtdetr's C2f rows and folded necks; HGNetV2 / ResNet reach no kernel


def rtdetr_path(name) -> set:
    return RTDETR_V8_PATH if name.startswith("yolov8") else set()


def awake_decoder(model, tree, seed=0, scale=0.02):
    """`tree` with every float leaf of the RT-DETR decoder but its BN moments moved by seeded N(0, `scale`): at init(0)
    its box heads give zero deltas, its attention weights are zero (a uniform softmax) and its sampling offsets do not
    depend on the query, so the boxes are the selected anchors and a hold could not see the decoder's box refinement
    or its query-dependent sampling (the CPU tests' `_awake` moves it the same way)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def move(node, key=""):
        if isinstance(node, dict):
            return {k: move(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.kind != "f" or key in ("running_mean", "running_var"):
            return a
        return (a + rng.normal(0, scale, a.shape)).astype(a.dtype)

    head = str(len(model.layers) - 1)
    return {**tree, "model": {**tree["model"], head: move(tree["model"][head])}}


def calibrated_rtdetr(name, x):
    """YOLO(name) on the card holding its init(0) tree with the decoder awake (`awake_decoder`) and every BN's
    moments then taken from the NHWC images `x` (`bn_calibrated`)."""
    from yolo_tpu_torch import YOLO

    y = YOLO(name)
    if not getattr(y.model, "is_rtdetr", False):
        raise AssertionError(f"{name}: built {type(y.model).__name__}")
    y.params = bn_calibrated(y.model, awake_decoder(y.model, y.params), x)
    return y


def query_errors(got, want, hw) -> dict:
    """|got − want| of two RT-DETR forwards' (B, nq, 4 + nc) query rows of the same selected anchors, row by row →
    {"px": (largest xyxy difference in px of an H x W image, largest |coordinate|), "score": (largest class-score
    difference, 1)}."""
    import torch

    from yolo_tpu_torch.ops.nms import query_boxes

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"query rows {tuple(got.shape)} vs {tuple(want.shape)}, finite {bool(torch.isfinite(got).all())}")
    gb, wb = query_boxes(got, hw).double(), query_boxes(want, hw).double()
    return {"px": (float((gb - wb).abs().max()), float(wb.abs().max())),
            "score": (float((got[..., 4:].double() - want[..., 4:].double()).abs().max()), 1.0)}


def rtdetr_selection(model, x, plain=True):
    """The query selection of `model`'s forward of `x` (f32 or f64, as loaded; `plain=False`: yolov8-rtdetr's C2f
    rows through the kernels, as predict walks) → (encoder scores (B, ΣHW), the selected anchors (B, nq))."""
    import torch

    with torch.no_grad():
        xs, _ = model._walk(x, plain=plain)
        feats, shapes = model.head.encode(xs, False)
        _, _, enc, ind = model.head.select(feats, shapes, False)
    return enc.max(-1).values, ind


def selection_check(y, x, tag) -> str:
    """The card's f32 selection of `x` against the f64 forward's, image by image: where the nq-th gap of the f64
    scores exceeds twice the two forwards' largest encoder-score difference the selected sets must be equal (else the
    phase fails); below that the anchors that differ are a near-tie and are printed → a line with the anchors that
    differ, the gaps and that difference."""
    import copy

    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    params_from_jax(y.model, y.params, torch.float32)
    s32, i32 = rtdetr_selection(y.model, x)
    m64 = copy.deepcopy(y.model).double()
    params_from_jax(m64, y.params, torch.float64)
    s64, i64 = rtdetr_selection(m64, x.double())
    del m64
    nq = i32.shape[1]
    noise = float((s32.double() - s64).abs().max())
    ranked = torch.sort(s64, -1, descending=True).values
    gap = (ranked[:, nq - 1] - ranked[:, nq]).tolist()
    moved = [len(set(a.tolist()) - set(b.tolist())) for a, b in zip(i32, i64)]
    defect = [m and g > 2 * noise for m, g in zip(moved, gap)]  # a gap over 2x every score's difference fixes the set
    if any(defect):
        raise AssertionError(f"{tag}: the f32 selection differs from the f64 forward's in {moved} anchors where its nq-th "
                             f"gap {gap} exceeds twice the largest encoder-score difference {noise:.3e}")
    return (f"selected sets: {moved} anchors of {nq} differ from the f64 forward's (a near-tie where any: nq-th gap "
            + ", ".join(f"{g:.3e}" for g in gap) + f", largest encoder-score difference {noise:.3e})")


def grid_sample_share(y, x) -> str:
    """The device's time in one decoder forward of `x` (torch.profiler, the device only) and the share of it in the
    bilinear grid samples (`grid_sampler_2d` kernels) → a line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        xs, _ = y.model._walk(x, plain=False)
        y.model.head(xs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y.model.head(xs)
            torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    total = sum(dev(e) for e in on_card)
    grid = sum(dev(e) for e in on_card if "grid_sampler" in e.key)
    n = sum(e.count for e in on_card)
    if not total:
        return "decoder: the profiler saw no device time"
    return (f"decoder at B = {x.shape[0]}: {total / 1e3:.3f} ms on the device over {n} launches, the grid samples "
            f"{grid / 1e3:.3f} ms ({grid / total:.1%})")


def rtdetr_phase(frames, data, card):
    """`[rtdetr]`: rtdetr-l at full width (nc 80), init(0) with the decoder awake, calibrated on two seeded noise images
    at 640² (`calibrated_rtdetr`): the f32 rows against the f64 forward's (`card_against_f64`: the rows paired by class and box
    as yolov10's) and the f32 selection's sets against the f64 forward's (`selection_check`); bf16 and f32 predict of
    the clip's frames one a call and 8 a call (each frame's ten best; no NMS, no kernel: HGNetV2 and the decoder are
    torch), frames/s with the host's ms a frame and the device's launches and busy time over one call; the share of
    the decoder's device time in the grid samples; `val` of the held-out split (bf16, batch 16) and `track` (ByteTrack,
    the init(0) tree)."""
    import torch

    from yolo_tpu_torch import RTDETR
    from yolo_tpu_torch.nn.tasks import params_from_jax

    tag, name = "rtdetr", "rtdetr-l.yaml"
    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y = calibrated_rtdetr(name, noise)
    err = card_against_f64(y, noise, f"{tag} {name}", set())
    sel = selection_check(y, noise, f"{tag} {name}")
    rates = []
    for half in (True, False):
        kw = dict(TASK_PREDICT, compute_dtype=compute_dtype(half), half=half)
        for B, n in ((1, RTDETR_B1_FRAMES), (8, RTDETR_B8_FRAMES)):
            sub = list(frames[:n])
            y.predict(sub[:B], batch=B, **kw)  # warm: the weights in this dtype, this batch's shapes
            y.predictor.timings = []
            t0 = time.perf_counter()
            res, lb = counted(set(), lambda: y.predict(sub, batch=B, **kw))
            wall = time.perf_counter() - t0
            ts, y.predictor.timings = y.predictor.timings, None
            _, kernels, busy = device_launches(lambda: y.predict(sub[:B], batch=B, **kw))
            if len(res) != n or not all(len(r) == 10 and (r.boxes.conf <= 1).all() and (r.boxes.cls < 80).all() for r in res):
                raise AssertionError(f"{name}: {len(res)} results, or rows out of range")
            rates.append(f"{'bf16' if half else 'f32'} B={B}: {n / wall:.1f} frames/s (host ms a frame: {host_split(ts)}); "
                         f"one call {kernels} device launches ({kernels / B:.0f} a frame), {busy:.3f} ms busy; launches {lb}")
    params_from_jax(y.model, y.params, torch.bfloat16)
    share = {B: grid_sample_share(y, torch.from_numpy(frames[:B].copy()).cuda().flip(-1).to(torch.bfloat16) / 255.0) for B in (1, 8)}
    metrics, lv = counted(set(), lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{name}: val {metrics}")
    yt = RTDETR(name)
    _, lt = counted(set(), lambda: [yt.track(f, persist=True, tracker="bytetrack.yaml", **TASK_PREDICT) for f in frames[:RTDETR_TRACK_FRAMES]])
    log(tag, card, f"{name}: {len(y.model.layers)} layers, strides {y.model.stride}, NMS-free, {y.model.head.nq} queries; f32 rows "
        f"on 2 noise images at 640² against the f64 forward's (card / CPU, both f32): "
        + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items()) + f"; {sel}; predict " + "; ".join(rates)
        + f"; {share[1]}; {share[8]}; val mAP50 {metrics['mAP50']:.4f} (launches {lv}); track "
        f"{RTDETR_TRACK_FRAMES} frames (launches {lt})")


def rtdetr_models_phase(frames, card):
    """`[rtdetr others]`: rtdetr-x, -resnet50, -resnet101 (no kernel on their paths) and yolov8l-rtdetr (its C2f rows
    and two folded necks through kernels 1 and 2) at full width, init(0) with the decoder awake, calibrated on two
    noise images at 640² (`calibrated_rtdetr`): the
    f32 rows against the f64 forward's, the selection's sets; yolov8l-rtdetr's kernels 1 and 2 against their twins
    with the live gate (`hold_path_kernels`, no NMS); bf16 `predict` of 4 frames one a call, each path's launches
    (`counted`: c2f and c2f_upconcat above 0 on yolov8l-rtdetr, every kernel 0 on the others; head_level,
    head_level_cm and nms_keep 0 on all)."""
    import torch

    from yolo_tpu_torch.nn.tasks import param_count

    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    rows = []
    for name in RTDETR_OTHERS:
        t0 = time.perf_counter()
        path = rtdetr_path(name)
        y = calibrated_rtdetr(name, noise)
        err = card_against_f64(y, noise[:1], f"rtdetr others {name}", path)  # one image: the time limit
        sel = selection_check(y, noise, f"rtdetr others {name}")
        held = hold_path_kernels([y.model], noise, f"rtdetr others {name}", card, live=True, nms=False) if path else {}
        sub = list(frames[:RTDETR_OTHER_FRAMES])
        y.predict(sub[:1], **TASK_PREDICT)
        t1 = time.perf_counter()
        res, lp = counted(path, lambda: y.predict(sub, **TASK_PREDICT))
        rate = len(sub) / (time.perf_counter() - t1)
        if len(res) != len(sub) or not all(len(r) == 10 for r in res):
            raise AssertionError(f"{name}: {len(res)} results, {sum(len(r) != 10 for r in res)} without ten rows")
        rows.append(f"{name} ({len(y.model.layers)} layers, {param_count(y.params):,} values): rows against f64 (card / CPU) "
                    + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items()) + f"; {sel}; held {held or 'no kernel on this path'}; "
                    f"bf16 predict {rate:.1f} frames/s, launches {lp}; {time.perf_counter() - t0:.1f} s")
    log("rtdetr others", card, "; ".join(rows))


def rtdetr_train_phase(data, run_dir, card):
    """`[rtdetr-l.yaml train]`: one bf16 epoch of rtdetr-l on the 64-frame detect split at 640, batch 16, with the
    IR recipe (the bf16 check skipped, as the JAX trainer's fails on RT-DETR and keeps bf16): the three loss items
    (giou, cls, l1) finite, the step's split (forward + loss, backward, optimizer in CUDA events; the host's
    Hungarian match, its wait for the forward included, on the host clock), then `val` of the trained tree (f32)."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.utils import detr_loss

    tag, name = "rtdetr-l.yaml train", "rtdetr-l.yaml"
    epochs, spent = [], {}
    time_calls(detr_loss, "hungarian_match", spent)
    y = YOLO(name)
    t0 = time.perf_counter()
    _, launches = counted(set(), lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data), project=str(run_dir),
                                                 name="rtdetr_train", exist_ok=True, **{**TRAIN_RECIPE, **SLICE18_RUN}))
    wall = time.perf_counter() - t0
    e = epochs[-1]
    r, steps = e["row"], e["timings"][1:]
    items = {k[len("train/"): -len("_loss")]: v for k, v in r.items() if k.startswith("train/") and k.endswith("_loss")}
    if set(items) != {"giou", "cls", "l1"} or not all(np.isfinite(v) for v in items.values()) or not steps:
        raise AssertionError(f"{tag}: {r}")
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    span = e["t_end"] - e["timings"][1]["start"]
    n_steps = len(e["timings"])
    match_ms = spent["hungarian_match"] / max(n_steps, 1) * 1e3
    metrics, lv = counted(set(), lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{tag}: val {metrics}")
    log(tag, card, f"{name}, 1 epoch of {n_steps} steps at batch {TRAIN_RECIPE['batch']}, 640, bf16: "
        + " ".join(f"{k} {v:.4f}" for k, v in items.items()) + f"; a step {span / len(steps) * 1e3:.1f} ms (host clock, "
        f"after the first): forward+loss {mean['forward']:.2f} (of which the host's Hungarian match, seven layers, "
        f"{match_ms:.2f} ms a step on the host clock), backward {mean['backward']:.2f}, optimizer+BN+EMA "
        f"{mean['optimizer']:.2f} ms (events), loader wait {mean['loader']:.2f} ms; the .train call {wall:.1f} s; launches "
        f"{launches}; f32 val mAP50 {metrics['mAP50']:.4f} (launches {lv})")


def resnet18_cls_phase(frames, root: Path, card):
    """`[yolo11-cls-resnet18]`: yolo11-cls-resnet18 (a torchvision ResNet-18 built in place, nc 1000, JAX's init(0)
    tree): f32 and bf16 `predict` of the clip's frames at 224, one a call (top-1 equal between them on most frames,
    probabilities finite), frames/s; then one bf16 epoch on `[classify]`'s folder dataset (`root`, 4 classes) at
    CLS_RUN's batch 8, its loss and top-1. No kernel on its path (the backbone is plain torch convs)."""
    import numpy as np

    from yolo_tpu_torch import YOLO

    name = "yolo11-cls-resnet18.yaml"
    y = YOLO(name)
    if (y.task, y.model.nc, type(y.model.layers[0]).__name__) != ("classify", 1000, "TorchVision"):
        raise AssertionError(f"{name}: task {y.task}, nc {y.model.nc}, layer 0 {type(y.model.layers[0]).__name__}")
    sub = list(frames[:RTDETR_B1_FRAMES])
    out = {}
    for half in (False, True):
        kw = dict(imgsz=224, half=half, compute_dtype=compute_dtype(half), verbose=False)
        y.predict(sub[0], **kw)
        t0 = time.perf_counter()
        res, _ = counted(set(), lambda: [y.predict(f, **kw)[0].probs.data for f in sub])
        out[half] = (res, len(sub) / (time.perf_counter() - t0))
        if not all(np.isfinite(p).all() and p.shape == (1000,) for p in res):
            raise AssertionError(f"{name}: probabilities not finite or not (1000,)")
    same = sum(int(a.argmax() == b.argmax()) for a, b in zip(out[False][0], out[True][0]))
    yt = YOLO(name)
    t0 = time.perf_counter()
    metrics, lt = counted(set(), lambda: yt.train(data=str(root), project=str(root / "runs"), name="resnet18",
                                                  **{**CLS_RUN, "epochs": 1}))
    wall = time.perf_counter() - t0
    losses = yt.trainer.losses
    if not all(np.isfinite(losses)) or yt.model.nc != len(CLS_SHAPES):
        raise AssertionError(f"{name} train: losses {losses}, metrics {metrics}, nc {yt.model.nc}")
    log("yolo11-cls-resnet18", card, f"{name}: predict at 224, one a call: f32 {out[False][1]:.1f}, bf16 {out[True][1]:.1f} "
        f"frames/s, top-1 equal on {same}/{len(sub)}; 1 epoch of {CLS_TRAIN[0]} images at batch {CLS_RUN['batch']}, bf16: "
        f"loss {losses[-1]:.4f}, top1 {metrics['top1']:.4f}, {CLS_TRAIN[0] / wall:.1f} images/s over the .train call; "
        f"launches {lt} (no kernel)")


def slice21_phases(clip, train_data, cls_root: Path, root: Path, card):
    """The twenty-first slice's phases: RT-DETR (rtdetr-l predict, val, track; rtdetr-x, -resnet50, -resnet101 and
    yolov8l-rtdetr predict, the last through kernels 1-2; one epoch of rtdetr-l) and yolo11-cls-resnet18 (predict,
    one epoch on `[classify]`'s images)."""
    import numpy as np

    bgr = np.repeat(clip[: max(RTDETR_B8_FRAMES, RTDETR_TRACK_FRAMES, RTDETR_OTHER_FRAMES)], 3, -1)
    t0 = time.perf_counter()
    rtdetr_phase(bgr, train_data, card)
    rtdetr_models_phase(bgr, card)
    rtdetr_train_phase(train_data, root / "runs", card)
    resnet18_cls_phase(bgr, cls_root, card)
    print(f"[slice 21] its phases took {time.perf_counter() - t0:.1f} s")


# `[world]` / `[yoloe]`: the YOLO-World and YOLOE configurations at 640², nc 80 (the text tower's embeddings of
# OV_PROMPTS class names), each with the kernels of its predict path (a YOLOE segment model predicts through
# `YOLOEModel.predict`, which takes no NMS: its predictor is refused, as JAX's fails)
OPEN_VOCAB = (
    ("yolov8s-worldv2.yaml", {"c2f", "nms_keep"}),
    ("yolov8s-world.yaml", {"c2f", "nms_keep"}),
    ("yoloe-v8s.yaml", {"c2f", "c2f_upconcat", "nms_keep"}),
    ("yoloe-v8s-seg.yaml", {"c2f", "c2f_upconcat"}),
    ("yoloe-11s.yaml", {"nms_keep"}),
)
OV_PROMPTS = 80
OV_B1_FRAMES, OV_B8_FRAMES, OV_TRACK_FRAMES = 8, 16, 4
OV_SIZE = 640  # the noise images of the holds
OV_LRPC_CONF = 0.5  # the proposal filter's threshold: sigmoid(0), the contrastive bias of `awake_contrastive`, so that about half pass
OV_TRAIN = ("yolov8s-worldv2.yaml", "yoloe-v8s.yaml")  # one close-set epoch each


def awake_contrastive(model, tree) -> dict:
    """`tree` with the contrastive heads' biases (JAX's init: -10) at 0. At -10 every score of a World or YOLOE model
    sits near sigmoid(-10) = 4.5e-05, under the score group's F64_FLOOR of 1e-4, so a hold of the scores could not see
    the class branch; at 0 they spread about 0.5, where the sigmoid is steepest."""
    import numpy as np

    hi = str(len(model.layers) - 1)
    head = dict(tree["model"][hi])
    head["cv4"] = {l: {**p, "bias": np.zeros_like(p["bias"])} for l, p in head["cv4"].items()}
    return {**tree, "model": {**tree["model"], hi: head}}


def visual_masks(B, Q, h, w):
    """(B, Q, h, w) f32 prompt masks on the P3 grid: Q seeded rectangles an image."""
    import torch

    g = torch.Generator().manual_seed(3)
    vp = torch.zeros((B, Q, h, w))
    for b in range(B):
        for q in range(Q):
            y0, x0 = (int(v) for v in torch.randint(0, h - 12, (2,), generator=g))
            dy, dx = (int(v) for v in torch.randint(4, 12, (2,), generator=g))
            vp[b, q, y0 : y0 + dy, x0 : x0 + dx] = 1.0
    return vp.cuda()


def prompt_errors(model, fn, tag) -> tuple:
    """`fn(model, dtype)` (prompt embeddings of a World or YOLOE model; in f64 through the twins) f32 on the card and on
    the CPU against its f64 on the card → (card's largest difference, CPU's); the card within 4x the CPU's and 1e-5 at
    least."""
    import copy

    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    tree = model.held[0]
    params_from_jax(model, tree, torch.float32)
    got = fn(model, torch.float32)
    cpu = type(model)(model.yaml, device="cpu")
    cpu._set_prompts(model.prompts)
    params_from_jax(cpu, tree, torch.float32)
    ref = fn(cpu, torch.float32).cuda()
    m64 = copy.deepcopy(model).double()
    params_from_jax(m64, tree, torch.float64)
    exact = fn(m64, torch.float64)
    ek, er = float((got.double() - exact).abs().max()), float((ref.double() - exact).abs().max())
    if ek > max(4 * er, 1e-5):
        raise AssertionError(f"{tag}: card {ek:.3e} from the f64 prompts, CPU {er:.3e}")
    return ek, er


def lrpc_against_f64(y, tree, x, conf, tag, path) -> dict:
    """`predict_lrpc` of the `set_vocab` tree `tree` (the fused vocabulary and proposal filter) f32 on the card through
    the kernels of `path` against its f64 forward, with the CPU's f32 as the yardstick (as `card_against_f64`): the
    keep masks equal to the f64 forward's but for at most 0.1% of the anchors, and the predictions of the anchors all
    three keep within 4x the CPU's distance (F64_FLOOR at least) → ({group: (card, CPU)}, the flags that differ, the
    anchors the f64 forward keeps)."""
    import copy

    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    model = y.model
    params_from_jax(model, tree, torch.float32)
    (got, gk), _ = counted(path, lambda: model.predict_lrpc(x, conf=conf))
    cpu = type(model)(model.yaml, device="cpu")
    cpu.nc = cpu.head.nc = model.nc
    params_from_jax(cpu, tree, torch.float32)
    ref, rk = (t.cuda() for t in cpu.predict_lrpc(x.cpu(), conf=conf))
    m64 = copy.deepcopy(model).double()
    params_from_jax(m64, tree, torch.float64)
    exact, ek = m64.predict_lrpc(x.double(), conf=conf, plain=True)
    del m64
    flips = int((gk != ek).sum())
    if flips > 1e-3 * ek.numel() or not ek.any() or ek.all():
        raise AssertionError(f"{tag}: {flips} of {ek.numel()} keep flags differ from the f64 forward's (kept {int(ek.sum())})")
    both = (gk & ek & rk)[:, None, :].expand_as(exact)
    sel = lambda t: torch.where(both, t.double(), 0.0)  # noqa: E731 (the anchors all three keep)
    errs = column_errors(model, sel(got), sel(exact))
    base = column_errors(model, sel(ref), sel(exact))
    bad = {k: (e, base[k][0]) for k, (e, m) in errs.items() if e > max(4 * base[k][0], F64_FLOOR[k](m))}
    if bad:
        raise AssertionError(f"{tag}: card farther from the f64 forward than 4x the CPU's f32 (card, CPU): {bad}")
    return {k: (e, base[k][0]) for k, (e, _) in errs.items()}, flips, int(ek.sum())


def predict_rates(y, frames, path, tag) -> list:
    """bf16 predict of the frames one a call and 8 a call (each frame's ten best) → per batch size: frames/s (host
    clock), the host's ms a frame, the device's launches and busy ms over one call, the path's launches. A YOLOE
    segment model, whose predictor is refused, predicts through `YOLOEModel.predict` on letterboxed frames."""
    import torch

    from yolo_tpu_torch.nn.tasks import params_from_jax

    rates = []
    for B, n in ((1, OV_B1_FRAMES), (8, OV_B8_FRAMES)):
        sub = list(frames[:n])
        if getattr(y.model, "segment", False):
            params_from_jax(y.model, y.params, torch.bfloat16)
            batches = [torch.cat([letterboxed(f) for f in sub[i : i + B]]).bfloat16() for i in range(0, n, B)]
            y.model.predict(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, lb = counted(path, lambda: [torch.isfinite(y.model.predict(b)[0]).all().item() for b in batches])
            wall = time.perf_counter() - t0
            _, kernels, busy = device_launches(lambda: y.model.predict(batches[0]))
            if not all(res):
                raise AssertionError(f"{tag}: non-finite predictions")
            rates.append(f"B={B}: {n / wall:.1f} frames/s (YOLOEModel.predict, no NMS); one call {kernels} device launches, "
                         f"{busy:.3f} ms busy; launches {lb}")
            continue
        y.predict(sub[:B], batch=B, **TASK_PREDICT)  # warm: bf16 weights and this batch's plans
        y.predictor.timings = []
        t0 = time.perf_counter()
        res, lb = counted(path, lambda: y.predict(sub, batch=B, **TASK_PREDICT))
        wall = time.perf_counter() - t0
        ts, y.predictor.timings = y.predictor.timings, None
        _, kernels, busy = device_launches(lambda: y.predict(sub[:B], batch=B, **TASK_PREDICT))
        if len(res) != n or not all(len(r) for r in res) or not all((r.boxes.cls < y.model.nc).all() for r in res):
            raise AssertionError(f"{tag}: {len(res)} results, {sum(not len(r) for r in res)} without detections")
        rates.append(f"B={B}: {n / wall:.1f} frames/s (host ms a frame: {host_split(ts)}); one call {kernels} device "
                     f"launches ({kernels / B:.0f} a frame), {busy:.3f} ms busy; launches {lb}")
    return rates


def open_vocab_phase(name, path, tower, names, frames, data, card):
    """`[world]` / `[yoloe]` for one configuration: YOLOWorld / YOLOE(name) at full width on the card, its init(0) tree
    calibrated on two seeded OV_SIZE² noise images (`bn_calibrated`, the placeholder prompts) and its contrastive
    biases at 0 (`awake_contrastive`: scores about 0.5, not 4.5e-05), then the text tower's
    embeddings of OV_PROMPTS names as its classes (YOLOE: through the head's SwiGLU residual): the decoded f32 forward
    through the path's kernels against the f64 forward (`card_against_f64`); kernels 1, 2 and 5 against their twins
    with the live gate (K = 1024 at conf 0; no head kernel: the class branch ends in a 512-wide embedding and a
    contrastive product); bf16 predict rates at B = 1 and 8. YOLOE also: the visual prompts (SAVPE on three masks an
    image, held against f64) as the classes, the forward held again; the prompt-free path (`set_vocab` of 20 names,
    `predict_lrpc` at OV_LRPC_CONF: `lrpc_against_f64`). yoloe-v8s also validates the held-out split (bf16) and tracks
    OV_TRACK_FRAMES frames (ByteTrack). Every run counts its launches (`counted`: head_level and head_level_cm 0)."""
    import torch

    from yolo_tpu_torch.engine.model import facade_for

    tag = "world" if "world" in name else "yoloe"
    t0 = time.perf_counter()
    noise = torch.rand((2, OV_SIZE, OV_SIZE, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y = facade_for(name)(name)
    y.params = awake_contrastive(y.model, bn_calibrated(y.model, y.params, noise))
    y.set_text_features(tower.encode_text(names).float().cpu().numpy()[None], names=names)
    fwd = path - {"nms_keep"}
    err = card_against_f64(y, noise, f"{tag} {name} text", fwd)
    what = [f"{name} ({len(y.model.layers)} layers, nc {y.model.nc}): text prompts f32 against f64 (card / CPU) "
            + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items())]
    held = hold_path_kernels([y.model], noise, f"{tag} {name}", card, conf=0.0, iou=0.7, live=True, nms="nms_keep" in path)
    what.append("held " + ", ".join(f"{k} {v:.2e}" for k, v in held.items()))
    what.append("bf16 predict " + "; ".join(predict_rates(y, frames, path, f"{tag} {name}")))
    if name == "yoloe-v8s.yaml":
        metrics, lv = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
        if not all(map(math.isfinite, metrics.values())):
            raise AssertionError(f"{tag} {name}: val {metrics}")
        y.predictor = None
        _, lt = counted(path, lambda: [y.track(f, persist=True, tracker="bytetrack.yaml", **TASK_PREDICT) for f in frames[:OV_TRACK_FRAMES]])
        what.append(f"val mAP50 {metrics['mAP50']:.4f} (launches {lv}); track {OV_TRACK_FRAMES} frames (launches {lt})")
    if tag == "yoloe":
        vp = visual_masks(2, 3, OV_SIZE // 8, OV_SIZE // 8)
        ve = prompt_errors(y.model, lambda m, dt: m.get_visual_pe(noise.to(m.device, dt), vp.to(m.device, dt), plain=dt == torch.float64),
                           f"{tag} {name} vpe")
        y.model.set_visual_pe(y.model.get_visual_pe(noise, vp).cpu().numpy())
        err = card_against_f64(y, noise, f"{tag} {name} visual", fwd)
        what.append(f"visual prompts (2 x 3 masks): embeddings card / CPU {ve[0]:.3e} / {ve[1]:.3e} from f64, forward "
                    + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items()))
        tree = y.model.set_vocab(y.params, names[:20], text_model=tower)
        err, flips, kept = lrpc_against_f64(y, tree, noise, OV_LRPC_CONF, f"{tag} {name} lrpc", fwd)
        what.append(f"prompt-free (20 names, conf {OV_LRPC_CONF:.3g}): {kept} of {2 * 8400 * OV_SIZE ** 2 // 640 ** 2} anchors kept, "
                    f"{flips} flags from f64's, "
                    + ", ".join(f"|{k}| {a:.3e} / {b:.3e}" for k, (a, b) in err.items()))
    log(tag, card, "; ".join(what) + f"; {time.perf_counter() - t0:.1f} s")


def text_tower_phase(card):
    """`[text tower]`: `build_text_model()` (the seeded ViT-B/32 text tower: 12 layers, width 512, context 77,
    vocabulary 49408) on the card: the features of OV_PROMPTS class names f32 against the CPU's (1e-4), the host's
    tokenizing ms and the device's forward ms for the 80 → (the tower, the names)."""
    import torch

    from yolo_tpu_torch.nn.text_model import build_text_model

    t0 = time.perf_counter()
    tower, cpu = build_text_model(), build_text_model(device="cpu")
    built = time.perf_counter() - t0
    names = [f"object class number {i}" for i in range(OV_PROMPTS)]
    t1 = time.perf_counter()
    ids = torch.as_tensor(tower.tokenize(names)).long()
    tok_ms = (time.perf_counter() - t1) * 1e3
    ids = ids.cuda()
    got = tower.encode_text(names)
    ms_dev = cuda_ms(lambda: tower.encoder.encode_text(tower.weights, ids), iters=10)
    t1 = time.perf_counter()
    tower.encode_text(names)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t1) * 1e3
    diff = float((got.cpu() - cpu.encode_text(names)).abs().max())
    if diff > 1e-4 or got.shape != (OV_PROMPTS, 512):
        raise AssertionError(f"text tower: card against CPU {diff:.3e}, shape {tuple(got.shape)}")
    log("text tower", card, f"{OV_PROMPTS} prompts: tokenize {tok_ms:.2f} ms (host), forward {ms_dev:.3f} ms (events), "
        f"encode_text {call_ms:.2f} ms (host clock, the call); f32 card against CPU {diff:.3e}; the two towers built in "
        f"{built:.1f} s (numpy draws)")
    return tower, names


def slice22_phases(clip, train_data, root: Path, card):
    """The twenty-second slice's phases: the text tower, then the five YOLO-World / YOLOE configurations (`[world]`,
    `[yoloe]`), then one close-set epoch of yolov8s-worldv2 and of yoloe-v8s."""
    import numpy as np

    bgr = np.repeat(clip[: max(OV_B8_FRAMES, OV_TRACK_FRAMES)], 3, -1)
    t0 = time.perf_counter()
    tower, names = text_tower_phase(card)
    for name, path in OPEN_VOCAB:
        open_vocab_phase(name, path, tower, names, bgr, train_data, card)
    for name in OV_TRAIN:
        family_train_phase(name, train_data, root / "runs", card, path=dict(OPEN_VOCAB)[name])
    print(f"[slice 22] its phases took {time.perf_counter() - t0:.1f} s")


SAM_COUNTS = {"sam_b": 93_735_728, "sam_l": 312_343_088, "sam_h": 641_090_864, "mobile_sam": 9_818_564,
              "sam2_t": 38_962_737, "sam2_s": 46_060_593, "sam2_b": 80_850_417}  # the JAX package's SAM(k).info() at 1024
SAM_VARIANTS = ("sam_l", "sam_h", "sam2_s", "sam2_b")
SAM_POINT, SAM_BOX = [[320, 256]], [[200, 150, 460, 380]]  # prompts on a 640x512 frame
SAM2_FRAMES, SAM2_REVERSE = 8, 4  # `[sam2]`'s propagation: clip frames at 1024², then frames tracked backward
SIGN_AGREE = 0.999
FASTSAM = ("FastSAM-s.yaml", "FastSAM-x.yaml")
FASTSAM_FRAMES = 8
FASTSAM_PATH = frozenset({"c2f", "c2f_upconcat", "head_level", "nms_keep"})
FASTSAM_PROMPTS = {"everything": {}, "bbox": dict(bboxes=[[200, 150, 460, 380]]), "point": dict(points=[[320, 256]], labels=[1]),  # moved per frame
                   "text": dict(texts=["a bright aircraft", "cloudy sky"])}
FASTSAM_PREDICT = dict(conf=0.0, max_det=10, imgsz=640, verbose=False)  # each frame's ten best (a calibrated init(0) tree)
CLIP_CROPS = 16


def awake_sam(model) -> None:
    """Wake an init(0) SAM in place: SAM1's hypernetwork output biases N(0, 2) (at init(0) every mask logit is
    negative); SAM2's background position table N(0, 0.3) and object-score bias +3 (at init(0) every frame reads "no
    object" and its masks sit at -1024). Seeded, so that each phase holds masks with both signs."""
    import torch

    from yolo_tpu_torch.models.sam.sam2 import SAM2Model

    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if isinstance(model, SAM2Model):
            pe = model.trunk.pos_embed
            pe.copy_(torch.randn(pe.shape, generator=g) * 0.3)
            model.sam_mask_decoder.pred_obj_score_head.layers[2].bias.add_(3.0)
            return
        for m in model.mask_decoder.output_hypernetworks_mlps:
            b = m.layers[2].bias
            b.copy_(torch.randn(b.shape, generator=g) * 2.0)


def sam_outputs(model, bgr, prompts):
    """One frame through a SAM predictor on `model`'s device → (embedding, [(low-res logits, IoU) per prompt set]); the
    prompts in the frame's pixels, each (points, labels, boxes, multimask)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.models.sam.predict import SAMPredictor

    pred = SAMPredictor(model).set_image(bgr)
    dev, s = pred.device, pred._scale
    out = []
    for points, labels, boxes, mm in prompts:
        pts = None if points is None else (torch.from_numpy(np.asarray(points, np.float32) * s)[None].to(dev),
                                           torch.tensor([labels], device=dev))
        bxs = None if boxes is None else torch.from_numpy(np.asarray(boxes, np.float32) * s).to(dev)
        out.append(tuple(t.double().cpu() for t in pred.decode(pts, bxs, mm)))
    emb = pred.features[0] if isinstance(pred.features, tuple) else pred.features
    return emb.double().cpu(), out


def sam_against_f64(model, bgr, prompts, tag, cpu=True) -> str:
    """The card's f32 SAM against the same weights in f64 on the card: the encoder's embedding and each prompt set's
    low-res logits and IoU scores, with the CPU's f32 distance from f64 as the yardstick (each within 4x it, and 1e-4
    of the output's scale at least; `cpu=False`: that floor alone), and the logits' signs agreeing with f64's on
    SIGN_AGREE of the pixels or more → the distances."""
    import copy

    import torch

    emb, outs = sam_outputs(model, bgr, prompts)
    m64 = copy.deepcopy(model).double()
    e64, o64 = sam_outputs(m64, bgr, prompts)
    del m64
    ecpu, ocpu = (None, None)
    if cpu:
        mcpu = copy.deepcopy(model).cpu()
        ecpu, ocpu = sam_outputs(mcpu, bgr, prompts)
        del mcpu
    torch.cuda.empty_cache()
    groups = {"embedding": [(emb, e64, ecpu)], "logits": [(a[0], b[0], c[0] if c else None) for a, b, c in
                                                         zip(outs, o64, ocpu or [None] * len(outs))],
              "iou": [(a[1], b[1], c[1] if c else None) for a, b, c in zip(outs, o64, ocpu or [None] * len(outs))]}
    text = []
    for k, trips in groups.items():
        card_e = max(float((a - b).abs().max()) for a, b, _ in trips)
        scale = max(float(b.abs().max()) for _, b, _ in trips)
        cpu_e = max(float((c - b).abs().max()) for _, b, c in trips) if cpu else None
        floor = 1e-4 * max(scale, 1.0)
        if card_e > max(4 * (cpu_e or 0.0), floor):
            raise AssertionError(f"{tag}: {k} card {card_e:.3e} from f64, CPU {cpu_e}, floor {floor:.1e}")
        text.append(f"{k} {card_e:.3e}" + (f" / {cpu_e:.3e}" if cpu else ""))
    agree = min(float(((a[0] > 0) == (b[0] > 0)).double().mean()) for a, b in zip(outs, o64))
    pos = min(float((b[0] > 0).double().mean()) for b in o64)
    if agree < SIGN_AGREE:
        raise AssertionError(f"{tag}: logits' signs agree with f64 on {agree:.6f} of the pixels")
    return (f"f32 against f64 (card{' / CPU' if cpu else ''}): " + ", ".join(text)
            + f"; logit signs agree on {agree:.6f} (f64 positive on {pos:.3f} of the pixels at least)")


def sam_phase(name, bgr, card):
    """`[sam]` / `[mobile_sam]`: SAM(name) at 1024 on the card (the JAX package's init(0), drawn by the port; woken by
    `awake_sam`) on one 640x512 BGR frame: a point prompt (three masks) and a box prompt (one), held against f64
    (`sam_against_f64`, the CPU's f32 as the yardstick), encode and decode ms (events), then `generate` at its
    defaults (stride 32, batch 64, conf 0.88, stability 0.95) with its host split; no kernel launches on any of it."""
    import torch

    from yolo_tpu_torch import SAM
    from yolo_tpu_torch.models.sam.predict import SAMPredictor

    t0 = time.perf_counter()
    sam = SAM(name)
    built = time.perf_counter() - t0
    if sam.info()["params"] != SAM_COUNTS[name]:
        raise AssertionError(f"{name}: {sam.info()} parameters, the JAX package counts {SAM_COUNTS[name]}")
    awake_sam(sam.model)
    prompts = [(SAM_POINT, [1], None, True), (None, None, SAM_BOX, False)]
    held = sam_against_f64(sam.model, bgr, prompts, name)
    r = sam.predict(bgr, points=SAM_POINT, labels=[1])
    rb = sam.predict(bgr, bboxes=SAM_BOX, multimask_output=False)
    if r.masks.data.shape != (3, *bgr.shape[:2]) or rb.masks.data.shape != (1, *bgr.shape[:2]):
        raise AssertionError(f"{name}: masks {r.masks.data.shape} / {rb.masks.data.shape}")
    pred, dev, s = sam.predictor, sam.device, sam.model.img_size
    x = torch.zeros((1, s, s, 3), device=dev)
    enc = cuda_ms(lambda: sam.model.encode_image(x), iters=3, warmup=1)
    pts = (torch.tensor([[[s / 2, s * 0.4]]], device=dev), torch.ones((1, 1), dtype=torch.long, device=dev))
    dec = cuda_ms(lambda: pred.decode(pts, None, True), iters=10)
    grid = torch.rand((64, 1, 2), generator=torch.Generator().manual_seed(0)).to(dev) * s
    dec64 = cuda_ms(lambda: pred.decode((grid, torch.ones((64, 1), dtype=torch.long, device=dev)), None, True), iters=5)
    gen = SAMPredictor(sam.model)
    gen.timings = []
    t1 = time.perf_counter()
    res, launches = counted(set(), lambda: gen.generate(bgr))
    wall = time.perf_counter() - t1
    ts = gen.timings[0]
    loose, _ = counted(set(), lambda: gen.generate(bgr, points_stride=16, conf_thres=0.0, stability_score_thresh=0.0))
    tl = gen.timings[1]
    if len(loose.masks) != len(loose.boxes) or not len(loose.masks) or loose.masks.data.shape[1:] != bgr.shape[:2]:
        raise AssertionError(f"{name}: the unfiltered generate kept {len(loose.masks)} masks, {len(loose.boxes)} boxes")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(name, card, f"{sam.info()['params']:,} parameters (built and drawn in {built:.1f} s); {held}; masks {tuple(r.masks.data.shape)} "
        f"(point, IoU {', '.join(f'{v:.4f}' for v in r.iou_scores)}), {tuple(rb.masks.data.shape)} (box); encode "
        f"{enc:.2f} ms, decode {dec:.3f} ms a prompt, {dec64:.3f} ms for 64 (events); generate {wall:.2f} s: {len(res.masks)} "
        f"masks of {ts['points']} points (host clock: encode {ts['encode_s']:.3f} s, decode and copy {ts['decode_s']:.3f} s, "
        f"filters {ts['filter_s']:.3f} s, NMS and upscale {ts['nms_s']:.3f} s); unfiltered (stride 16, conf 0, stability 0) "
        f"{len(loose.masks)} masks after NMS of {tl['points'] * 3} (decode {tl['decode_s']:.3f} s, filters and boxes "
        f"{tl['filter_s']:.3f} s, NMS and upscale {tl['nms_s']:.3f} s); peak {peak:.2f} GiB; launches {launches}")
    del sam, pred, gen
    torch.cuda.empty_cache()


def sam2_phase(bgr, clip, card):
    """`[sam2]`: SAM("sam2_t") at 1024 (init(0), woken): the point and box prompts held against f64 as `[sam]`'s; then
    `video_predictor` on SAM2_FRAMES clip frames resized to 1024² (a click on frame 0; ms a tracked frame) and
    SAM2_REVERSE frames backward with reverse=True; each run against the same weights' f64 run on the card: every
    frame's logit signs agree on SIGN_AGREE of the pixels, object scores within 1e-3; `generate` refused."""
    import copy

    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch import SAM

    t0 = time.perf_counter()
    sam = SAM("sam2_t")
    if sam.info()["params"] != SAM_COUNTS["sam2_t"]:
        raise AssertionError(f"sam2_t: {sam.info()}")
    awake_sam(sam.model)
    held = sam_against_f64(sam.model, bgr, [(SAM_POINT, [1], None, True), (None, None, SAM_BOX, False)], "sam2_t")
    try:
        sam.predict(bgr, points=SAM_POINT)
        sam.predictor.generate(bgr)
        raise AssertionError("sam2_t: generate ran; JAX refuses it")
    except NotImplementedError:
        pass
    side = sam.model.img_size
    frames = [cv2.resize(np.repeat(f, 3, -1), (side, side), interpolation=cv2.INTER_LINEAR) for f in clip[:SAM2_FRAMES]]
    m64 = copy.deepcopy(sam.model).double()

    def run(model, seq, reverse):
        from yolo_tpu_torch.models.sam.video import SAM2VideoPredictor

        vp = SAM2VideoPredictor(model, num_frames=len(seq), reverse=reverse)
        m, s = vp.add_prompt(seq[0], points=[[side / 2, side * 0.4]], labels=[1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        M, S = vp.propagate(seq[1:])
        return np.concatenate([m[None], M]), np.concatenate([s[None], S]), (time.perf_counter() - t1) / (len(seq) - 1)

    lines = []
    for reverse, seq in ((False, frames), (True, frames[SAM2_REVERSE - 1 :: -1])):
        (M, S, ms), launches = counted(set(), lambda: run(sam.model, seq, reverse))
        M64, S64, _ = run(m64, seq, reverse)
        agree = min(float(((a > 0) == (b > 0)).mean()) for a, b in zip(M, M64))
        score = float(np.abs(S - S64).max())
        if M.shape != (len(seq), 1, side, side) or agree < SIGN_AGREE or score > 1e-3:
            raise AssertionError(f"sam2 video reverse={reverse}: {M.shape}, signs {agree:.6f}, scores {score:.3e}")
        lines.append(f"{'reverse' if reverse else 'forward'} {len(seq)} frames: {ms * 1e3:.1f} ms a tracked frame (host clock), "
                     f"signs against f64 {agree:.6f}, object scores {score:.2e} (f32 {S.min():.3f}-{S.max():.3f}), masks on "
                     f"{(M > 0).mean():.3f} of the pixels; launches {launches}")
    del m64
    torch.cuda.empty_cache()
    log("sam2", card, f"sam2_t: {held}; generate refused (NotImplementedError, as JAX); video " + "; ".join(lines)
        + f"; {time.perf_counter() - t0:.1f} s")
    del sam


def sam_variants_phase(bgr, card):
    """`[sam variants]`: sam_l, sam_h, sam2_s and sam2_b at 1024: built on the card (info() equal to the JAX package's
    count), one `set_image` and one point prompt held against f64 on the card (1e-4 of each output's scale; logit
    signs), the encoder's ms (events) and the peak memory of the f32 predictor."""
    import torch

    from yolo_tpu_torch import SAM

    for name in SAM_VARIANTS:
        t0 = time.perf_counter()
        sam = SAM(name)
        built = time.perf_counter() - t0
        n = sam.info()["params"]
        if n != SAM_COUNTS[name]:
            raise AssertionError(f"{name}: {n} parameters, the JAX package counts {SAM_COUNTS[name]}")
        awake_sam(sam.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, launches = counted(set(), lambda: sam.predict(bgr, points=SAM_POINT, labels=[1]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        held = sam_against_f64(sam.model, bgr, [(SAM_POINT, [1], None, True)], name, cpu=False)
        x = torch.zeros((1, sam.model.img_size, sam.model.img_size, 3), device=sam.device)
        enc = cuda_ms(lambda: sam.model.encode_image(x), iters=3, warmup=1)
        log("sam variants", card, f"{name}: {n:,} parameters (built and drawn in {built:.1f} s); {held}; encode {enc:.2f} ms "
            f"(events); predict peak {peak:.2f} GiB; launches {launches}")
        del sam
        torch.cuda.empty_cache()


def fastsam_rows(y, frames, clip_model, plain, points):
    """Each frame through FastSAM.predict (f32) in everything mode and under each FASTSAM_PROMPTS prompt, the point
    prompt at that frame's `points` → [(kind, rows, masks)]."""
    out = []
    for f, point in zip(frames, points):
        for kind, kw in FASTSAM_PROMPTS.items():
            extra = {"clip_model": clip_model} if "texts" in kw else {"points": point} if "points" in kw else {}
            r = y.predict(f, plain=plain, half=False, compute_dtype="float32", **FASTSAM_PREDICT, **{**kw, **extra})[0]
            out.append((kind, r.boxes.data.copy(), r.masks.data.copy() if r.masks is not None else None))
    return out


def fastsam_phase(name, frames, clip_model, card):
    """`[fastsam]` for FastSAM-s or -x at 640 (yolov8s / yolov8x-seg, nc 1; the init(0) tree calibrated on two seeded
    640² noise images): kernels 1, 2, 3 and 5 against their twins with the live gate; FASTSAM_FRAMES BGR clip frames in
    everything mode and under bbox, point and text prompts (the seeded CLIPModel passed as `clip_model`), f32 through
    the kernels against f32 through the twins: equal row counts and classes, boxes 1e-2 px, conf 1e-4, each mask's IoU
    with the twin's 0.99 at least (and the count of masks equal pixel for pixel); the launches of one predict call;
    bf16 frames/s with the host split."""
    import numpy as np
    import torch

    from yolo_tpu_torch import FastSAM
    from yolo_tpu_torch.nn.tasks import params_from_jax

    t0 = time.perf_counter()
    y = FastSAM(name)
    noise = torch.rand((2, 640, 640, 3), generator=torch.Generator().manual_seed(0)).cuda()
    y.params = bn_calibrated(y.model, y.params, noise)
    params_from_jax(y.model, y.params, torch.float32)
    held = hold_path_kernels([y.model], noise, f"fastsam {name}", card, conf=0.0, iou=0.7, live=True)
    # warm (f32 weights, plans); each frame's point prompt is its best box's centre, so that it lands in a mask
    best = [y.predict(f, plain=False, half=False, compute_dtype="float32", **FASTSAM_PREDICT)[0].boxes.xyxy[:1] for f in frames]
    points = [[[int(v) for v in (b[0, :2] + b[0, 2:]) / 2]] if len(b) else FASTSAM_PROMPTS["point"]["points"] for b in best]
    pk, launches = counted(FASTSAM_PATH, lambda: fastsam_rows(y, frames, clip_model, False, points))
    pp = fastsam_rows(y, frames, clip_model, True, points)
    n_det, worst_box, worst_conf, worst_iou, equal = 0, 0.0, 0.0, 1.0, 0
    for (kind, bk, mk), (_, bp, mp) in zip(pk, pp):
        if bk.shape != bp.shape or (mk is None) != (mp is None) or (mk is not None and mk.shape != mp.shape):
            raise AssertionError(f"fastsam {name} {kind}: rows {bk.shape} vs twins {bp.shape}")
        if len(bk):
            if not np.array_equal(bk[:, 5], bp[:, 5]):
                raise AssertionError(f"fastsam {name} {kind}: classes differ")
            worst_box = max(worst_box, float(np.abs(bk[:, :4] - bp[:, :4]).max()))
            worst_conf = max(worst_conf, float(np.abs(bk[:, 4] - bp[:, 4]).max()))
            worst_iou = min(worst_iou, *(_mask_iou(a, b) for a, b in zip(mk, mp)))
            equal += sum(bool(np.array_equal(a, b)) for a, b in zip(mk, mp))
        n_det += len(bk)
    if n_det == 0 or worst_box > 1e-2 or worst_conf > 1e-4 or worst_iou < 0.99:
        raise AssertionError(f"fastsam {name}: {n_det} rows, |box| {worst_box}, |conf| {worst_conf}, mask IoU {worst_iou}")
    kinds = {k: sum(len(b) for kk, b, _ in pk if kk == k) for k in FASTSAM_PROMPTS}
    bf16 = dict(plain=False, half=True, compute_dtype="bfloat16", **FASTSAM_PREDICT)  # a reused predictor keeps its settings
    _, one = counted(FASTSAM_PATH, lambda: y.predict(frames[0], **bf16))  # warm: bf16 weights
    y.predictor.timings = []
    t1 = time.perf_counter()
    _, lb = counted(FASTSAM_PATH, lambda: [y.predict(f, **bf16) for f in frames])
    wall = time.perf_counter() - t1
    ts, y.predictor.timings = y.predictor.timings, None
    log("fastsam", card, f"{name}: held " + ", ".join(f"{k} {v:.2e}" for k, v in held.items()) + f"; f32 {len(frames)} frames x "
        f"{len(FASTSAM_PROMPTS)} modes, kernels against twins: {n_det} rows ({', '.join(f'{k} {v}' for k, v in kinds.items())}), "
        f"max |box| {worst_box:.3e} px, |conf| {worst_conf:.3e}, least mask IoU {worst_iou:.6f} ({equal} of {n_det} masks "
        f"equal pixel for pixel); launches {launches}, one everything-mode call {one}; bf16 everything mode "
        f"{len(frames) / wall:.1f} frames/s (host ms a frame: {host_split(ts)}); launches {lb}; {time.perf_counter() - t0:.1f} s")


def clip_vision_phase(clip_model, frames, card):
    """`[clip vision]`: the seeded ViT-B/32 vision tower on CLIP_CROPS crops of the clip frames (CLIP's preprocess):
    the card's f32 features against the CPU's (1e-4), and the tower's ms on the device (events)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.nn.text_model import _vision_to_device

    rng = np.random.default_rng(0)
    crops = []
    for i in range(CLIP_CROPS):
        f = frames[i % len(frames)]
        x0, y0 = int(rng.integers(0, 500)), int(rng.integers(0, 380))
        crops.append(f[y0 : y0 + int(rng.integers(40, 130)), x0 : x0 + int(rng.integers(40, 130)), ::-1])
    got = clip_model.encode_image(crops)
    x = torch.from_numpy(clip_model.preprocess(crops))
    cpu = clip_model.vision.encode_image(_vision_to_device(clip_model.vision_params, "cpu"), x)
    diff = float((got.cpu() - cpu).abs().max())
    xd = x.cuda()
    ms = cuda_ms(lambda: clip_model.vision.encode_image(clip_model.vision_weights, xd), iters=10)
    if diff > 1e-4 or got.shape != (CLIP_CROPS, 512):
        raise AssertionError(f"clip vision: card against CPU {diff:.3e}, shape {tuple(got.shape)}")
    log("clip vision", card, f"{CLIP_CROPS} crops at 224² (ViT-B/32, seeded): f32 card against CPU {diff:.3e}; the tower "
        f"{ms:.3f} ms on the device (events)")


def slice23_phases(clip, card):
    """The twenty-third slice's phases: `[sam]` (sam_b), `[mobile_sam]`, `[sam2]` (sam2_t, image and video), `[sam
    variants]` (sam_l, sam_h, sam2_s, sam2_b), `[fastsam]` (FastSAM-s and -x, kernels 1, 2, 3, 5), `[clip vision]`."""
    import numpy as np

    from yolo_tpu_torch.nn.text_model import CLIPModel

    t0 = time.perf_counter()
    bgr = np.repeat(clip[0], 3, -1)
    for name in ("sam_b", "mobile_sam"):
        sam_phase(name, bgr, card)
    sam2_phase(bgr, clip, card)
    sam_variants_phase(bgr, card)
    clip_model = CLIPModel()
    frames = np.repeat(clip[:FASTSAM_FRAMES], 3, -1)
    for name in FASTSAM:
        fastsam_phase(name, frames, clip_model, card)
    clip_vision_phase(clip_model, frames, card)
    print(f"[slice 23] its phases took {time.perf_counter() - t0:.1f} s")


def compare_runs(a, b, stats_a, stats_b):
    import numpy as np

    if stats_a != stats_b:
        raise AssertionError(f"stats differ: kernels {stats_a} vs plain {stats_b}")
    worst = 0.0
    for ca, cb in zip(a, b):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            if not np.array_equal(ca[k], cb[k]):
                raise AssertionError(f"'{k}' differs between the kernel and plain runs")
        for k in ("bbox", "confidence", "velocity"):
            if not np.all(np.isfinite(ca[k])):
                raise AssertionError(f"non-finite '{k}' in the kernel run")
            worst = max(worst, float(np.abs(ca[k] - cb[k]).max()))
            np.testing.assert_allclose(ca[k], cb[k], atol=1e-2, rtol=1e-4, err_msg=k)
    return worst


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from yolo_tpu_torch import load_npz
    from yolo_tpu_torch.ops import _cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    start = time.perf_counter()

    def mark(what):  # the script's timeline: where its time limit goes
        print(f"[time] {what} done at {time.perf_counter() - start:.1f} s")
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    building = ThreadPoolExecutor(1).submit(_cuda.build)  # nvcc runs in its own processes: the host writes meanwhile
    datasets = tempfile.TemporaryDirectory()
    data_root = Path(datasets.name)
    write_datasets(data_root)
    written = time.perf_counter() - t0
    lib = building.result()
    log("build", card, f"{lib.name} in {time.perf_counter() - t0:.1f} s (every dataset written meanwhile, in {written:.1f} s)")
    for line in (_cuda.BUILD / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("[build]", line.strip())

    model, params, _ = load_npz(WEIGHTS)
    print(f"[model] {WEIGHTS.relative_to(ROOT)}: {len(model.layers)} layers, strides {model.stride}, nc={model.nc}")
    t0 = time.perf_counter()
    clip = make_clip(FRAMES, *HW)
    print(f"[clip] {clip.shape} uint8 made in {time.perf_counter() - t0:.1f} s")

    profiling = "--profile" in argv
    c2f_cases = {} if profiling else None
    records = check_kernels(model, params, clip[:CHUNK], card, keep=c2f_cases)
    c2f_edges_phase(card)
    c2f_widths_phase(card)
    head_edges_phase(card)
    nms_edges_phase(card)
    mark("build and kernel holds")

    ft, launches, bf16_run, f32_run, fps = pipeline_phase("pipeline", model, params, clip, card, head_cm=False)
    pipeline_options_phase(model, params, clip, card, *bf16_run)
    int8_pipeline_phase(model, params, clip, card, f32_run, fps)
    _, launches_cm, _, _, _ = pipeline_phase("pipeline head_cm", model, params, clip, card, head_cm=True)
    if launches_cm["head_level_cm"] != 4 * (FRAMES // CHUNK):
        raise AssertionError(f"head_level_cm: {launches_cm['head_level_cm']} launches, expected one per level and chunk")
    launches["head_level_cm"] = launches_cm["head_level_cm"]
    mark("pipelines")
    bgr_phase(model, params, clip, card)
    batched_tracker_phase(card)
    predict_phase(clip, card)
    predict_settings_phase(clip, card)
    host_rows = track_phase("track bytetrack", clip, card, "bytetrack.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        botsort = Path(tmp) / "botsort_none.yaml"
        botsort.write_text((ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "botsort.yaml").read_text()
                           .replace("gmc_method: sparseOptFlow", "gmc_method: none"))
        print(f"[track botsort] gmc_method none, the GMC off (a machine without cv2 runs only this form); "
              f"cv2 here: {cv2_version()}")
        track_phase("track botsort", clip, card, str(botsort))
    track_reid_phase(clip, card)
    if cv2_version():  # the default yaml's sparse optical flow, where cv2 imports
        track_phase("track botsort sparseOptFlow", clip, card, "botsort.yaml")
    track_device_phase(clip, card, host_rows)
    byte_scan_phase(model, params, clip, card)
    mark("predict, track, byte scan")

    if cv2_version() is None:
        raise RuntimeError("config 5 needs cv2 (the motion detector, the panning clip, the video files); it does not import")
    t0 = time.perf_counter()
    pan = make_panning_clip(MOTION_FRAMES)
    print(f"[motion clip] {pan.shape} uint8 made in {time.perf_counter() - t0:.1f} s (cv2 {cv2_version()})")
    motion_kernels_phase(model, params, pan, card)
    for method in ("optical_flow", "feature_matching", "hybrid"):
        motion_method_phase(method, model, params, pan, card)
    motion_per_frame_phase("optical_flow", model, params, pan, card)
    motion_compare_phase(model, params, pan, card)
    grayscale_phase(clip, card)
    grayscale_scorer_phase(card)
    mark("config 5")

    serve_kernels_phase(clip, card)
    letterbox_cost(clip, card)
    with serving({0: str(WEIGHTS)}) as srv:  # bf16, the default
        for run in (1, 2):
            serve_phase(clip, card, run, srv)
        remote_phase(clip, card, srv)
    predict_sources_phase(clip, card)
    mark("serving")

    tiled_phase(clip, card)
    tta_phase(clip, card)
    ensemble_phase(clip, card)
    embed_phase(clip, card)
    enhance_phase(clip, card)
    video_phases(clip, card)
    benchmark_phase(model, params, clip, card)
    mark("tiles, TTA, ensembles, embeddings, video loops, benchmark")

    with datasets as tmp:  # the datasets written while the kernels built; the runs go beside them
        heldout, big = heldout_split(Path(tmp) / "heldout"), val_split(Path(tmp) / "val")
        val_kernels_phase(model, params, heldout, card)
        val_phase(big, heldout, card)
        if profiling:
            val_workers_sweep(big, heldout, card)
        val_coco_phase(big, Path(tmp) / "val_coco", card)
        mark("validation")

        train_data = train_split(Path(tmp) / "train")
        trained, _ = train_phase(train_data, Path(tmp) / "runs", card, profiling)
        train_step_f32_phase(train_data, card)
        tuned = train_finetune_phase(train_data, Path(tmp) / "runs", card)
        train_val_kernels_phase({"train": trained, "finetune": tuned}, train_data, card)
        train_settings_phase(train_data, Path(tmp) / "runs", card)
        mark("training")
        tune_phase(Path(tmp) / "tune", card)
        classify_phase(clip, Path(tmp) / "cls", card)
        mark("tune, classify")
        seg = segment_phases(Path(tmp) / "seg", card)
        mark("segment")
        pose_phases(Path(tmp) / "pose", card, seg)
        mark("pose")
        obb_phases(Path(tmp) / "obb", card)
        mark("obb")
        slice17_phases(clip, Path(tmp) / "slice17", train_data, card)
        slice18_phases(clip, train_data, Path(tmp) / "seg" / "data.yaml", Path(tmp) / "pose" / "data.yaml", Path(tmp) / "slice18", card)
        mark("the seventeenth and eighteenth slices")
        slice19_phases(clip, train_data, Path(tmp) / "slice19", card)
        mark("the nineteenth slice")
        slice20_phases(clip, train_data, Path(tmp) / "slice20", card)
        mark("the twentieth slice")
        slice21_phases(clip, train_data, Path(tmp) / "cls", Path(tmp) / "slice21", card)
        mark("the twenty-first slice")
        slice22_phases(clip, train_data, Path(tmp) / "slice22", card)
        mark("the twenty-second slice")
        slice23_phases(clip, card)
        mark("the twenty-third slice")
        if profiling:
            for name in SLICE18_FAMILIES:
                train_step_precision_phase(train_data, card, name)

    if profiling:
        from torch.profiler import ProfilerActivity, profile

        dev = torch.from_numpy(clip[:CHUNK]).cuda()
        ft.timings = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ft.process_chunk_device(dev)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        c2f_plan_sweep(c2f_cases, card)
        c2f_stage_trace(c2f_cases["bfloat16"], card)
        head_plan_sweep({dn: c2f_cases["head " + dn] for dn in ("bfloat16", "float32")}, card)
        head_stage_trace(c2f_cases["head bfloat16"], card)

    rows = []
    for name, (route, source, replaces) in KERNEL_ROWS.items():
        r = records[name]
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes", "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
