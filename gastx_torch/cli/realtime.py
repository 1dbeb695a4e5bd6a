"""Real-time 3D pose estimation from a camera or video stream, on the GPU
(the port of ``gastx.cli.realtime``).

Parity target: the reference's real-time claim (README.md:7) backed by its
causal models + per-frame pipeline (gen_skes.py:43-69 ``load_model_realtime``,
tools/inference.py:73-110 ``gen_pose_frame``, tools/preprocess.py:158-172
``revise_skes_real_time``).

Per frame: YOLO detect -> SORT track -> HRNet 2D -> causal streaming lift
(``StreamingLifter.push_async``: the window stays on the device) ->
real-time placement. Output: live overlay window (``--display``, OpenCV on
the host), or a 3D-pose npz when ``--output`` is given. Runs on ``cuda``
unless ``--device`` names another device; frames are decoded on the host
(``viz.video_io``; the camera through OpenCV). :func:`run_frames` is the
same loop on frames already decoded.

    python -m gastx_torch.cli.realtime -v camera --yolo-weights ... \\
        --hrnet-weights ... -w 27_frame_model_causal.bin
    python -m gastx_torch.cli.realtime -v video.mp4 --output out.npz
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="gastx_torch real-time 3D pose")
    parser.add_argument("-v", "--video", type=str, default="camera",
                        help="'camera' (device 0) or a video path")
    parser.add_argument("-np", "--num-person", type=int, default=1)
    parser.add_argument("-f", "--frames", type=int, default=27,
                        help="causal receptive field (27/81)")
    parser.add_argument("-w", "--weight", type=str,
                        default="./checkpoint/gastnet/27_frame_model_causal.bin")
    parser.add_argument("--yolo-weights", type=str,
                        default="./checkpoint/yolov3/yolov3.weights")
    parser.add_argument("--hrnet-weights", type=str,
                        default="./checkpoint/hrnet/pose_hrnet_w48_384x288.pth")
    parser.add_argument("--yolo-cfg", type=str, default=None)
    parser.add_argument("--output", type=str, default=None,
                        help="npz path for the streamed 3D poses")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--display", action="store_true",
                        help="show the live 2D overlay window")
    parser.add_argument("--random-lifter-weights", action="store_true")
    parser.add_argument("--no-pipeline", action="store_true",
                        help="strictly sequential per-frame loop (the "
                             "pipelined default overlaps the detect / "
                             "2D-pose / lift stages of neighbouring frames; "
                             "outputs are identical)")
    parser.add_argument("--pool-workers", type=int, default=2,
                        help="worker threads for the stateless pipeline "
                             "stages (device detect, HRNet 2D); 1 = one "
                             "thread per stage. Outputs are identical "
                             "either way")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    return parser.parse_args(argv)


def _pipelined_loop(frames, estimator, args, lift_submit, lift_finish,
                    should_stop, depth: int = 4,
                    pool_workers: int = 2) -> int:
    """Software-pipelined frame loop with pooled stateless stages.

    Per frame the host loop runs three device stages — YOLO detect, HRNet
    2D pose, causal streaming lift — each with host work (Python, the host
    NMS, SORT, the decode) around its device work. Run sequentially they
    serialize; pipelined across NEIGHBOURING frames the host work of one
    stage overlaps the device work of another. The detect stage's device
    half is STATELESS — only the SORT update needs frame order — so it
    runs on a ``pool_workers``-wide thread pool whose deliverer releases
    results in sequence order; the HRNet stage (also stateless) is pooled
    the same way.

    Stages (FIFO queues of ``depth``; every queue item is ``(seq,
    payload)`` and a ``STOP`` payload flushes the pipe):

      reader:      next(frames)                  (ordered tagger)
      device det:  upload + letterbox + YOLO     (POOLED, ordered delivery)
      track:       SORT update + affine crops    (ordered: owns tracker)
      hrnet:       HRNet heatmaps + decode       (POOLED, ordered delivery)
      main:        convert + stream-lift + place (ordered: owns the
                   lifter window state; ``lift_submit`` dispatches the
                   lift async and ``lift_finish`` of the PREVIOUS frame
                   fetches/places while it is in flight)

    The pooled split needs the estimator's device/host detect split
    (``.detector.detect`` + ``.crops_from_detections``); estimators
    without it (reduced test stubs) fall back to an ordered
    ``detect_crops`` stage. Every stateful stage processes frames
    strictly in order, so tracker and streaming-lifter state evolve
    exactly as in the sequential loop and the output is identical.
    Exceptions ride the queues tagged with their frame and re-raise in the
    caller, in order.
    """
    import queue
    import threading

    STOP = object()
    quit_evt = threading.Event()
    queues = []

    def make_queue():
        q = queue.Queue(maxsize=depth)
        queues.append(q)
        return q

    def safe_put(q, item):
        """put that gives up once the pipeline is shutting down — the
        main thread drains each queue exactly once in its ``finally``,
        so a put racing past that drain could otherwise block a stage
        thread forever."""
        while not quit_evt.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def reader(q_out):
        n = 0
        while not quit_evt.is_set():
            frame = next(frames, None)
            if frame is None:
                break
            if not safe_put(q_out, (n, frame)):
                return
            n += 1
        safe_put(q_out, (n, STOP))

    def ordered_stage(q_in, q_out, fn):
        """One worker, FIFO in == FIFO out; exceptions pass through."""
        while not quit_evt.is_set():
            seq, item = q_in.get()
            if item is STOP or quit_evt.is_set():
                safe_put(q_out, (seq, STOP))
                return
            if isinstance(item, BaseException):
                safe_put(q_out, (seq, item))
                continue
            try:
                res = fn(item)
            except BaseException as exc:
                res = exc
            if not safe_put(q_out, (seq, res)):
                return

    def pooled_stage(q_in, q_out, fn, workers):
        """``workers`` concurrent appliers of a STATELESS ``fn`` plus a
        deliverer that releases results in sequence order — downstream
        stateful stages see exactly the sequential stream."""
        cond = threading.Condition()
        buf = {}

        def work():
            while not quit_evt.is_set():
                seq, item = q_in.get()
                if item is STOP or quit_evt.is_set():
                    try:
                        q_in.put_nowait((seq, STOP))  # wake peer workers
                    except queue.Full:
                        pass  # full queue == a peer isn't blocked on get
                    with cond:
                        buf[seq] = STOP
                        cond.notify_all()
                    return
                if isinstance(item, BaseException):
                    res = item
                else:
                    try:
                        res = fn(item)
                    except BaseException as exc:
                        res = exc
                with cond:
                    buf[seq] = res
                    cond.notify_all()

        ABSENT = object()

        def deliver():
            want = 0
            while not quit_evt.is_set():
                with cond:
                    while want not in buf and not quit_evt.is_set():
                        cond.wait(0.2)
                    # Distinct sentinel: a stage fn legitimately returning
                    # None must not read as the quit_evt path.
                    res = buf.pop(want, ABSENT)
                if res is ABSENT:  # quit_evt path
                    return
                if not safe_put(q_out, (want, res)) or res is STOP:
                    return
                want += 1

        return [threading.Thread(target=work, daemon=True)
                for _ in range(workers)] \
            + [threading.Thread(target=deliver, daemon=True)]

    q0 = make_queue()
    q_crops = make_queue()
    q_pose = make_queue()
    threads = [threading.Thread(target=reader, args=(q0,), daemon=True)]

    deep_split = pool_workers > 1 and hasattr(estimator, "detector") \
        and hasattr(estimator, "crops_from_detections")
    if deep_split:
        q_dets = make_queue()

        def detect_stage(frame):
            on_device = estimator.detector.to_device(frame)
            return frame, on_device, estimator.detector.detect(on_device)

        threads += pooled_stage(q0, q_dets, detect_stage, pool_workers)

        def track_stage(item):
            frame, on_device, (bboxs, det_scores) = item
            return frame, estimator.crops_from_detections(
                on_device, bboxs, det_scores, args.num_person, True)

        threads.append(threading.Thread(
            target=ordered_stage, args=(q_dets, q_crops, track_stage),
            daemon=True))
    else:
        threads.append(threading.Thread(
            target=ordered_stage,
            args=(q0, q_crops,
                  lambda frame: (frame, estimator.detect_crops(
                      frame, args.num_person))),
            daemon=True))

    def hrnet_stage(item):
        frame, crops = item
        if crops is None:
            return frame, None
        return frame, estimator.pose_from_crops(*crops)

    if pool_workers > 1:
        threads += pooled_stage(q_crops, q_pose, hrnet_stage, pool_workers)
    else:
        threads.append(threading.Thread(
            target=ordered_stage, args=(q_crops, q_pose, hrnet_stage),
            daemon=True))

    for t in threads:
        t.start()

    n = 0
    pending = None
    try:
        while True:
            seq, item = q_pose.get()
            if item is STOP:
                break
            if isinstance(item, BaseException):
                # Place the already-submitted previous frame first, so an
                # error-tolerant caller sees exactly the sequential
                # prefix of outputs.
                if pending is not None:
                    lift_finish(pending)
                    pending = None
                raise item
            n += 1
            frame, result = item
            # Submit this frame's lift before finishing the previous
            # frame: the new dispatch overlaps the fetch.
            submitted = lift_submit(seq, frame, result)
            if pending is not None and not lift_finish(pending):
                # Early display-quit: drop the in-flight frame, like the
                # sequential loop (which never reads or submits it) —
                # including from the processed-frame count.
                pending = None
                n -= 1
                quit_evt.set()
                break
            pending = submitted
            if should_stop():
                quit_evt.set()
                break
        if pending is not None:
            lift_finish(pending)
            pending = None
    finally:
        quit_evt.set()
        # Unblock producers stuck on full queues, then wake any getter
        # still blocked on an empty queue (a full queue has no blocked
        # getters, so a dropped sentinel is never a lost wakeup).
        for q in queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            try:
                q.put_nowait((-1, STOP))
            except queue.Full:
                pass
        for t in threads:
            t.join(timeout=5.0)
    return n


def run_frames(args, frames, width: int, height: int, estimator=None):
    """The real-time loop over an iterable of BGR uint8 frames of
    ``width`` x ``height``. Returns ((T, M, 17, 3) placed poses of the
    frames with a detection, per-frame latencies in seconds from the
    frame's read to its placed pose)."""
    import torch

    from gastx_torch.cli.gen_skes import load_lifter
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer.streaming import StreamingLifter
    from gastx_torch.pipeline import revise_skes_real_time
    from gastx_torch.pipeline.keypoint_revision import h36m_coco_kpts
    from gastx_torch.pipeline.video_pose2d import Pose2DEstimator

    model = load_lifter(args, causal=True)
    if estimator is None:
        estimator = Pose2DEstimator(args.yolo_weights, args.hrnet_weights,
                                    args.yolo_cfg, device=args.device)
    lifter = StreamingLifter(model, num_person=args.num_person)

    read_at = []

    def stamped():
        for frame in (frames if args.max_frames < 0
                      else itertools.islice(frames, args.max_frames)):
            read_at.append(time.perf_counter())
            yield frame

    all_poses, latencies = [], []
    stop = False

    def lift_submit(seq, frame, result):
        """Per-frame head: convert -> ASYNC streaming-lift dispatch.

        Returns a pending token for :func:`lift_finish`, or None for
        frames that never reach the lifter (no detection / empty
        conversion). The window state advances at submit time, so
        submits must happen in frame order.
        """
        if result is None:
            return None
        preds, maxvals = result  # (M, 17, 2), (M, 17, 1)

        kpts = np.zeros((args.num_person, 17, 2), np.float32)
        scores = np.zeros((args.num_person, 17, 1), np.float32)
        kpts[:len(preds)] = preds[:args.num_person]
        scores[:len(maxvals)] = maxvals[:args.num_person]

        # per-frame converter + revision (the reference real-time path,
        # tools/utils.py:133-175); refill dropped zero-persons so the
        # streaming window keeps a fixed (num_person, ...) shape
        converted_k, converted_s = h36m_coco_kpts(kpts, scores)
        if not converted_k:
            return None
        frame_kpts = np.zeros((args.num_person, 17, 2), np.float32)
        frame_scores = np.zeros((args.num_person, 17), np.float32)
        nonzero = [p for p in range(args.num_person)
                   if np.sum(kpts[p]) != 0.0]
        for row, p in enumerate(nonzero):
            frame_kpts[p] = converted_k[row]
            frame_scores[p] = converted_s[row]
        norm = np.asarray(normalize_screen_coordinates(
            frame_kpts, w=width, h=height), dtype=np.float32)
        with torch.profiler.record_function("gastx_torch.lift"):
            pose = lifter.push_async(norm)
        return seq, frame, frame_kpts, frame_scores, pose

    def lift_finish(pending):
        """Per-frame tail: fetch the lift result -> placement -> display.

        Returns False to request an early stop (display quit key). The
        pipelined loop holds ONE pending frame so this fetch overlaps the
        next frame's submit; the sequential loop finishes each frame
        immediately (identical math either way).
        """
        nonlocal stop
        seq, frame, frame_kpts, frame_scores, pose_dev = pending
        pose3d = pose_dev.cpu().numpy()  # (M, 17, 3)
        placed = revise_skes_real_time(list(pose3d), frame_kpts, width)
        all_poses.append(placed)
        latencies.append(time.perf_counter() - read_at[seq])

        if args.display:
            import cv2

            from gastx_torch.viz.draw2d import draw_keypoints

            overlay = draw_keypoints(frame, frame_kpts, scores=frame_scores)
            cv2.imshow("gastx_torch realtime", overlay)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                stop = True
                return False
        return True

    source = stamped()
    n = 0
    t0 = time.perf_counter()
    if args.no_pipeline:
        for n, frame in enumerate(source, start=1):
            result = estimator.estimate_frame(frame, args.num_person)
            pending = lift_submit(n - 1, frame, result)
            if pending is not None and not lift_finish(pending):
                break
    else:
        n = _pipelined_loop(source, estimator, args, lift_submit,
                            lift_finish, lambda: stop,
                            pool_workers=args.pool_workers)
    fps = n / (time.perf_counter() - t0)
    lat_ms = 1e3 * np.asarray(latencies or [np.nan])
    print(f"processed {n} frames at {fps:.1f} fps ({len(all_poses)} with "
          f"detections); latency p50 {np.percentile(lat_ms, 50):.1f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms")

    poses = (np.stack(all_poses) if all_poses
             else np.zeros((0, args.num_person, 17, 3), np.float32))
    return poses, np.asarray(latencies)


def _camera_frames(cap):
    """Frames of an open cv2.VideoCapture, released at the end."""
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield frame
    finally:
        cap.release()


def run(args, estimator=None) -> np.ndarray:
    """Open ``-v`` (the camera through OpenCV, a file through
    ``viz.video_io``), run :func:`run_frames`, write ``--output``. Returns
    the (T, M, 17, 3) poses."""
    if args.video == "camera":
        import cv2

        cap = cv2.VideoCapture(0)
        if not cap.isOpened():
            raise SystemExit("error: cannot open the camera")
        width = int(round(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        height = int(round(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        frames = _camera_frames(cap)
    else:
        from gastx_torch.viz.video_io import get_resolution, read_video

        width, height = get_resolution(args.video)
        frames = read_video(args.video, bgr=True)
    try:
        poses, _ = run_frames(args, frames, width, height, estimator)
    finally:
        frames.close()
    if args.output:
        np.savez_compressed(args.output, poses=poses)
        print("saved streamed 3D poses to", args.output)
    return poses


def main(argv=None):
    import torch

    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions
    run(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
