"""Multi-stream temporal serving: N chains, co-batched on one device.

Counterpart of ``patch_toon_tpu/infer/multistream.py``'s
``MultiStreamMixin``, mixed into the engine. One chain is sequential (frame
i needs frame i-1's stylized output), so it cannot co-batch its own frames;
N videos, one subdirectory each, can: each cycle takes every live stream's
next frame, runs each stream's prologue (its flow and warp, the
single-stream chain's own :meth:`_chain_prologue`), then stylizes them all
in ONE generator dispatch, advances each chain's carry, and queues the
readbacks on the engine's :class:`GroupPipeline`, which drains while later
cycles run (its ``drain_all`` takes the place of JAX's ``_ms_drain_one``
loop over a fetch pool).

Layout: ``paths.input_dir/<stream>/*.png``; masks under
``paths.mask_dir/<stream>/`` (a mask directory whose name ends in
``ignore`` means whole-frame composites in every stream, as in JAX, while
the device flow still reads its masks there); guide channels under
``<channel path>/<stream>/``; flow files (``flow_source: files``) under
``temporal.flow_dir/<stream>/``, numbered by the frame's rank among the
stream's members; outputs under ``paths.output_dir/<stream>/``. All streams
share one resolution. A failed decode or prologue restarts only its own
chain.

The mode rule is JAX's, kept as it is (``multistream.py:256-266``): a cycle
with two or more live streams goes through :meth:`_stylize_group`, the
tiled multiframe program whatever ``inference.mode`` says; a cycle with one
live stream goes through :meth:`_stylize_device`, which honours
``fullframe``.

The transport knobs act as in JAX (``multistream.py:97, 272-278``): each
frame's readback is cropped to its own mask's support box under
``crop_readback`` and pasted into its input bytes (the carries stay whole
on the device), and the device flow's raw masks go up bit-packed under
``mask_upload: packed``. Uploads are never cropped here.

``flow_batch`` > 1 computes a cycle's device flows first, one graph replay
a stream (``infer/temporal.py::_temporal_flow_pairs``), bitwise each
stream's own step; a graph batched across streams is not built.
:meth:`_watch_multistream` serves the same layout as a watched service.
"""

from __future__ import annotations

import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Set

import torch

from patch_toon_tpu_torch.infer.common import _image_files, mask_support_bbox
from patch_toon_tpu_torch.infer.pipeline import (
    GroupPipeline,
    Staged,
    stack_masks,
)
from patch_toon_tpu_torch.infer.temporal import _temporal_flow_pairs
from patch_toon_tpu_torch.infer.watch import watch_settings
from patch_toon_tpu_torch.native.frameio import FrameWriter
from patch_toon_tpu_torch.parallel import comm


class MultiStreamMixin:
    """Multi-stream temporal serving methods of ``StyleTransferInference``
    (the stream state, the cycle, the one-shot and watched entry points)."""

    def _ms_info(self, name: str, files, mask_dir: Path, flow_root) -> dict:
        """A stream's state: its file queue, its own guide, mask and flow
        directories, the chain's carry and the stream's members (files-mode
        flows are numbered by a frame's rank among them)."""
        chans = {n: dict(c, path=str(Path(c["path"]) / name))
                 for n, c in self.additional_channels.items()}
        mdir = Path(mask_dir) / name
        masked = not Path(mask_dir).name.endswith("ignore")
        if masked and not mdir.exists():
            raise FileNotFoundError(f"Mask directory not found: {mdir}")
        return dict(name=name, files=list(files), chans=chans, mdir=mdir,
                    masked=masked,
                    fdir=(Path(flow_root) / name) if flow_root else None,
                    prev=None, prev_gray=None, idx=0,
                    members={p.name for p in files})

    def _ms_load_frame(self, info: dict, i: int) -> Staged:
        """Decode and stage stream ``info``'s frame ``i`` (prefetch thread):
        the frame with the stream's guides, its eroded mask (None in an
        ``ignore`` layout), its tile boxes, and the flow file (files) or
        the raw flow mask (device)."""
        spans = self.spans
        p = info["files"][i]
        flow = fmask = None
        with spans("host/decode"):
            parts = self.load_frame_parts(p, channels=info["chans"])
            if self.temporal_flow_source != "device":
                if info["fdir"] is not None:
                    pos = sorted(info["members"]).index(p.name)
                    flow = self.load_flow(pos, info["fdir"])
        hw = parts[0].shape[:2]
        with spans("host/mask"):
            mask = self.load_eroded_mask(info["mdir"] / p.name, hw) \
                if info["masked"] else None
            if self.temporal_flow_source == "device":
                fmask = self.load_flow_mask(p, info["mdir"])
        with spans("host/tile_placement"):
            boxes = self.boxes_for(mask, hw)  # a 2+ stream cycle is tiled
            mbox = mask_support_bbox(mask) if mask is not None else None
        return self._stage(parts, mask, boxes, p, None, flow, fmask,
                           mbox=mbox)

    def _ms_resolve_loads(self, subs, shape_ref) -> List[tuple]:
        """Cycle pass 1: each stream's staged frame, its upload awaited; a
        failed decode restarts its own chain. The first frame pins the one
        resolution of every stream (``shape_ref``)."""
        loaded = []
        for info, fut in subs:
            try:
                st = fut.result()
                shape = tuple(st.frame.shape)
                if shape_ref[0] is None:
                    shape_ref[0] = shape
                elif shape != shape_ref[0]:
                    raise ValueError(
                        f"stream {info['name']} is {shape[:2]}, others "
                        f"{shape_ref[0][:2]}: all streams must share one "
                        "resolution")
                self._await_staged([st])
                loaded.append((info, st))
            except Exception as e:
                self.logger.error(
                    f"Failed to process {info['name']} frame: {e}")
                info["prev"] = info["prev_gray"] = None  # restart
        return loaded

    def _ms_cycle_flow_hits(self, loaded) -> Dict[int, tuple]:
        """Cycle pass 2 (device flow, ``flow_batch`` > 1, two or more live
        chains): the cycle's flows first, one replay a stream."""
        if self.temporal_flow_source != "device" \
                or self.temporal_flow_batch <= 1:
            return {}
        live = [k for k, (info, _) in enumerate(loaded)
                if info["prev"] is not None and info["prev_gray"] is not None]
        if len(live) < 2:
            return {}
        with self.spans("host/flow"):
            flows, grays = _temporal_flow_pairs(
                [loaded[k][1].frame for k in live],
                [loaded[k][0]["prev_gray"] for k in live],
                [loaded[k][1].fmask for k in live],
                self.temporal_flow_scale, step=self.flow_graphs)
        return {k: (flows[t], grays[t]) for t, k in enumerate(live)}

    def _ms_cycle_prologue(self, loaded, flow_hits) -> List[tuple]:
        """Cycle pass 3: each stream's prologue (the single-stream
        chain's); a failed one restarts its own chain. -> [(info, staged,
        generator input, luma)]."""
        device_flow = self.temporal_flow_source == "device"
        batch = []
        for k, (info, st) in enumerate(loaded):
            try:
                full, gray = self._chain_prologue(
                    st.frame, (info["prev"], info["prev_gray"]),
                    aux=st.fmask if device_flow else st.flow,
                    flow_hit=flow_hits.get(k),
                    label=f"{info['name']}/{st.path.name}")
                batch.append((info, st, full, gray))
            except Exception as e:
                self.logger.error(
                    f"Failed to process {info['name']} frame: {e}")
                info["prev"] = info["prev_gray"] = None  # restart
        return batch

    def _ms_dispatch_cycle(self, batch, pipe: GroupPipeline,
                           output_dir: Path) -> None:
        """Cycle pass 4: every prepared frame in ONE dispatch (the mode
        rule in the module's docstring), each chain's carry advanced, the
        readbacks queued on the pipeline, each cropped to its own frame's
        box."""
        if len(batch) == 1:
            _, st, full, _ = batch[0]
            u8, out, _ = self._stylize_device(full, st.mask, st.boxes)
            u8s, outs = u8[None], out[None]
        else:
            with self.spans("host/stack"):
                frames = torch.stack([b[2] for b in batch])
                masks = stack_masks([b[1] for b in batch])
            u8s, outs = self._stylize_group(frames, masks,
                                            [b[1].boxes for b in batch])
        for k, (info, _, _, gray) in enumerate(batch):
            info["prev"] = outs[k]
            if self.temporal_flow_source == "device":
                info["prev_gray"] = gray
        pipe.submit([b[1] for b in batch], u8s,
                    paths=[output_dir / b[0]["name"] / b[1].path.name
                           for b in batch], per_frame=True)

    def _ms_run_cycles(self, infos, pipe: GroupPipeline, pool, output_dir,
                       shape_ref) -> None:
        """Every stream's file queue as interleaved chain cycles, the next
        cycle's frames loading on ``pool`` meanwhile. The carries stay on
        the info dicts, so a caller that keeps them continues the chains;
        every readback is drained before returning, an interrupt
        included."""
        def submit_loads():
            return [(info, pool.submit(self._ms_load_frame, info,
                                       info["idx"]))
                    for info in infos if info["idx"] < len(info["files"])]

        subs = submit_loads()
        try:
            while subs:
                for info, _ in subs:
                    info["idx"] += 1
                next_subs = submit_loads()
                loaded = self._ms_resolve_loads(subs, shape_ref)
                flow_hits = self._ms_cycle_flow_hits(loaded)
                batch = self._ms_cycle_prologue(loaded, flow_hits)
                if batch:
                    self._ms_dispatch_cycle(batch, pipe, output_dir)
                subs = next_subs
        finally:
            pipe.drain_all()  # a failed readback is logged, not raised

    def _ms_check_devices(self) -> None:
        if self.devices_cfg != 1:
            raise ValueError(
                "multi-stream temporal serving is per-device (inference."
                "devices=1); run one process per card and shard streams")

    def _ms_pipeline(self, output_dir: Path, n_streams: int):
        writer = FrameWriter(num_threads=2, compress_level=1)
        pipe = GroupPipeline(self, writer, output_dir)
        # frames in flight: one cycle of every stream beyond the JAX bound
        pipe.window = self.readback_streams + n_streams
        return writer, pipe

    def _process_multistream(self, streams, input_dir: Path, mask_dir: Path,
                             output_dir: Path) -> int:
        """Serve N videos, one subdirectory each, as interleaved chains on
        one device (see the module's docstring); in a process group of
        several ranks each serves every world-th stream from its rank
        (JAX ``multistream.py:372-377``). -> frames written."""
        self._ms_check_devices()
        if comm.world() > 1:
            streams = streams[comm.rank()::comm.world()]
            self.logger.info(f"Rank {comm.rank()} of {comm.world()} serves "
                             f"streams {streams}")
        flow_root = self.temporal_flow_dir or None
        infos = []
        for s in streams:
            infos.append(self._ms_info(s, _image_files(input_dir / s),
                                       mask_dir, flow_root))
            (output_dir / s).mkdir(parents=True, exist_ok=True)
        total = sum(len(i["files"]) for i in infos)
        self.logger.info(
            f"Multi-stream temporal serving: {len(infos)} streams, {total} "
            f"frames, co-batched {len(infos)} frames/dispatch")
        writer, pipe = self._ms_pipeline(output_dir, len(infos))
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            self._ms_run_cycles(infos, pipe, pool, output_dir, [None])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            failed = self._finish(pipe, writer)
        return pipe.submitted - failed

    def _watch_multistream(self, wcfg) -> None:
        """Watch-serve N videos as persistent chains (JAX
        ``multistream.py:408-575``): each poll picks up every stream's
        settled new frames in order (a frame whose mask or guides are
        missing blocks its own stream, never the others) and runs them
        through the cycles. Chains, flow positions, the resolution pin and
        the warm programs persist across polls; a new stream joins once
        its mask directory exists (when masks are needed); frames already
        stylized at start keep their stream positions. In a process group
        of several ranks a rank serves the streams whose name's CRC-32
        modulo the world is its rank (JAX ``multistream.py:447-451``)."""
        self._ms_check_devices()
        poll, idle_timeout, max_attempts, aux_warn_after = \
            watch_settings(wcfg)
        world, me = comm.world(), comm.rank()
        paths = self.cfg["paths"]
        input_dir = Path(paths["input_dir"])
        output_dir = Path(paths["output_dir"])
        mask_dir = Path(paths["mask_dir"])
        mask_needed = not mask_dir.name.endswith("ignore")
        flow_root = self.temporal_flow_dir or None
        writer, pipe = self._ms_pipeline(output_dir, 1)
        pool = ThreadPoolExecutor(max_workers=2)
        shape_ref = [None]
        infos: Dict[str, dict] = {}
        done: Dict[str, Set[str]] = {}
        attempts: Dict[str, int] = {}
        waiting_since: Dict[str, float] = {}
        aux_warned: Set[str] = set()
        idle = 0.0
        self.logger.info(
            f"Watching {input_dir} (multi-stream temporal, poll {poll}s, "
            f"idle timeout {idle_timeout or 'none'})")
        try:
            while True:
                now = time.time()
                for s in self._detect_streams(input_dir):
                    if s in infos or (world > 1 and zlib.crc32(s.encode())
                                      % world != me):
                        continue
                    if mask_needed and not (mask_dir / s).exists():
                        continue  # the producer has not made it yet
                    info = self._ms_info(s, [], mask_dir, flow_root)
                    (output_dir / s).mkdir(parents=True, exist_ok=True)
                    prior = {q.name for q in _image_files(output_dir / s)}
                    info["members"] |= prior  # keep restart positions
                    done[s] = set(prior)
                    infos[s] = info
                    pipe.window = self.readback_streams + len(infos)
                    self.logger.info(f"Stream {s}: serving" + (
                        f" ({len(prior)} already stylized)" if prior
                        else ""))
                new_total = 0
                for s, info in infos.items():
                    fresh = []
                    for p in _image_files(input_dir / s):
                        if p.name in done[s] \
                                or (output_dir / s / p.name).exists():
                            info["members"].add(p.name)
                            done[s].add(p.name)
                            continue
                        key = f"{s}/{p.name}"
                        try:
                            if p.stat().st_mtime > now - max(0.25, poll / 2):
                                break  # settling: this stream waits
                        except OSError:
                            break
                        info["members"].add(p.name)
                        if not self._aux_ready(p, info["mdir"],
                                               info["chans"],
                                               info["masked"]):
                            first = waiting_since.setdefault(key, now)
                            if key not in aux_warned \
                                    and now - first >= aux_warn_after:
                                aux_warned.add(key)
                                self.logger.warning(
                                    f"{key}: mask/guide channels still "
                                    f"missing after {now - first:.0f}s; its "
                                    "stream stays blocked until they arrive")
                            break  # chain order: only this stream blocks
                        waiting_since.pop(key, None)
                        aux_warned.discard(key)
                        fresh.append(p)
                    info["files"] = fresh
                    info["idx"] = 0
                    new_total += len(fresh)
                if new_total:
                    try:
                        self._ms_run_cycles(list(infos.values()), pipe, pool,
                                            output_dir, shape_ref)
                    except Exception as e:
                        # the service outlives a bad batch; attempts decide
                        self.logger.error(f"Batch failed: {e}")
                    with self.spans("host/writer_drain"):
                        failed = writer.flush()
                    if failed:
                        self.logger.error(f"{failed} frame writes failed")
                    for s, info in infos.items():
                        for p in info["files"]:
                            key = f"{s}/{p.name}"
                            if (output_dir / s / p.name).exists():
                                done[s].add(p.name)
                                idle = 0.0
                            else:
                                attempts[key] = attempts.get(key, 0) + 1
                                if attempts[key] >= max_attempts:
                                    self.logger.error(
                                        f"Giving up on {key} after "
                                        f"{max_attempts} attempts")
                                    done[s].add(p.name)
                    self.logger.info(
                        f"Stylized {new_total} new frame(s) across "
                        f"{len(infos)} stream(s)")
                time.sleep(poll)
                idle += poll
                if idle_timeout and idle >= idle_timeout:
                    self.logger.info(
                        f"No new frames for {idle:.0f}s; stopping watch")
                    return
        except KeyboardInterrupt:
            # _ms_run_cycles drained its readbacks in its own finally; the
            # finally below flushes the writer
            self.logger.info("Multi-stream watch interrupted; pending "
                             "frames flushed, shutting down")
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            self._finish(pipe, writer)
