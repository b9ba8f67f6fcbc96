"""Watch mode: serve an input directory as a long-running service.

Counterpart of ``patch_toon_tpu/infer/watch.py`` (``watch_directory``,
``_watch_poll_loop``), mixed into the engine as the temporal chain is. Each
poll picks up the frames that have no output yet and whose ``mtime`` has
settled (older than ``max(0.25, poll_seconds / 2)``), and whose mask and
guide channels exist (``aux_ready``: a frame waiting for them is not an
attempt; after ``aux_warn_seconds`` it is warned about once); the new
frames go through :meth:`process_directory` with ``files=``, so the model,
the cuDNN plans, the pinned pools and, with the temporal guide, the
chain's carry stay warm between polls. A frame with no output after a run
counts an attempt and is given up after ``max_attempts``; the loop stops
after ``idle_timeout_seconds`` without a new output (null or 0: run until
interrupted). With the temporal guide a frame joins the stream once it
settles, aux files or not, and a blocked frame holds the later ones back,
so the chain advances in stream order; outputs already on disk register
their frames as members, so flow positions survive a restart. An
interrupt (Ctrl-C, or SIGTERM through the CLI) returns once every
dispatched frame is on disk: ``process_directory`` drains in its
``finally``.

In a process group of several ranks (``parallel.dcn.enabled``) each rank
serves the frames whose name's CRC-32 modulo the world is its rank (a
stable split: a list index would move frames between ranks as the pending
lists shrink); with the temporal guide rank 0 alone serves, the chain
being sequential (JAX ``watch.py:49-81, 143``). A subdirectory per video
with the temporal guide is watched by
``infer/multistream.py::_watch_multistream``.
"""

from __future__ import annotations

import os
import time
import zlib
from pathlib import Path
from typing import Dict, Set

from patch_toon_tpu_torch.data.io import find_corresponding_image
from patch_toon_tpu_torch.infer.common import _image_files
from patch_toon_tpu_torch.parallel import comm


def watch_settings(wcfg) -> tuple:
    """(poll, idle timeout (0: none), max attempts, aux warn seconds) of
    ``inference.watch``, with the JAX defaults."""
    return (float(wcfg.get("poll_seconds", 1.0)),
            float(wcfg.get("idle_timeout_seconds") or 0),
            int(wcfg.get("max_attempts", 3)),
            float(wcfg.get("aux_warn_seconds", 30.0)))


class WatchMixin:
    """The flat-directory watch loop of ``StyleTransferInference``."""

    def watch_directory(self) -> None:
        """Serve ``paths.input_dir`` until the idle timeout or an interrupt
        (see the module's docstring)."""
        inf = self.cfg.get("inference", {}) or {}
        if inf.get("file_shard"):
            raise ValueError(
                "inference.watch shards by name hash automatically; "
                "file_shard's index round-robin is unstable across polls")
        wcfg = inf.get("watch") or {}
        paths = self.cfg["paths"]
        input_dir = Path(paths["input_dir"])
        if self.temporal_enabled and self._detect_streams(input_dir):
            # a subdirectory per video, decided once, at watch start
            return self._watch_multistream(wcfg)
        if self.temporal_enabled and comm.world() > 1 and comm.rank() != 0:
            self.logger.warning(
                "Temporal watch is sequential; only rank 0 serves (shard "
                "whole videos with the subdirectory-per-stream layout "
                "instead)")
            return
        poll, idle_timeout, max_attempts, aux_warn = watch_settings(wcfg)
        self.logger.info(f"Watching {input_dir} (poll {poll}s, idle timeout "
                         f"{idle_timeout or 'none'})")
        try:
            self._watch_poll_loop(poll, idle_timeout, max_attempts, aux_warn,
                                  input_dir, Path(paths["output_dir"]),
                                  Path(paths["mask_dir"]))
        except KeyboardInterrupt:
            # every dispatched frame reached disk in process_directory's
            # finally before this propagated
            self.logger.info(
                "Watch interrupted; pending frames flushed, shutting down")

    def _aux_ready(self, p: Path, mask_dir: Path, channels,
                   need_mask: bool) -> bool:
        """The frame's mask (when ``need_mask``) and every guide channel
        exist: producers often write the frame first."""
        if need_mask and not os.path.exists(
                find_corresponding_image(str(mask_dir), p.name)):
            return False
        return all(os.path.exists(find_corresponding_image(c["path"], str(p)))
                   for c in channels.values())

    def _watch_poll_loop(self, poll: float, idle_timeout: float,
                         max_attempts: int, aux_warn_after: float,
                         input_dir: Path, output_dir: Path,
                         mask_dir: Path) -> None:
        done: Set[str] = set()
        attempts: Dict[str, int] = {}
        waiting_since: Dict[str, float] = {}
        aux_warned: Set[str] = set()
        world, me = comm.world(), comm.rank()
        idle = 0.0
        while True:
            now = time.time()
            new = []
            for p in _image_files(input_dir):
                if p.name in done or (output_dir / p.name).exists():
                    if self.temporal_enabled:
                        # outputs prove membership, also across a restart
                        self._temporal_register(p.name)
                    done.add(p.name)
                    continue
                if world > 1 and not self.temporal_enabled \
                        and zlib.crc32(p.name.encode()) % world != me:
                    continue  # a peer's frame
                try:
                    settling = p.stat().st_mtime > now - max(0.25, poll / 2)
                except OSError:
                    settling = True
                if settling:
                    if self.temporal_enabled:
                        break  # chain order: later frames wait behind
                    continue  # possibly still being written
                if self.temporal_enabled:
                    # a settled frame is a stream member even while its
                    # aux files are missing, and after it is given up
                    self._temporal_register(p.name)
                if not self._aux_ready(p, mask_dir, self.additional_channels,
                                       not mask_dir.name.endswith("ignore")):
                    first = waiting_since.setdefault(p.name, now)
                    if p.name not in aux_warned \
                            and now - first >= aux_warn_after:
                        aux_warned.add(p.name)
                        self.logger.warning(
                            f"{p.name}: mask/guide channels still missing "
                            f"after {now - first:.0f}s; frame stays pending "
                            "until they arrive")
                    if self.temporal_enabled:
                        break
                    continue
                waiting_since.pop(p.name, None)
                aux_warned.discard(p.name)
                new.append(p)
            if new:
                try:
                    self.process_directory(files=new)
                except Exception as e:
                    # the service outlives a bad batch; attempts decide
                    self.logger.error(f"Batch failed: {e}")
                for p in new:
                    if (output_dir / p.name).exists():
                        done.add(p.name)
                        idle = 0.0
                    else:
                        attempts[p.name] = attempts.get(p.name, 0) + 1
                        if attempts[p.name] >= max_attempts:
                            self.logger.error(f"Giving up on {p.name} after "
                                              f"{max_attempts} attempts")
                            done.add(p.name)
                self.logger.info(f"Stylized {len(new)} new frame(s); "
                                 f"{len(done)} total")
            time.sleep(poll)
            idle += poll
            if idle_timeout and idle >= idle_timeout:
                self.logger.info(
                    f"No new frames for {idle:.0f}s; stopping watch")
                return
