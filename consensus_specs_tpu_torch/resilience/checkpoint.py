"""Crash-safe generational checkpoints (port of
consensus_specs_tpu/resilience/checkpoint.py; the frames are
byte-identical to the reference's).

Frame format (little-endian, 28-byte header):

    magic    4s   b"CSTP"
    version  u32  1
    gen      u64  generation number (monotonic per store)
    length   u64  payload byte count
    crc      u32  zlib.crc32(payload)
    payload  ...  serialized BeaconState bytes (ResidentCore.checkpoint_bytes)

Write protocol, so a kill at any instant leaves the previous good
generations intact:

    1. write the whole frame to `<root>/.tmp-<gen>` and fsync it;
    2. os.replace onto `<root>/state-<gen>.ckpt` (atomic on POSIX);
    3. fsync the directory so the rename itself is durable;
    4. prune generations beyond `keep`, never the newest valid one.

Read protocol: `load()` walks generations newest first, validating
magic, version, length and CRC; a corrupt generation is counted
(`resilience.checkpoint.corrupt_generations`) and skipped, so
`restore()` falls back to the previous good generation.

Fault hooks: writes go through `faults.on_checkpoint_write` (silent
truncate/bitflip, or `crash` = partial write + SimulatedCrash with no
rename), reads through `faults.on_checkpoint_read`.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Optional, Tuple

from . import faults
from .errors import CheckpointCorrupt, SimulatedCrash

MAGIC = b"CSTP"
VERSION = 1
_HEADER = struct.Struct("<4sIQQI")

_NAME_RE = re.compile(r"^state-(\d{8})\.ckpt$")


def frame(payload: bytes, generation: int) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, generation, len(payload),
                        zlib.crc32(payload)) + payload


def unframe(data: bytes, *, generation=None) -> Tuple[int, bytes]:
    """Validate a frame -> (generation, payload); raises CheckpointCorrupt
    on truncation, bad magic or version, length drift, a CRC mismatch, or
    a header generation other than `generation` (when given: the CRC
    does not cover the header, the file name does)."""
    if len(data) < _HEADER.size:
        raise CheckpointCorrupt(
            f"checkpoint frame truncated: {len(data)} bytes < "
            f"{_HEADER.size}-byte header", generation=generation)
    magic, version, gen, length, crc = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise CheckpointCorrupt(f"bad checkpoint magic {magic!r}",
                                generation=generation)
    if version != VERSION:
        raise CheckpointCorrupt(f"unsupported checkpoint version {version}",
                                generation=generation)
    payload = data[_HEADER.size:]
    if len(payload) != length:
        raise CheckpointCorrupt(
            f"checkpoint payload truncated: header claims {length} bytes, "
            f"found {len(payload)}", generation=generation)
    if zlib.crc32(payload) != crc:
        raise CheckpointCorrupt("checkpoint CRC mismatch (bit rot or a "
                                "torn write)", generation=generation)
    if generation is not None and gen != generation:
        raise CheckpointCorrupt(
            f"checkpoint header claims generation {gen} but was read "
            f"from generation {generation}'s file (header bit rot)",
            generation=generation)
    return gen, payload


def _last_good_gauge():
    from .. import telemetry
    return telemetry.gauge("resilience.checkpoint.generation", always=True)


class CheckpointStore:
    """A directory of CRC-framed generations with atomic-rename writes
    and fallback past corrupt generations on read."""

    def __init__(self, root: str, keep: int = 4):
        assert keep >= 1, keep
        self.root = str(root)
        self.keep = keep
        # generations this store already counted corrupt: the counter
        # tallies distinct generations, not re-walks past the same one
        self._corrupt_counted = set()
        os.makedirs(self.root, exist_ok=True)

    # -- paths / listing ------------------------------------------------

    def path(self, generation: int) -> str:
        return os.path.join(self.root, f"state-{generation:08d}.ckpt")

    def generations(self) -> List[int]:
        """Committed generations, ascending (a crash mid-write leaves
        only a `.tmp-*` file, never listed)."""
        gens = []
        for name in os.listdir(self.root):
            m = _NAME_RE.match(name)
            if m:
                gens.append(int(m.group(1)))
        return sorted(gens)

    def latest_generation(self) -> Optional[int]:
        gens = self.generations()
        return gens[-1] if gens else None

    # -- write ----------------------------------------------------------

    def save(self, payload: bytes, generation: Optional[int] = None) -> int:
        """Frame and atomically commit `payload` as the next generation;
        returns its number. A `crash` fault writes a partial temp file
        and raises SimulatedCrash before the rename."""
        from .. import telemetry
        gen = generation if generation is not None \
            else (self.latest_generation() or 0) + 1
        data = frame(payload, gen)
        data_out, crash = faults.on_checkpoint_write(data)
        tmp = os.path.join(self.root, f".tmp-{gen:08d}")
        with telemetry.span("resilience.checkpoint.save", generation=gen):
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                # os.write may write short (single-call caps near 2 GiB)
                view = memoryview(data_out)
                while view:
                    view = view[os.write(fd, view):]
                if crash:
                    # a kill flushes nothing: close without fsync, no rename
                    raise SimulatedCrash(
                        f"injected kill mid-write of generation {gen} "
                        f"({len(data_out)}/{len(data)} bytes hit disk)")
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, self.path(gen))
            dirfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        telemetry.counter("resilience.checkpoint.saves", always=True).inc()
        # last good is a validated claim: the bytes that went to disk
        # (after any write fault) must frame-check, in memory
        try:
            unframe(bytes(data_out), generation=gen)
            ok = True
        except CheckpointCorrupt:
            ok = False
        if ok:
            _last_good_gauge().set(gen)
        self._prune(known={gen: ok})
        return gen

    def _prune(self, known: Optional[dict] = None) -> None:
        """Drop generations beyond `keep`, but never the newest one that
        still validates: under persistent silent write corruption a
        count-based prune would evict the last good generation. `known`
        caches {generation: validity}; the kept set is probed newest
        first, so a good fresh save costs no extra read."""
        known = dict(known or {})

        def valid(g: int) -> bool:
            if g not in known:
                known[g] = self._validates(g)
            return known[g]

        gens = self.generations()
        doomed = gens[:-self.keep]
        if not doomed:
            return
        if not any(valid(g) for g in reversed(gens[-self.keep:])):
            for gen in reversed(doomed):
                if valid(gen):
                    doomed = [g for g in doomed if g != gen]
                    break
        for gen in doomed:
            try:
                os.remove(self.path(gen))
            except OSError:
                pass

    def _validates(self, generation: int) -> bool:
        """Frame-validity probe for the prune: reads the raw file, not
        through faults.on_checkpoint_read (housekeeping must not spend
        the read fault's occurrences)."""
        try:
            with open(self.path(generation), "rb") as f:
                unframe(f.read(), generation=generation)
            return True
        except (OSError, CheckpointCorrupt):
            return False

    # -- read -----------------------------------------------------------

    def load(self, generation: Optional[int] = None) -> Tuple[int, bytes]:
        """-> (generation, payload) of `generation`, or of the newest
        generation that validates. Corrupt generations are counted and
        skipped; raises CheckpointCorrupt when nothing intact remains."""
        from .. import telemetry
        gens = ([generation] if generation is not None
                else list(reversed(self.generations())))
        last_exc: Optional[CheckpointCorrupt] = None
        for gen in gens:
            try:
                with open(self.path(gen), "rb") as f:
                    data = f.read()
            except OSError as exc:
                last_exc = CheckpointCorrupt(
                    f"generation {gen} unreadable: {exc}", generation=gen)
                continue
            data = faults.on_checkpoint_read(data)
            try:
                _, payload = unframe(data, generation=gen)
            except CheckpointCorrupt as exc:
                if gen not in self._corrupt_counted:
                    self._corrupt_counted.add(gen)
                    telemetry.counter(
                        "resilience.checkpoint.corrupt_generations",
                        always=True).inc()
                last_exc = exc
                continue
            if generation is None:
                # only the newest-first walk advances the last-good gauge:
                # inspecting an older generation must not regress it
                _last_good_gauge().set(gen)
            return gen, payload
        raise last_exc or CheckpointCorrupt(
            f"no checkpoint generations in {self.root!r}")

    def restore(self, spec, mesh=None, generation: Optional[int] = None):
        """-> (generation, ResidentCore) resumed from the newest intact
        generation (or `generation`): on `spec`'s device, or sharded over
        `mesh` (a parallel.sharding.ServingMesh), which may differ from
        the mesh the checkpoint was written under: the payload is logical
        bytes. The caller replays the slots since the checkpoint."""
        from ..models.phase0.resident import ResidentCore
        gen, payload = self.load(generation)
        return gen, ResidentCore.from_checkpoint(spec, payload, mesh=mesh)


def last_good_generation() -> Optional[int]:
    """The most recent generation any store in this process saved or
    validated (what /healthz reports); None before the first."""
    from .. import telemetry
    value = telemetry.gauge("resilience.checkpoint.generation",
                            always=True).value
    return int(value) if value else None
