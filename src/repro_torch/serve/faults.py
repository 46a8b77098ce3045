"""Deterministic fault injector: the aggregation service's adversary (the
JAX package's `repro.serve.faults`, byte for byte).

Two fault families, both driven by a seeded RNG so every failure a test
observes is replayable from its seed:

  * **wire faults** (`corrupt_blob`) — byte-level surgery on one client's
    serialized update stream: drop / duplicate a CT_CHUNK frame, truncate
    the blob, overwrite a frame header with garbage, or reorder the chunk
    frames.  ``delay`` is a timing fault (the blob is untouched; the
    driver submits it after the round deadline).  Every mode except
    ``reorder`` and ``delay`` must be REJECTED by the service with the
    aggregate untouched (StreamIngest's atomic per-update rollback);
    ``reorder`` must be accepted bit-identically (chunk index order is
    not part of the wire contract) and ``delay`` is rejected at submit.

  * **crash points** (`FaultInjector.crash_point`) — named points between
    service transitions where a `SimulatedCrash` is raised AFTER the
    state was checkpointed, simulating `kill -9`.  The test restarts via
    `AggregationService.resume` and asserts a bit-exact round.

The RNG is numpy's `RandomState`, and each mode makes the reference's
draws in the reference's order, so the same blob, mode and seed give the
same faulty bytes in both packages.

Scope note (DESIGN.md §14.4): garbage targets frame STRUCTURE (magic /
length fields), not ciphertext payload bytes — a flipped bit inside the
u32 residue body is indistinguishable from a valid residue vector, so
payload integrity is the transport's job (TLS/QUIC), while the service
owns structural validation and atomicity.
"""
from __future__ import annotations

import numpy as np

from repro_torch.wire import format as wf

FAULT_MODES = ("drop", "duplicate", "truncate", "garbage", "delay",
               "reorder")

# the service transitions a crash can fire after (service.py calls these)
CRASH_POINTS = ("after_open", "after_accept", "after_seal",
                "after_fold_step", "after_finalize")


class SimulatedCrash(RuntimeError):
    """Raised at an armed crash point: the in-process stand-in for
    `kill -9`.  State written before the raise is exactly what a real
    crash would leave on disk (ckpt/store.py writes are atomic)."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at service transition "
                         f"'{point}'")
        self.point = point


def split_frames(blob: bytes) -> list[bytes]:
    """Split a frame stream into whole re-concatenable frames (`bytes`
    slices: `parse_frame` hands out memoryview payloads)."""
    out, off = [], 0
    while off < len(blob):
        _, _, _, end = wf.parse_frame(blob, off)
        out.append(bytes(blob[off:end]))
        off = end
    return out


def _chunk_positions(frames: list[bytes]) -> list[int]:
    idx = []
    for i, fr in enumerate(frames):
        ftype, _, _, _ = wf.parse_frame(fr, 0)
        if ftype == wf.T_CT_CHUNK:
            idx.append(i)
    return idx


def corrupt_blob(blob: bytes, mode: str,
                 rng: np.random.RandomState) -> bytes:
    """Apply one wire fault to a client's update stream.

    Args:
        blob: the clean serialized frame stream (pack_update_frames).
        mode: one of FAULT_MODES.
        rng: seeded RandomState — all choices (which chunk, where to cut,
            which permutation) are drawn from it.

    Returns:
        The faulty bytes.  ``delay`` returns the blob unchanged (the
        fault is WHEN it is submitted, not what).
    """
    if mode not in FAULT_MODES:
        raise ValueError(f"unknown fault mode {mode!r}; choose from "
                         f"{FAULT_MODES}")
    if mode == "delay":
        return blob
    if mode == "truncate":
        # cut inside the stream: anywhere from mid-first-frame to one byte
        # short of complete
        cut = int(rng.randint(1, len(blob)))
        return blob[:cut]
    frames = split_frames(blob)
    chunks = _chunk_positions(frames)
    if mode in ("drop", "duplicate", "reorder") and not chunks:
        raise ValueError(f"fault mode {mode!r} needs at least one CT_CHUNK "
                         "frame in the blob")
    if mode == "drop":
        del frames[chunks[int(rng.randint(len(chunks)))]]
    elif mode == "duplicate":
        i = chunks[int(rng.randint(len(chunks)))]
        frames.insert(i, frames[i])
    elif mode == "garbage":
        # overwrite a frame header's magic with non-MAGIC bytes: the frame
        # chain breaks there and the decoder must reject, never over-read
        i = int(rng.randint(len(frames)))
        bad = bytearray(frames[i])
        junk = bytes(int(b) for b in rng.randint(0, 256, size=4))
        if junk == wf.MAGIC:                    # one-in-2^32, still seal it
            junk = bytes([junk[0] ^ 0xFF]) + junk[1:]
        bad[:4] = junk
        frames[i] = bytes(bad)
    elif mode == "reorder":
        # permute the CT_CHUNK frames among themselves (envelope frames
        # stay put); chunk order is explicitly NOT part of the contract
        perm = rng.permutation(len(chunks))
        if len(chunks) > 1:
            while all(int(p) == i for i, p in enumerate(perm)):
                perm = rng.permutation(len(chunks))
        reordered = [frames[chunks[int(p)]] for p in perm]
        for slot, fr in zip(chunks, reordered):
            frames[slot] = fr
    return b"".join(frames)


class FaultInjector:
    """Deterministic fault schedule for one service run.

    Args:
        seed: RNG seed for every byte-level choice.
        crash_at: iterable of CRASH_POINTS names; each armed point fires
            `SimulatedCrash` ONCE (then disarms, so the resumed service
            sails past it).
        blob_faults: optional {cid: mode} map; `corrupt(cid, blob)`
            applies the scheduled mode to that client's bytes and leaves
            every other client untouched.
    """

    def __init__(self, seed: int = 0, crash_at=(),
                 blob_faults: dict[int, str] | None = None):
        self.rng = np.random.RandomState(seed)
        unknown = set(crash_at) - set(CRASH_POINTS)
        if unknown:
            raise ValueError(f"unknown crash point(s) {sorted(unknown)}; "
                             f"choose from {CRASH_POINTS}")
        self.armed = set(crash_at)
        self.fired: list[str] = []
        self.blob_faults = dict(blob_faults or {})

    def corrupt(self, cid: int, blob: bytes) -> bytes:
        """Apply this client's scheduled wire fault (if any)."""
        mode = self.blob_faults.get(cid)
        return blob if mode is None else corrupt_blob(blob, mode, self.rng)

    def crash_point(self, name: str) -> None:
        """Crash here iff `name` is armed (fires once, then disarms)."""
        if name in self.armed:
            self.armed.discard(name)
            self.fired.append(name)
            raise SimulatedCrash(name)
