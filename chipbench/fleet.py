"""Simulated clients over a few template uploads (after the port's
`serve.sim.Fleet`, kept here so that the traffic cannot change with the
program).

Each simulated client's blob is a template with the cid, n_samples and
round of its UPDATE_BEGIN frame rewritten: byte surgery, no HE.  The
server pays the whole parse, expansion and fold of every blob.

    [16 B frame header][u32 cid][u32 n_samples][u32 round][u32 n_chunks][u8]
"""
from __future__ import annotations

import struct

HEADER_BYTES = 16
_BEGIN_TYPE = 0x06
_FIELDS = struct.Struct("<III")      # cid, n_samples, round


def rewrite_begin(blob: bytes, cid: int, n_samples: int, rnd: int) -> bytes:
    """The template with its header's cid, n_samples and round replaced:
    one copy of the blob, as a receive buffer would hold it."""
    if blob[:4] != b"RPWR" or blob[5] != _BEGIN_TYPE:
        raise ValueError("a template must start with UPDATE_BEGIN")
    head = bytes(blob[:HEADER_BYTES]) + _FIELDS.pack(cid, n_samples, rnd)
    return b"".join((head, memoryview(blob)[HEADER_BYTES + _FIELDS.size:]))


class Fleet:
    """`n_clients` clients over `templates`: client c is template
    c % len(templates), with its own sample count."""

    def __init__(self, templates: list, n_samples: list):
        self.templates = templates
        self.n_samples = n_samples

    @property
    def n_clients(self) -> int:
        return len(self.n_samples)

    def template_of(self, cid: int) -> int:
        return cid % len(self.templates)

    def blob(self, cid: int, rnd: int) -> bytes:
        return rewrite_begin(self.templates[self.template_of(cid)], cid,
                             self.n_samples[cid], rnd)
