"""Functional random keys for the port.

The reference threads ``jax.random`` keys through every hop: ``split`` per
round, per client, ``fold_in`` per leaf and per chain stage, and finally a
``uniform`` draw for QSGD's stochastic rounding (and UVeQ's dither and
RandMask's scores), or a ``normal`` draw for RandMask's noise.  The port
keeps the same key *structure* with :class:`Key`, a counter path hashed
into the seed of a ``torch.Generator`` on the device at the draw.  It does
not reproduce ``jax.random``'s bits; a test that needs the reference's
draws passes its own object with the same four methods (``split``,
``fold_in``, ``uniform`` and ``normal``), backed by ``jax.random``.
"""
from __future__ import annotations

import hashlib
import struct

import torch


class Key:
    """A deterministic key: a seed and the path of splits and fold-ins."""

    __slots__ = ("seed", "path")

    def __init__(self, seed: int, path: tuple = ()):
        self.seed = int(seed)
        self.path = tuple(path)

    def split(self, n: int) -> list:
        return [Key(self.seed, self.path + (("s", i),)) for i in range(n)]

    def fold_in(self, data: int) -> "Key":
        return Key(self.seed, self.path + (("f", int(data)),))

    def seed_int(self) -> int:
        """A 63-bit integer digest of (seed, path)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(struct.pack("<q", self.seed))
        for tag, v in self.path:
            h.update(tag.encode())
            h.update(struct.pack("<q", v))
        return int.from_bytes(h.digest(), "little") >> 1

    def _generator(self, device) -> torch.Generator:
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.seed_int())
        return g

    def uniform(self, shape, device) -> torch.Tensor:
        """f32 uniforms in [0, 1) of ``shape`` on ``device``, from a
        ``torch.Generator`` on that device seeded with :meth:`seed_int`."""
        return torch.rand(tuple(shape), generator=self._generator(device),
                          dtype=torch.float32, device=device)

    def normal(self, shape, device) -> torch.Tensor:
        """f32 standard normals of ``shape`` on ``device``, from the same
        generator as :meth:`uniform`."""
        return torch.randn(tuple(shape), generator=self._generator(device),
                           dtype=torch.float32, device=device)


def PRNGKey(seed: int) -> Key:
    """The root key of a run (the reference's ``jax.random.PRNGKey``)."""
    return Key(seed)
