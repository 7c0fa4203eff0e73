"""Functional random keys for the port.

The reference threads ``jax.random`` keys through every hop: ``split`` per
round, per client, ``fold_in`` per leaf and per chain stage, and finally a
``uniform`` draw for QSGD's stochastic rounding (and UVeQ's dither and
RandMask's scores), a ``normal`` draw for RandMask's and DPNoise's noise,
a ``randint`` / ``permutation`` draw for a population's cohort, or a
``bits`` draw for a SecAgg ring mask.  The port
keeps the same key *structure* with :class:`Key`, a counter path hashed
into the seed of a ``torch.Generator`` on the device at the draw.  It does
not reproduce ``jax.random``'s bits; a test that needs the reference's
draws passes its own object with the same seven methods (``split``,
``fold_in``, ``uniform``, ``normal``, ``randint``, ``permutation`` and
``bits``), backed by ``jax.random``.

A payload that carries a key (UVeQ's ``useed``, RandMask's ``seed``)
crosses ranks as the key's *plane*: :meth:`Key.plane` is one int64, the
key's 63-bit digest, and :meth:`Key.from_plane` rebuilds on the receiver
a key whose draws are the sender's (its own splits and fold-ins start
from the digest).  A test's key object crosses the same way through its
own ``plane`` / ``from_plane``.
"""
from __future__ import annotations

import hashlib
import struct

import torch


class Key:
    """A deterministic key: a seed and the path of splits and fold-ins
    (or a digest received from another rank, :meth:`from_digest`)."""

    __slots__ = ("seed", "path", "digest")

    def __init__(self, seed: int, path: tuple = ()):
        self.seed = int(seed)
        self.path = tuple(path)
        self.digest = None

    @classmethod
    def from_digest(cls, digest: int) -> "Key":
        """The key whose :meth:`seed_int` is ``digest``: it draws what the
        key of that digest draws."""
        k = cls(digest)
        k.digest = int(digest)
        return k

    def plane(self, device=None) -> torch.Tensor:
        """The key as a collective moves it: its digest, one int64."""
        return torch.tensor([self.seed_int()], dtype=torch.int64,
                            device=device)

    @classmethod
    def from_plane(cls, plane: torch.Tensor) -> "Key":
        """The key a received :meth:`plane` stands for."""
        return cls.from_digest(int(plane.reshape(-1)[0]))

    def split(self, n: int) -> list:
        return [Key(self.seed, self.path + (("s", i),)) for i in range(n)]

    def fold_in(self, data: int) -> "Key":
        return Key(self.seed, self.path + (("f", int(data)),))

    def seed_int(self) -> int:
        """A 63-bit integer digest of (seed, path)."""
        if self.digest is not None:
            return self.digest
        h = hashlib.blake2b(digest_size=8)
        h.update(struct.pack("<q", self.seed))
        for tag, v in self.path:
            h.update(tag.encode())
            h.update(struct.pack("<q", v))
        return int.from_bytes(h.digest(), "little") >> 1

    def generator(self, device) -> torch.Generator:
        """A ``torch.Generator`` on ``device`` seeded with
        :meth:`seed_int`: every draw of this key starts from it."""
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.seed_int())
        return g

    def uniform(self, shape, device) -> torch.Tensor:
        """f32 uniforms in [0, 1) of ``shape`` on ``device``, from a
        ``torch.Generator`` on that device seeded with :meth:`seed_int`."""
        return torch.rand(tuple(shape), generator=self.generator(device),
                          dtype=torch.float32, device=device)

    def normal(self, shape, device) -> torch.Tensor:
        """f32 standard normals of ``shape`` on ``device``, from the same
        generator as :meth:`uniform`."""
        return torch.randn(tuple(shape), generator=self.generator(device),
                           dtype=torch.float32, device=device)

    def randint(self, low: int, high: int, shape, device) -> torch.Tensor:
        """int64 integers in [low, high) of ``shape`` on ``device``."""
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self.generator(device),
                             dtype=torch.int64, device=device)

    def permutation(self, n: int, device) -> torch.Tensor:
        """A random permutation of ``range(n)``, int64 on ``device``."""
        return torch.randperm(int(n), generator=self.generator(device),
                              dtype=torch.int64, device=device)

    def bits(self, shape, width: int, device) -> torch.Tensor:
        """Full-entropy integers in [0, 2^width) of ``shape`` on
        ``device``, as int64 (``width`` 8, 16 or 32: the reference's
        ``jax.random.bits`` in ``uint{width}``)."""
        return torch.randint(0, 1 << int(width), tuple(shape),
                             generator=self.generator(device),
                             dtype=torch.int64, device=device)


def uniform_between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """f32 uniforms ``u`` in [0, 1) moved to [lo, hi) with
    ``jax.random.uniform``'s arithmetic, one rounding per op:
    ``max(lo, u * (hi - lo) + lo)``, the bounds and their difference
    rounded to f32 first."""
    f32 = dict(dtype=torch.float32, device=u.device)
    lo_t, hi_t = torch.tensor(lo, **f32), torch.tensor(hi, **f32)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def PRNGKey(seed: int) -> Key:
    """The root key of a run (the reference's ``jax.random.PRNGKey``)."""
    return Key(seed)
