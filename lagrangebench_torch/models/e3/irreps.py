"""O(3) irreducible-representation bookkeeping and the feature container.

Counterpart of ``lagrangebench_tpu/models/e3/irreps.py``. ``Irrep``,
``MulIrrep`` and ``Irreps`` are the same pure-Python types: parsing
"2x1o + 1x0e" strings, dimensions, slices, ``simplify``, ``sort`` and the
selection rule of the tensor product. Groups keep their declared order.
Basis convention: l=1 components are ordered (x, y, z) (see basis.py).

``IrrepsArray`` holds features whose trailing axis is laid out by
``irreps``. The flat layout at the boundaries is the JAX package's
**m-major** order: each group's flat chunk is the row-major flattening of
``(2l+1, mul)``. Inside, a group is one stacked ``(..., 2l+1, mul)``
tensor: the tensor products contract its m axis with small batched
products and its mul axis with one GEMM per output irrep, so a group never
splits into per-m arrays (the JAX package's per-m parts dodge the TPU's
(8, 128) tile padding, which the card does not have). An array is backed
either by one flat tensor (its chunks are views into it) or by its chunks
(the flat tensor is made once, on demand).
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch


class Irrep(NamedTuple):
    """One irreducible representation: degree l and parity p (+1/-1)."""

    l: int
    p: int

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __str__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    @classmethod
    def parse(cls, s: str) -> "Irrep":
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        assert m, f"Cannot parse irrep {s!r}"
        return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        """Selection rule of the tensor product."""
        return [Irrep(l, self.p * other.p)
                for l in range(abs(self.l - other.l), self.l + other.l + 1)]


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __str__(self) -> str:
        return f"{self.mul}x{self.ir}"


class Irreps(tuple):
    """An ordered tuple of (multiplicity, Irrep) groups."""

    def __new__(cls, value: Union[str, Sequence, "Irreps"]) -> "Irreps":
        if isinstance(value, Irreps):
            return super().__new__(cls, value)
        groups = []
        if isinstance(value, str):
            for tok in value.split("+"):
                tok = tok.strip()
                if not tok:
                    continue
                if "x" in tok:
                    mul, ir = tok.split("x")
                    groups.append(MulIrrep(int(mul), Irrep.parse(ir)))
                else:
                    groups.append(MulIrrep(1, Irrep.parse(tok)))
        else:
            for item in value:
                if isinstance(item, MulIrrep):
                    groups.append(item)
                else:
                    mul, ir = item
                    if not isinstance(ir, Irrep):
                        ir = Irrep.parse(ir) if isinstance(ir, str) else Irrep(*ir)
                    groups.append(MulIrrep(int(mul), ir))
        return super().__new__(cls, groups)

    @property
    def dim(self) -> int:
        return sum(g.dim for g in self)

    @property
    def num_irreps(self) -> int:
        return sum(g.mul for g in self)

    @property
    def lmax(self) -> int:
        return max((g.ir.l for g in self), default=0)

    def count(self, ir: Union[str, Irrep]) -> int:
        if isinstance(ir, str):
            ir = Irrep.parse(ir)
        return sum(g.mul for g in self if g.ir == ir)

    def slices(self) -> List[slice]:
        out, start = [], 0
        for g in self:
            out.append(slice(start, start + g.dim))
            start += g.dim
        return out

    def simplify(self) -> "Irreps":
        """Merge consecutive groups with the same irrep; drop empty ones."""
        groups: List[MulIrrep] = []
        for g in self:
            if g.mul == 0:
                continue
            if groups and groups[-1].ir == g.ir:
                groups[-1] = MulIrrep(groups[-1].mul + g.mul, g.ir)
            else:
                groups.append(g)
        return Irreps(groups)

    def sort(self) -> "Irreps":
        """Stable sort groups by (l, p)."""
        return Irreps(sorted(self, key=lambda g: (g.ir.l, -g.ir.p)))

    def regroup(self) -> "Irreps":
        return self.sort().simplify()

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __mul__(self, n: int) -> "Irreps":
        return Irreps([MulIrrep(g.mul * n, g.ir) for g in self])

    __rmul__ = __mul__

    def __repr__(self) -> str:
        return "+".join(str(g) for g in self) or "Irreps()"

    @staticmethod
    def spherical_harmonics(lmax: int) -> "Irreps":
        """0e + 1o + 2e + ... up to lmax (parity (-1)^l)."""
        return Irreps([(1, Irrep(l, (-1) ** l)) for l in range(lmax + 1)])


class IrrepsArray:
    """Features whose trailing axis is laid out by ``irreps`` (m-major).

    Built from a flat ``array`` (..., irreps.dim) or from ``chunks``, one
    (..., 2l+1, mul) tensor per group; the other form is derived on demand
    (chunks as views of the flat tensor, the flat tensor by one
    concatenation, kept).
    """

    def __init__(self, irreps: Union[str, Irreps], array: Optional[torch.Tensor] = None,
                 chunks: Optional[List[torch.Tensor]] = None):
        self.irreps = Irreps(irreps)
        assert (array is None) != (chunks is None), "exactly one of array / chunks required"
        if array is not None:
            assert array.shape[-1] == self.irreps.dim, (
                f"array last dim {array.shape[-1]} != irreps dim {self.irreps.dim} "
                f"({self.irreps})")
        else:
            assert len(chunks) == len(self.irreps)
            for g, c in zip(self.irreps, chunks):
                assert tuple(c.shape[-2:]) == (g.ir.dim, g.mul), f"chunk does not match {g}"
        self._array = array
        self._chunks = chunks

    @classmethod
    def from_chunks(cls, irreps, chunks: List[torch.Tensor]) -> "IrrepsArray":
        return cls(irreps, chunks=chunks)

    @property
    def array(self) -> torch.Tensor:
        if self._array is None:
            flat = [c.reshape(c.shape[:-2] + (c.shape[-2] * c.shape[-1],))
                    for c in self._chunks]
            self._array = flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)
        return self._array

    def chunks(self) -> List[torch.Tensor]:
        """Per group (..., 2l+1, mul) tensors (views of the flat array)."""
        if self._chunks is None:
            # split, not sliced: one concatenation in the backward
            parts = self._array.split([g.dim for g in self.irreps], dim=-1)
            self._chunks = [p.unflatten(-1, (g.ir.dim, g.mul))
                            for g, p in zip(self.irreps, parts)]
        return self._chunks

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._array is not None:
            return tuple(self._array.shape)
        return tuple(self._chunks[0].shape[:-2]) + (self.irreps.dim,)

    def map_chunks(self, fn) -> "IrrepsArray":
        """The array with ``fn`` applied to every chunk."""
        return IrrepsArray.from_chunks(self.irreps, [fn(c) for c in self.chunks()])

    def __add__(self, other: "IrrepsArray") -> "IrrepsArray":
        assert self.irreps == other.irreps, f"cannot add {self.irreps} and {other.irreps}"
        return IrrepsArray.from_chunks(
            self.irreps, [a + b for a, b in zip(self.chunks(), other.chunks())])

    def __repr__(self):
        return f"IrrepsArray({self.irreps}, shape={self.shape})"


def from_mul_major(irreps: Union[str, Irreps], array: torch.Tensor) -> IrrepsArray:
    """An IrrepsArray from a mul-major flat array.

    External features are naturally (mul, 2l+1)-flattened (e.g. K stacked
    3-vectors); each group chunk is transposed into the (2l+1, mul) layout.
    Groups with mul == 1 or l == 0 are layout-invariant.
    """
    irreps = Irreps(irreps)
    chunks = [p.unflatten(-1, (g.mul, g.ir.dim)).transpose(-1, -2)
              for g, p in zip(irreps, array.split([g.dim for g in irreps], dim=-1))]
    return IrrepsArray.from_chunks(irreps, chunks)


def concatenate(arrays: List[IrrepsArray]) -> IrrepsArray:
    """Concatenate IrrepsArrays along the feature axis (group order kept):
    a list of their chunks, no data movement."""
    irreps = Irreps([g for a in arrays for g in a.irreps])
    return IrrepsArray.from_chunks(irreps, [c for a in arrays for c in a.chunks()])
