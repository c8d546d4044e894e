"""Public symbol-mapping (codebook) surface.

The reference keeps its codebook as a 256-slot array of heap elements
``{length, coding}`` with insert/get/overwrite/reset semantics
(src/symbol.c:10-222, include/huffman/symbol.h:10-79 of the C library).
The port's real codebook is a pair of dense tensors on the device - codes
(B, 256) and lengths (B, 256) (``ops/device.extract_codes``) - because
per-symbol heap cells have no device analogue.  This module is the
host-side introspection and parity face of that codebook, a copy of
``libhuffman_tpu.symbols``: the same observable container semantics as
``huf_symbol_mapping_*`` (insert replaces and drops the old element, get
returns None for empty slots, reset clears every slot), plus bridges to
and from the dense-array form.
"""

from __future__ import annotations

import numpy as np

from .format import ASCII_COUNT, describe_tree


class SymbolMappingElement:
    """One codebook entry: a '0'/'1' coding string and its bit length
    (reference analogue: huf_symbol_mapping_element_t, symbol.h:10-19;
    element init clamps to the stated length, src/symbol.c:10-40)."""

    __slots__ = ("coding", "length")

    def __init__(self, coding: str, length: int | None = None):
        if length is None:
            length = len(coding)
        if length < 0:
            raise ValueError("length must be non-negative")
        self.coding = coding[:length]
        self.length = length

    def __eq__(self, other):
        return (
            isinstance(other, SymbolMappingElement)
            and self.coding == other.coding
            and self.length == other.length
        )

    def __repr__(self):
        return f"SymbolMappingElement({self.coding!r}, {self.length})"


class SymbolMapping:
    """Fixed-length slot container for codebook elements.

    Mirrors huf_symbol_mapping_t semantics: ``insert`` overwrites (the
    previous occupant is dropped — the reference frees it, src/symbol.c:
    157-186), ``get`` yields None for never-written or reset slots, and
    ``reset`` clears all slots for reuse between blocks (src/symbol.c:
    192-210)."""

    def __init__(self, length: int = ASCII_COUNT):
        if length < 0:
            raise ValueError("length must be non-negative")
        self._slots: list[SymbolMappingElement | None] = [None] * length

    @property
    def length(self) -> int:
        return len(self._slots)

    def insert(self, position: int, element: SymbolMappingElement) -> None:
        self._check(position)
        self._slots[position] = element

    def get(self, position: int) -> SymbolMappingElement | None:
        self._check(position)
        return self._slots[position]

    def reset(self) -> None:
        for i in range(len(self._slots)):
            self._slots[i] = None

    def _check(self, position: int) -> None:
        # Reference: routine_inrange_m on position (src/symbol.c:150-155).
        if not 0 <= position < len(self._slots):
            raise IndexError(
                f"position {position} out of range [0, {len(self._slots)})"
            )

    # -- bridges to the dense-array codebook the device kernels use --------

    @classmethod
    def from_code_table(cls, codes: np.ndarray, lengths: np.ndarray
                        ) -> "SymbolMapping":
        """Dense (codes[s], lengths[s]) arrays (hostref.code_table /
        ops/device.extract_codes form: MSB-first codeword values) ->
        mapping."""
        m = cls(len(codes))
        for s in range(len(codes)):
            ln = int(lengths[s])
            if ln == 0:
                continue
            c = int(codes[s])
            m.insert(s, SymbolMappingElement(
                "".join("01"[(c >> (ln - 1 - i)) & 1] for i in range(ln)), ln
            ))
        return m

    @classmethod
    def from_tree(cls, tree_i16: np.ndarray) -> "SymbolMapping":
        """Serialized preorder tree -> the mapping the encoder would build
        for it (the reference builds this via per-leaf huf_node_to_string
        walks, src/encoder.c:40-81)."""
        m = cls(ASCII_COUNT)
        for sym, coding in describe_tree(np.asarray(tree_i16, np.int16)).items():
            m.insert(sym, SymbolMappingElement(coding))
        return m

    def to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Mapping -> dense (codes u64, lengths i32) arrays, inverse of
        :meth:`from_code_table`."""
        codes = np.zeros(self.length, np.uint64)
        lens = np.zeros(self.length, np.int32)
        for s, el in enumerate(self._slots):
            if el is None:
                continue
            lens[s] = el.length
            codes[s] = int(el.coding or "0", 2) if el.length else 0
        return codes, lens
