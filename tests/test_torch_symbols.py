"""The port's ``SymbolMapping`` (tests/test_symbols.py's cases), held
against ``libhuffman_tpu.symbols`` and ``ops/hostref``'s code tables."""

import numpy as np
import pytest

from libhuffman_tpu import symbols as jsymbols
from libhuffman_tpu.ops import hostref
from libhuffman_tpu_torch.format import serialize_tree
from libhuffman_tpu_torch.symbols import SymbolMapping, SymbolMappingElement


def test_symbol_mapping_allocation():
    mapping = SymbolMapping(10)
    assert mapping.length == 10

    element1 = SymbolMappingElement("1011", 4)
    assert element1.length == 4
    assert element1.coding == "1011"

    mapping.insert(2, element1)
    element2 = mapping.get(2)
    assert element2 is not None
    assert element1 is element2


def test_symbol_mapping_insertion():
    mapping = SymbolMapping(10)
    element1 = SymbolMappingElement("handsomest", 10)
    element2 = SymbolMappingElement("impedance", 9)
    element3 = SymbolMappingElement("magnanimous", 10)
    element4 = SymbolMappingElement("pitchfork", 9)

    mapping.insert(1, element1)
    mapping.insert(1, element2)  # overwrite drops element1
    mapping.insert(3, element3)
    mapping.insert(4, element4)

    expected = [None, element2, None, element3, element4,
                None, None, None, None, None]
    for i in range(mapping.length):
        assert mapping.get(i) is expected[i]


def test_symbol_mapping_reset():
    mapping = SymbolMapping(5)
    for i in range(mapping.length):
        mapping.insert(i, SymbolMappingElement("value", 5))
    for i in range(mapping.length):
        el = mapping.get(i)
        assert el is not None
        assert el.coding == "value"
        assert el.length == 5

    mapping.reset()
    for i in range(mapping.length):
        assert mapping.get(i) is None

    for i in range(mapping.length):
        mapping.insert(i, SymbolMappingElement("attribute", 9))
    for i in range(mapping.length):
        el = mapping.get(i)
        assert el is not None
        assert el.coding == "attribute"
        assert el.length == 9


def test_element_clamps_to_length():
    el = SymbolMappingElement("magnanimous", 10)
    assert el.coding == "magnanimou"
    assert el.length == 10


def test_out_of_range_raises():
    mapping = SymbolMapping(4)
    with pytest.raises(IndexError):
        mapping.get(4)
    with pytest.raises(IndexError):
        mapping.insert(-1, SymbolMappingElement("0"))


def _same(ours: SymbolMapping, theirs) -> bool:
    return ours.length == theirs.length and all(
        (a is None and b is None) or (
            a is not None and b is not None
            and (a.coding, a.length) == (b.coding, b.length))
        for a, b in ((ours.get(s), theirs.get(s)) for s in range(ours.length)))


@pytest.mark.parametrize("block", [
    b"abracadabra" * 7,
    bytes(range(256)) * 3 + b"\x00" * 500,
    bytes(np.random.default_rng(5).integers(0, 40, 5000, dtype=np.uint8)),
], ids=["abracadabra", "all-256", "random-40"])
def test_mapping_matches_encoder_codebook(block):
    """The mapping and the dense-array codebook agree both ways, and every
    bridge gives what the JAX package's class gives."""
    block = np.frombuffer(block, np.uint8)
    tree, parent = hostref.build_tree(hostref.histogram(block))
    codes, lengths = hostref.code_table(tree, parent)

    mapping = SymbolMapping.from_code_table(codes, lengths)
    for s in set(block.tolist()):
        el = mapping.get(s)
        assert el is not None and el.length == lengths[s]
        # Leading 0 bit: the unary-root invariant (src/tree.c:410-413).
        assert el.coding.startswith("0")
    absent = set(range(256)) - set(block.tolist())
    assert all(mapping.get(s) is None for s in absent)
    assert _same(mapping, jsymbols.SymbolMapping.from_code_table(codes,
                                                                 lengths))

    codes2, lens2 = mapping.to_arrays()
    assert np.array_equal(lens2, lengths)
    assert np.array_equal(codes2, codes)
    jcodes, jlens = jsymbols.SymbolMapping.from_code_table(
        codes, lengths).to_arrays()
    assert np.array_equal(codes2, jcodes) and np.array_equal(lens2, jlens)

    wire = serialize_tree(tree)
    mapping3 = SymbolMapping.from_tree(wire)
    assert _same(mapping3, mapping)
    assert _same(mapping3, jsymbols.SymbolMapping.from_tree(wire))
