from usher_jax.core import nuc


def test_onehot_basic():
    assert nuc.nuc_id_from_char("A") == 1
    assert nuc.nuc_id_from_char("C") == 2
    assert nuc.nuc_id_from_char("G") == 4
    assert nuc.nuc_id_from_char("T") == 8
    assert nuc.nuc_id_from_char("t") == 8
    assert nuc.nuc_id_from_char("N") == 15
    assert nuc.nuc_id_from_char("?") == 15


def test_ambiguity_codes():
    assert nuc.nuc_id_from_char("R") == 0b0101  # A|G
    assert nuc.nuc_id_from_char("Y") == 0b1010  # C|T
    assert nuc.nuc_id_from_char("M") == 0b0011
    assert nuc.nuc_id_from_char("K") == 0b1100
    # reference quirk: 'V' falls through to N
    assert nuc.nuc_id_from_char("V") == 15


def test_char_from_id():
    assert nuc.char_from_nuc_id(1) == "A"
    assert nuc.char_from_nuc_id(8) == "T"
    assert nuc.char_from_nuc_id(5) == "R"
    assert nuc.char_from_nuc_id(7) == "V"
    assert nuc.char_from_nuc_id(15) == "N"
    assert nuc.char_from_nuc_id(0) == "N"


def test_nt_roundtrip():
    for ch, nt in [("A", 0), ("C", 1), ("G", 2), ("T", 3)]:
        nid = nuc.nuc_id_from_char(ch)
        assert nuc.nt_from_nuc_id(nid) == nt
        assert nuc.nuc_id_from_nt_list([nt]) == nid
    assert nuc.nt_from_nuc_id(5) == -1


def test_nt_list():
    assert nuc.nt_list_from_nuc_id(0b0101) == [0, 2]
    assert nuc.nt_list_from_nuc_id(15) == [0, 1, 2, 3]
    assert nuc.nt_list_from_nuc_id(0) == [0, 1, 2, 3]


def test_lowest_set_bit():
    assert nuc.lowest_set_bit(0b1010) == 0b0010
    assert nuc.lowest_set_bit(0b1000) == 0b1000
