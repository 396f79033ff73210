"""Port's aligner, template search, backmapper and trimmer vs ``pydca_tpu``
on the CPU.

Every result is compared exactly: scores are integers that float32 holds
exactly, so ``local_align`` (score, starts, path), the batched search's
scores, the mapping dicts and the trimmed columns must equal the JAX
package's.  The families are planted ones (:mod:`pydca_tpu_torch.synthetic`)
and each reference is made from a row other than the first, with
substitutions and residues added at its ends, so that the search runs; the
first-row shortcut has its own case.
"""

import numpy as np
import pytest
import torch

from pydca_tpu import align as jalign
from pydca_tpu import matrices as jmat
from pydca_tpu.backmap import SequenceBackmapper as JBackmapper
from pydca_tpu.trim import MSATrimmer as JTrimmer
from pydca_tpu_torch import align as talign
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import matrices as tmat
from pydca_tpu_torch.backmap import SequenceBackmapper, templates_from_codes
from pydca_tpu_torch.io.fasta import write_fasta
from pydca_tpu_torch.synthetic import planted_family, reference_from_row, write_family_fasta
from pydca_tpu_torch.trim import MSATrimmer

BIOS = {"rna": talph.RNA, "protein": talph.PROTEIN}


def penalties(bio):
    return tmat.submatrix_for(bio, BIOS[bio].letters), *tmat.gap_penalties_for(bio)


@pytest.mark.parametrize("bio", ["rna", "protein"])
def test_matrices_match_jax(bio):
    letters = BIOS[bio].letters
    np.testing.assert_array_equal(tmat.submatrix_for(bio, letters),
                                  jmat.submatrix_for(bio, letters))
    assert tmat.gap_penalties_for(bio) == jmat.gap_penalties_for(bio)
    assert tmat.BLOSUM62 == jmat.BLOSUM62 and tmat.NUC44 == jmat.NUC44


@pytest.mark.parametrize("bio", ["rna", "protein"])
@pytest.mark.parametrize("seed", range(4))
def test_local_align_matches_jax(bio, seed):
    """Score, start positions and path on random pairs of related
    sequences (one cut from, and mutated off, the other)."""
    sub, go, ge = penalties(bio)
    rng = np.random.default_rng(seed)
    r = len(BIOS[bio].letters)
    a = rng.integers(0, r, size=int(rng.integers(5, 60)))
    lo = int(rng.integers(0, len(a)))
    b = a[lo:lo + int(rng.integers(1, 50))].copy()
    flip = rng.random(len(b)) < 0.3
    b[flip] = rng.integers(0, r, size=int(flip.sum()))
    b = np.concatenate([rng.integers(0, r, size=3), b, rng.integers(0, r, size=2)])
    got = talign.local_align(a, b, sub, go, ge)
    want = jalign.local_align(a, b, sub, go, ge)
    assert got == want
    sa, sb = BIOS[bio].decode(a), BIOS[bio].decode(b)
    assert talign.aligned_strings(sa, sb, *got[1:]) == jalign.aligned_strings(sa, sb, *want[1:])


def padded(rows, width, pad):
    out = np.full((len(rows), width), pad, dtype=np.int32)
    for k, t in enumerate(rows):
        out[k, : len(t)] = t
    return out


@pytest.mark.parametrize("bio", ["rna", "protein"])
def test_batch_scores_match_jax(bio):
    """Padding, empty templates, ties (a repeated template) and, for RNA,
    extend 0; the scores equal JAX's and each single alignment's."""
    sub, go, ge = penalties(bio)
    rng = np.random.default_rng(7)
    r = len(BIOS[bio].letters)
    ref = rng.integers(0, r, size=30)
    rows = [rng.integers(0, r, size=int(rng.integers(0, 45))) for _ in range(20)]
    rows[3] = np.zeros(0, np.int64)  # an all-gap row: an empty template
    rows[9] = ref[5:25].copy()
    rows[14] = rows[9].copy()  # a tie at the best score
    temps = padded(rows, 45, -1)
    got = talign.batch_local_align_scores(ref, temps, sub, go, ge, -1, device="cpu")
    want = jalign.batch_local_align_scores(ref, temps, sub, go, ge, -1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[3] == 0 and got[9] == got[14] == got.max()
    assert np.nonzero(got == got.max())[0][0] == 9
    for k, t in enumerate(rows):
        assert got[k] == talign.local_align(ref, t, sub, go, ge)[0]
    # a torch tensor on the device, with another pad value
    temps_t = torch.from_numpy(padded(rows, 45, r))
    got_t = talign.batch_local_align_scores(ref, temps_t, sub, go, ge, r, device="cpu")
    np.testing.assert_array_equal(got_t, got)


def family(bio, n=120, l=40, seed=0):
    q = BIOS[bio].q
    codes, _ = planted_family(n, l, q, seed=seed, n_pairs=4, n_ancestors=8)
    return codes


def write_ref(path, *seqs):
    write_fasta(str(path), [f"ref{k}" for k in range(len(seqs))], list(seqs))
    return str(path)


def both_mappings(tmp_path, bio, codes, ref, **kwargs):
    """The JAX and the port's mapping for one MSA file and reference."""
    fa = str(tmp_path / "msa.fa")
    write_family_fasta(fa, codes, BIOS[bio])
    rf = write_ref(tmp_path / "ref.fa", ref, *kwargs.pop("more_refs", ()))
    want = JBackmapper(msa_file=fa, refseq_file=rf, biomolecule=bio).map_to_reference_sequence()
    t = SequenceBackmapper(msa_file=fa, refseq_file=rf, biomolecule=bio, device="cpu")
    return t.map_to_reference_sequence(), want, t


REF_CASES = {
    "search": dict(k=17),
    "longer_than_template": dict(k=23, ends=(9, 12)),
    "shorter_than_template": dict(k=31, cut=(6, 5)),
    "first_row_shortcut": dict(k=0, n_sub=0, ends=(0, 0)),
}


@pytest.mark.parametrize("bio", ["rna", "protein"])
@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_mapping_matches_jax(tmp_path, bio, case):
    spec = dict(REF_CASES[case])
    codes = family(bio, seed=len(case))
    cut = spec.pop("cut", None)
    ref = reference_from_row(codes, spec.pop("k"), BIOS[bio], seed=3, **spec)
    if cut:
        ref = ref[cut[0] : len(ref) - cut[1]]
    got, want, t = both_mappings(tmp_path, bio, codes, ref)
    assert got == want and len(got) > 0.5 * len(ref)
    assert list(got.items()) == list(want.items())  # the same key order
    searched = "search" in t.timers.summary()
    assert searched == (case != "first_row_shortcut")


def test_two_reference_sequences_take_the_first(tmp_path):
    codes = family("protein", seed=5)
    ref = reference_from_row(codes, 40, talph.PROTEIN, seed=1)
    other = reference_from_row(codes, 2, talph.PROTEIN, seed=2)
    got, want, _ = both_mappings(tmp_path, "protein", codes, ref, more_refs=[other])
    assert got == want


@pytest.mark.parametrize("bio", ["rna", "protein"])
def test_alignment_data_forms_match_jax(bio):
    """Code rows (as the CLIs pass them, duplicates included) and strings
    with letters that encode to the gap state."""
    codes = family(bio, seed=11)
    codes = np.concatenate([codes, codes[5:9]])  # duplicates, dropped in order
    ref = reference_from_row(codes, 60, BIOS[bio], seed=4)
    kw = dict(ref_seq=ref, biomolecule=bio)
    rows = list(codes)
    got = SequenceBackmapper(alignment_data=rows, device="cpu", **kw)
    want = JBackmapper(alignment_data=rows, **kw)
    assert got.alignment == want.alignment
    assert got.find_matching_seqs_from_alignment() == want.find_matching_seqs_from_alignment()
    assert got.map_to_reference_sequence() == want.map_to_reference_sequence()
    strings = [s.lower() for s in BIOS[bio].decode_many(codes)]
    strings[7] = "X" + strings[7][1:]  # not a residue: a cell no path crosses
    got = SequenceBackmapper(alignment_data=strings, device="cpu", **kw)
    want = JBackmapper(alignment_data=strings, **kw)
    assert got.alignment == want.alignment
    assert got.map_to_reference_sequence() == want.map_to_reference_sequence()


def test_codes_outside_the_alphabet_raise():
    codes = family("rna", n=10, l=12)
    codes[2, 3] = 5
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        SequenceBackmapper(alignment_data=list(codes), ref_seq="ACGU", biomolecule="rna",
                           device="cpu")


@pytest.mark.parametrize("bio", ["rna", "protein"])
def test_code_templates_equal_the_string_route(tmp_path, bio):
    """The device route (a compaction of the code rows) against the JAX
    package's string route on a FASTA file holding duplicates and letters
    that encode to the gap state ('.', 'X', 'B' for protein; 'T', 'N' for
    RNA)."""
    alph = BIOS[bio]
    codes = family(bio, n=60, l=25, seed=2)
    seqs = alph.decode_many(codes)
    odd = "XB." if bio == "protein" else "TN."
    rng = np.random.default_rng(0)
    for k in range(0, 60, 3):
        pos = rng.integers(0, 25, size=3)
        s = list(seqs[k])
        for p, ch in zip(pos, odd):
            s[p] = ch
        seqs[k] = "".join(s)
    seqs += seqs[10:14]
    fa = str(tmp_path / "odd.fa")
    write_fasta(fa, [f"s{k}" for k in range(len(seqs))], seqs)
    bm = JBackmapper(msa_file=fa, ref_seq=alph.letters * 2, biomolecule=bio)
    stripped = [s.replace("-", "") for s in bm.alignment]
    want = np.full((len(stripped), max(map(len, stripped))), alph.gap_state, np.int8)
    for k, s in enumerate(stripped):
        want[k, : len(s)] = alph.encode_str(s)
    from pydca_tpu_torch.io.fasta import read_msa

    got = templates_from_codes(torch.from_numpy(read_msa(fa, bio).data), alph.gap_state)
    np.testing.assert_array_equal(got.numpy(), want)


def trimmer_pair(tmp_path, bio, max_gap=None, seed=0):
    codes = family(bio, n=90, l=36, seed=seed)
    codes[:, [4, 20]] = BIOS[bio].gap_state  # two all-gap columns
    codes[:70, 30] = BIOS[bio].gap_state  # a gappy column
    fa = str(tmp_path / "trim.fa")
    write_family_fasta(fa, codes, BIOS[bio])
    rf = write_ref(tmp_path / "ref.fa", reference_from_row(codes, 44, BIOS[bio], seed=9))
    kw = dict(biomolecule=bio, refseq_file=rf, max_gap=max_gap)
    return MSATrimmer(fa, device="cpu", **kw), JTrimmer(fa, **kw)


@pytest.mark.parametrize("bio", ["rna", "protein"])
@pytest.mark.parametrize("max_gap", [None, 0.05])
def test_trimmer_matches_jax(tmp_path, bio, max_gap):
    t, j = trimmer_pair(tmp_path, bio, max_gap)
    assert t.compute_msa_columns_gap_size() == j.compute_msa_columns_gap_size()
    assert t.trim_by_gap_size() == j.trim_by_gap_size()
    for remove_all_gaps in (False, True):
        cols = t.trim_by_refseq(remove_all_gaps=remove_all_gaps)
        assert cols == j.trim_by_refseq(remove_all_gaps=remove_all_gaps)
        assert {4, 20} <= set(cols)
        assert (t.get_msa_trimmed_by_refseq(remove_all_gaps=remove_all_gaps)
                == j.get_msa_trimmed_by_refseq(remove_all_gaps=remove_all_gaps))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SequenceBackmapper(ref_seq="ACGU", alignment_data=["ACGU"], biomolecule="rna")
    sub, go, ge = penalties("rna")
    with pytest.raises(RuntimeError, match="is_available"):
        talign.batch_local_align_scores(np.zeros(3), np.zeros((2, 3)), sub, go, ge, -1)
