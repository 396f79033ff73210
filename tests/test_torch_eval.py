"""Port's PDB parser and contact evaluator vs ``pydca_tpu`` on the CPU.

The structures are the synthetic ones of ``tests/test_eval.py`` (a toy RNA
hairpin), ``tests/test_eval_realistic.py`` (two models, altlocs, an
insertion code, hetero atoms, a modified nucleotide, hydrogens, a protein
chain, a reference longer than the chain, a secondary structure) and
``tests/test_eval_scale.py`` (a random-walk protein chain, cut to 150
residues).  Every result must equal the JAX objects' exactly: both run
the same numpy code on the same file.  The three writers of the ``pydca``
CLI are compared byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pydca_tpu.eval import pdb as jpdb
from pydca_tpu.eval import visualizer as jviz
from pydca_tpu.io import output as joutput
from pydca_tpu_torch.eval import pdb as tpdb
from pydca_tpu_torch.eval import visualizer as tviz
from pydca_tpu_torch.io import output as toutput

import test_eval
import test_eval_realistic as real

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy(tmp_path):
    """``tests/test_eval.py``'s hairpin: refseq ACGUAC, the PDB chain misses
    its position 2, residues (0, 5) and (1, 4) are close; a hydrogen atom
    on every residue."""
    positions = [(0.0, 0.0, 0.0), (10.0, 0.0, 0.0), (20.0, 0.0, 0.0), (10.0, 3.0, 0.0),
                 (0.0, 3.0, 0.0)]
    lines, serial = [], 1
    for k, (resname, (x, y, z)) in enumerate(zip("ACUAC", positions)):
        for name, dx, dy, elem in (("P", 0, 0, "P"), ("C1'", 1, 0, "C"), ("H1", 0, 0.1, "H")):
            lines.append(test_eval._pdb_atom_line(serial, name, resname, "X", k + 1,
                                                  x + dx, y + dy, z, elem))
            serial += 1
    (tmp_path / "toy.pdb").write_text("".join(lines) + "END\n")
    (tmp_path / "ref.fa").write_text(">ref\nACGUAC\n")
    (tmp_path / "dca.txt").write_text("# header\n1 6 3.5\n2 5 3.0\n1 4 2.0\n3 6 1.0\n")
    return dict(biomolecule="rna", pdb_chain_id="X", pdb_file=str(tmp_path / "toy.pdb"),
                refseq_file=str(tmp_path / "ref.fa"), dca_file=str(tmp_path / "dca.txt"),
                linear_dist=2, contact_dist=8.0, num_dca_contacts=4)


def realistic(tmp_path, with_ss=False):
    """``tests/test_eval_realistic.py``'s riboswitch structure, reference,
    DCA ranking and secondary structure."""
    real._write_structure(str(tmp_path / "struct.pdb"))
    (tmp_path / "ref.fa").write_text(">synthetic riboswitch refseq\n" + real.REF_SEQ + "\n")
    (tmp_path / "dca.txt").write_text(
        "# i j score\n" + "".join(f"{i} {j} {s}\n" for i, j, s in real.DCA_ROWS))
    ss = ["."] * len(real.REF_SEQ)
    ss[5], ss[18] = "(", ")"
    (tmp_path / "ss.txt").write_text("# synthetic secondary structure\n" + "".join(ss) + "\n")
    kw = dict(biomolecule="rna", pdb_chain_id="X", pdb_file=str(tmp_path / "struct.pdb"),
              refseq_file=str(tmp_path / "ref.fa"), dca_file=str(tmp_path / "dca.txt"),
              num_dca_contacts=6)
    if with_ss:
        kw.update(rna_secstruct_file=str(tmp_path / "ss.txt"), wc_neighbor_dist=1,
                  num_dca_contacts=2)
    return kw


def protein_chain(tmp_path, n_res=150):
    """A random-walk protein chain as ``tests/test_eval_scale.py`` builds it
    (five heavy atoms a residue), with a ranked DCA file over it."""
    rng = np.random.default_rng(42)
    centers = np.cumsum(rng.normal(0, 2.0, size=(n_res, 3)), axis=0)
    cycle = [("ALA", "A"), ("LEU", "L"), ("LYS", "K"), ("GLU", "E")]
    atoms = ["N", "CA", "C", "O", "CB"]
    lines, seq, serial = [], [], 1
    for r in range(n_res):
        name, letter = cycle[r % 4]
        seq.append(letter)
        xyz = np.round(centers[r] + rng.normal(0, 0.8, size=(len(atoms), 3)), 3)
        for a, atom in enumerate(atoms):
            lines.append(
                f"ATOM  {serial:5d} {atom:<4s} {name:>3s} A{r + 1:4d}    "
                f"{xyz[a, 0]:8.3f}{xyz[a, 1]:8.3f}{xyz[a, 2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
                f"          {atom[0]:>2s}\n"
            )
            serial += 1
    (tmp_path / "big.pdb").write_text("".join(lines) + "END\n")
    # the reference runs three residues past each end of the chain
    (tmp_path / "ref.fa").write_text(">ref\nMKV" + "".join(seq) + "WYG\n")
    order = np.random.default_rng(1).permutation(n_res * (n_res - 1) // 2)
    iu, ju = np.triu_indices(n_res + 6, k=1)
    with open(tmp_path / "dca.txt", "w") as fh:
        for rank, k in enumerate(order[:400]):
            fh.write(f"{iu[k] + 1} {ju[k] + 1} {1.0 / (rank + 1):.6f}\n")
    return dict(biomolecule="protein", pdb_chain_id="A", pdb_file=str(tmp_path / "big.pdb"),
                refseq_file=str(tmp_path / "ref.fa"), dca_file=str(tmp_path / "dca.txt"),
                num_dca_contacts=50)


FIXTURES = {
    "toy": toy,
    "realistic": realistic,
    "realistic_ss": lambda p: realistic(p, with_ss=True),
    "protein_chain": protein_chain,
}


def residues_of(chains):
    return {c: [(r.name, r.resseq, r.icode, r.hetero, r.atom_names, r.coords) for r in rs]
            for c, rs in chains.items()}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pdb_parsing_matches_jax(tmp_path, name):
    kw = FIXTURES[name](tmp_path)
    got = tpdb.PDBContent(kw["pdb_file"])
    want = jpdb.PDBContent(kw["pdb_file"])
    assert residues_of(got.chains) == residues_of(want.chains)
    assert got.pdb_chain_sequences == want.pdb_chain_sequences
    for chain_id, (bio, _) in want.pdb_chain_sequences.items():
        for a, b in zip(got.standard_residues(chain_id, bio), want.standard_residues(chain_id, bio)):
            names_a, xyz_a = a.heavy_atoms()
            names_b, xyz_b = b.heavy_atoms()
            assert names_a == names_b
            np.testing.assert_array_equal(xyz_a, xyz_b)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_evaluator_matches_jax(tmp_path, name):
    """Mapping, contacts, categories and TP rates, equal to JAX's."""
    kw = FIXTURES[name](tmp_path)
    got, want = tviz.DCAVisualizer(**kw), jviz.DCAVisualizer(**kw)
    assert got.map_pdbseq_to_refseq() == want.map_pdbseq_to_refseq()
    assert got.get_mapped_pdb_contacts() == want.get_mapped_pdb_contacts()
    assert got.dca_ranked_pairs_filtered_by_linear_dist() == \
        want.dca_ranked_pairs_filtered_by_linear_dist()
    cats = got.contact_categories()
    assert cats == want.contact_categories()
    assert all(list(cats[k]) == list(v) for k, v in want.contact_categories().items())
    assert got.compute_true_positive_rates() == want.compute_true_positive_rates()
    assert got.get_wc_pairs_and_neighbors() == want.get_wc_pairs_and_neighbors()
    assert len(cats["tp"]) > 0


def test_planted_contacts_are_true_positives(tmp_path):
    """The realistic fixture's planted pairs through the port alone (the
    assertions of ``tests/test_eval_realistic.py``)."""
    viz = tviz.DCAVisualizer(**realistic(tmp_path))
    cats = viz.contact_categories()
    assert set(cats["tp"]) == {(5, 18), (8, 22)}
    assert set(cats["missing"]) == {(0, 20), (7, 27)}
    mapping, not_in_pdb = viz.map_pdbseq_to_refseq()
    assert sorted(not_in_pdb) == [0, 1, 26, 27]


def test_content_classes_match_jax(tmp_path):
    ss = tmp_path / "ss.txt"
    ss.write_text("# comment\n(([..]))<>\n")
    assert tviz.RNASecStructContent(str(ss)).wcpairs == jviz.RNASecStructContent(str(ss)).wcpairs
    refs = tmp_path / "refs.fa"
    refs.write_text(">rna\nACGU\n>prot\nMKVLAW\n")
    assert (tviz.RefSeqContent(str(refs)).ref_sequences
            == jviz.RefSeqContent(str(refs)).ref_sequences)
    scores = [((0, 5), 3.5), ((1, 4), 3.0)]
    assert (tviz.DCAContent(sorted_dca_scores=scores).dca_ranked_pairs
            == jviz.DCAContent(sorted_dca_scores=scores).dca_ranked_pairs)
    bad = tmp_path / "bad.txt"
    bad.write_text("((..)\n")
    with pytest.raises(tviz.RNASecStructContentException):
        tviz.RNASecStructContent(str(bad))


@pytest.mark.parametrize("name", ["toy", "realistic_ss"])
def test_plots_return_what_jax_returns(tmp_path, name):
    pytest.importorskip("matplotlib")
    kw = FIXTURES[name](tmp_path)
    kw["num_dca_contacts"] = 2
    got, want = tviz.DCAVisualizer(**kw), jviz.DCAVisualizer(**kw)
    png = str(tmp_path / "cm.png")
    assert got.plot_contact_map(show=False, save_path=png) == \
        want.plot_contact_map(show=False, save_path=None)
    assert os.path.getsize(png) > 0
    assert got.plot_true_positive_rates(show=False, save_path=str(tmp_path / "tp.png")) == \
        want.compute_true_positive_rates()


def test_writers_byte_identical(tmp_path):
    """``write_tp_rate``, ``write_contact_map`` and ``write_trimmed_msa``
    against the originals on the same input."""
    kw = realistic(tmp_path, with_ss=True)
    viz = jviz.DCAVisualizer(**kw)
    cats, rates = viz.contact_categories(), viz.compute_true_positive_rates()
    meta = ["# PARAMETES USED FOR THIS COMPUTATION", "#\tMinimum PDB contact distance : 8.0"]
    ids, seqs = ["a", "b b", "c"], ["AC-GU.", "ACCGUA", "------"]
    files = {}
    for mod in (toutput, joutput):
        d = tmp_path / mod.__name__
        d.mkdir()
        mod.write_tp_rate(str(d / "tpr.txt"), true_positive_rates_dict=rates, metadata=meta)
        mod.write_contact_map(str(d / "cm.txt"), cats, metadata=meta)
        mod.write_contact_map(str(d / "cm_nometa.txt"), cats)
        mod.write_trimmed_msa(str(d / "trim.fa"), ids, seqs, [2, 5, np.int64(0)])
        files[mod] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    assert files[toutput] == files[joutput] and len(files[toutput]) == 4


def test_eval_imports_without_matplotlib(tmp_path):
    """The card's machine has no matplotlib: the evaluator imports it only
    inside the plot methods."""
    kw = toy(tmp_path)
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import pydca_tpu_torch.eval as ev, pydca_tpu_torch.cli.main\n"
        f"viz = ev.DCAVisualizer(**{kw!r})\n"
        "assert viz.contact_categories()['tp']\n"
        "assert viz.compute_true_positive_rates()['dca'][0] == 1.0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pydca_tpu.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
