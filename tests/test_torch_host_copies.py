"""The port's copies of the JAX package's host code, held to the originals.

The native FASTA codec (against ``pydca_tpu.native.fastacodec`` and the
port's own Python path), the reference's 1-based reader shim
(``fasta_reader``), ``a2m2aln``, ``make_archive`` and
``write_params_binary``, ``PlmDCA.effective_num_sequences``, the top-level
names, ``profiling.sync``/``device_trace`` and ``examples/demo_torch.py``,
each on inputs made from a seed with numpy; and the port's console scripts
of ``setup.py``, run as the wrapper pip generates runs them.
"""

import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import pydca_tpu
import pydca_tpu_torch
from pydca_tpu import fasta_reader as jreader
from pydca_tpu.extras import a2m2aln as ja2m
from pydca_tpu.io import fasta as jfasta
from pydca_tpu.io import output as joutput
from pydca_tpu.native import fastacodec as jcodec
from pydca_tpu.plm import PlmDCA as JPlmDCA
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import fasta_reader as treader
from pydca_tpu_torch.extras import a2m2aln as ta2m
from pydca_tpu_torch.io import fasta as tfasta
from pydca_tpu_torch.io import output as toutput
from pydca_tpu_torch.native import fastacodec as tcodec
from pydca_tpu_torch.plm import PlmDCA as TPlmDCA
from pydca_tpu_torch.profiling import device_trace, sync
from pydca_tpu_torch.synthetic import planted_family, reference_from_row, write_family_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def messy_fasta(path, biomolecule, seed, n=40, l=23):
    """A FASTA file with wrapped lines, ``;`` comments, blank lines, lower
    case, non-standard residues, ids with spaces and duplicate rows."""
    rng = np.random.default_rng(seed)
    letters = talph.get_alphabet(biomolecule).letters + "-"
    odd = "XBZ*.~J" if biomolecule == "protein" else "NXT.~R"
    rows = []
    for k in range(n):
        chars = rng.choice(list(letters), size=l)
        chars[rng.integers(0, l, size=2)] = rng.choice(list(odd), size=2)
        rows.append("".join(chars).lower() if k % 3 == 0 else "".join(chars))
    rows += [rows[k] for k in rng.integers(0, n, size=6)]  # exact duplicates
    rows.append(rows[1].swapcase())  # a duplicate only after upper-casing
    lines = ["; a comment before the first record"]
    for k, row in enumerate(rows):
        lines.append(f">seq{k} desc {k % 5}" + (" " if k % 4 == 0 else ""))
        width = int(rng.integers(5, l + 1))
        lines += [row[i:i + width] for i in range(0, l, width)]
        if k % 7 == 0:
            lines += ["", "; an old-style comment"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.fixture
def codec():
    if shutil.which("g++") is None:  # decided at run time, as the builds are
        pytest.skip("no g++ for the native codec")
    assert tcodec.available() and jcodec.available()
    return tcodec


def python_path(path, biomolecule, dedup):
    ids, seqs = tfasta.read_sequences(path)
    data = talph.get_alphabet(biomolecule).encode_many(seqs)
    return tfasta._dedup_encoded(data, ids) if dedup else (data, ids)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("biomolecule", ["protein", "rna"])
def test_codec_equals_jax_codec_and_python_path(codec, tmp_path, biomolecule, dedup, seed):
    fa = str(tmp_path / "messy.fa")
    messy_fasta(fa, biomolecule, seed)
    data, ids = codec.read_and_encode(fa, talph.get_alphabet(biomolecule), dedup=dedup)
    jdata, jids = jcodec.read_and_encode(fa, jfasta.get_alphabet(biomolecule), dedup=dedup)
    pdata, pids = python_path(fa, biomolecule, dedup)
    assert data.dtype == np.int8 and data.shape == jdata.shape == pdata.shape
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, pdata)
    assert ids == jids == pids
    assert (data.shape[0] < 47) == dedup


def test_read_msa_uses_the_codec(codec, tmp_path):
    fa = str(tmp_path / "messy.fa")
    messy_fasta(fa, "protein", 2)
    before = codec.read_and_encode.reads
    msa = tfasta.read_msa(fa, "protein")
    jmsa = jfasta.read_msa(fa, "protein")
    assert codec.read_and_encode.reads == before + 1
    np.testing.assert_array_equal(msa.data, jmsa.data)
    assert msa.ids == jmsa.ids
    assert codec.library_path().parent == tcodec._build.BUILD_DIR


def test_malformed_file_raises_the_python_paths_error(codec, tmp_path):
    fa = tmp_path / "bad.fa"
    fa.write_text(">a\nACGU\n>b\nACG\n")
    with pytest.raises(tfasta.FastaError, match="differing lengths"):
        tfasta.read_msa(str(fa), "rna")


@pytest.mark.parametrize("biomolecule", ["protein", "rna"])
def test_fasta_reader_equals_jax(tmp_path, biomolecule):
    fa = str(tmp_path / "messy.fa")
    messy_fasta(fa, biomolecule, 3)
    assert treader.RES_TO_INT_ALL == jreader.RES_TO_INT_ALL
    assert treader.res_to_char(biomolecule) == jreader.res_to_char(biomolecule)
    seqs = treader.get_alignment_from_fasta_file(fa)
    assert seqs == jreader.get_alignment_from_fasta_file(fa)
    ints = treader.alignment_letter2int(seqs, biomolecule)
    assert ints == jreader.alignment_letter2int(seqs, biomolecule)
    assert treader.get_alignment_int_form(fa, biomolecule) == \
        jreader.get_alignment_int_form(fa, biomolecule)
    assert treader.get_alignment_char_form(fa, biomolecule) == \
        jreader.get_alignment_char_form(fa, biomolecule)
    assert treader.sequences_to_char_form(ints, biomolecule) == \
        jreader.sequences_to_char_form(ints, biomolecule)


def a2m_text(seed, n=12, l=30):
    rng = np.random.default_rng(seed)
    lines = ["header junk"]
    for k in range(n):
        chars = rng.choice(list("ACDEFGHIKLMNPQRSTVWYacdefghik.-"), size=l - (k == 5))
        name = "QUERY_HUMAN/17-88 q" if k == 3 else f"hom{k}/1-{l}"
        lines.append(f">{name}")
        lines += ["".join(chars[i:i + 11]) for i in range(0, len(chars), 11)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [0, 1])
def test_a2m2aln_equals_jax(seed):
    text = a2m_text(seed)
    query = r"^QUERY_HUMAN/(\d+)"
    got = ta2m.convert_a2m(io.StringIO(text), query, quiet=True)
    want = ja2m.convert_a2m(io.StringIO(text), query, quiet=True)
    assert (got.records, got.query_start, got.skipped) == \
        (want.records, want.query_start, want.skipped)
    assert got.query_start == 17 and got.skipped == ["hom5/1-30"]
    outs = []
    for run in (ta2m.run_a2m2aln, ja2m.run_a2m2aln):
        out = io.StringIO()
        assert run(["--query", query, "--quiet"], stdin=io.StringIO(text), stdout=out) == 0
        outs.append(out.getvalue().encode())
    assert outs[0] == outs[1]


def test_make_archive_equals_jax(tmp_path):
    root = tmp_path / "results"
    (root / "sub").mkdir(parents=True)
    rng = np.random.default_rng(4)
    for rel in ("a.txt", "sub/b.txt", "sub/c.npy"):
        (root / rel).write_bytes(rng.bytes(200))
    archives = []
    for mod, dest in ((toutput, "port"), (joutput, "jax")):
        (tmp_path / dest).mkdir()
        archives.append(mod.make_archive(str(root), str(tmp_path / dest)))
    assert [os.path.basename(a) for a in archives] == ["results.zip"] * 2
    with zipfile.ZipFile(archives[0]) as zt, zipfile.ZipFile(archives[1]) as zj:
        assert sorted(zt.namelist()) == sorted(zj.namelist())
        assert len(zt.namelist()) == 3
        for name in zt.namelist():
            assert zt.read(name) == zj.read(name)
    with pytest.raises(FileNotFoundError):
        toutput.make_archive(str(tmp_path / "missing"))


def test_write_params_binary_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    couplings = rng.standard_normal((15, 4, 4)).astype(np.float32)
    fields = rng.standard_normal((6, 4)).astype(np.float32)
    toutput.write_params_binary(torch.from_numpy(couplings), torch.from_numpy(fields),
                                str(tmp_path / "tc.npy"), str(tmp_path / "tf.npy"))
    joutput.write_params_binary(couplings, fields, str(tmp_path / "jc.npy"),
                                str(tmp_path / "jf.npy"))
    for a, b in (("tc", "jc"), ("tf", "jf")):
        got, want = np.load(tmp_path / f"{a}.npy"), np.load(tmp_path / f"{b}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seqid", [0.8, 0.6])
def test_effective_num_sequences_equals_jax(tmp_path, seqid):
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, planted_family(150, 24, 5, seed=6, n_pairs=2)[0], talph.RNA)
    got = TPlmDCA(fa, "rna", seqid=seqid, device="cpu").effective_num_sequences
    want = JPlmDCA(fa, "rna", seqid=seqid).effective_num_sequences
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_top_level_names_match_jax(tmp_path):
    assert pydca_tpu_torch.__all__ == pydca_tpu.__all__
    for name in pydca_tpu_torch.__all__:
        assert getattr(pydca_tpu_torch, name) is not None
    assert pydca_tpu_torch.PlmDCA is TPlmDCA
    assert pydca_tpu_torch.PROTEIN.letters == pydca_tpu.PROTEIN.letters
    assert pydca_tpu_torch.RNA.q == pydca_tpu.RNA.q
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, planted_family(40, 12, 5, seed=7, n_pairs=1)[0], talph.RNA)
    np.testing.assert_array_equal(pydca_tpu_torch.read_msa(fa, "rna").data,
                                  pydca_tpu.read_msa(fa, "rna").data)
    with pytest.raises(AttributeError):
        pydca_tpu_torch.NoSuchName


def test_sync_returns_its_input():
    t = torch.arange(6.0)
    nested = {"a": [t, (t * 2, "text")], "b": 3}
    assert sync(t) is t
    assert sync(nested) is nested
    assert sync(None) is None


def test_device_trace(tmp_path):
    with device_trace(None):
        torch.ones(4).sum()
    with device_trace(""):
        pass
    out = tmp_path / "trace"
    with device_trace(str(out)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(out)
    assert files == [f"trace.{os.getpid()}.json"]
    assert "traceEvents" in (out / files[0]).read_text()


def test_demo_runs_on_the_cpu(tmp_path, capsys):
    codes = planted_family(160, 40, 5, seed=8, n_pairs=4)[0]
    fa, ref = str(tmp_path / "fam.fa"), str(tmp_path / "ref.fa")
    write_family_fasta(fa, codes, talph.RNA)
    tfasta.write_fasta(ref, ["ref"], [reference_from_row(codes, 5, talph.RNA, seed=1)])
    spec = importlib.util.spec_from_file_location(
        "demo_torch", os.path.join(REPO, "examples", "demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main([fa, ref, "--device", "cpu", "--iters", "5", "--out_dir", str(tmp_path / "o")])
    out = capsys.readouterr().out
    for text in ("trimmed MSA:", "mfDCA: N=", "mfDCA top 5", "plmDCA (5 L-BFGS iterations)",
                 "backmapped to refseq coordinates", "skipping contact-map evaluation"):
        assert text in out


def console_scripts():
    """``setup.py``'s port scripts: name -> (module, function)."""
    with open(os.path.join(REPO, "setup.py")) as fh:
        found = re.findall(r'"([\w-]+-torch)=([\w.]+):(\w+)"', fh.read())
    return {name: (module, func) for name, module, func in found}


@pytest.fixture(scope="module")
def script_family(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    codes = planted_family(80, 12, 5, seed=4, n_pairs=2)[0]
    fa = str(tmp / "fam.fa")
    write_family_fasta(fa, codes, talph.RNA)
    return tmp, fa


@pytest.mark.parametrize("script,command", [
    ("plmdca-torch", "compute_fn"), ("plmdca-torch", "warmup"),
    ("mfdca-torch", "compute_fn"), ("mfdca-torch", "warmup"),
])
def test_console_script_exits_zero(script, command, script_family):
    """pip's wrapper runs ``sys.exit(func())``: anything but None or an int
    would be printed and exit 1."""
    tmp, fa = script_family
    module, func = console_scripts()[script]
    argv = [command, "rna", fa, "--device", "cpu"]
    if command == "compute_fn":
        argv += ["--apc", "--output_dir", str(tmp / script)]
        argv += ["--max_iterations", "5"] if script == "plmdca-torch" else []
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PYDCA_TPU_CACHE_DIR=str(tmp / "cache"))
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; from {module} import {func}; sys.exit({func}())",
         *argv], capture_output=True, text=True, env=env, timeout=120, cwd=str(tmp))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Traceback" not in proc.stderr
    if command == "warmup":
        assert proc.stdout.startswith("warmed ")


def test_console_scripts_name_every_cli():
    want = {"plmdca-torch": ("pydca_tpu_torch.cli.plmdca_main", "main"),
            "mfdca-torch": ("pydca_tpu_torch.cli.mfdca_main", "main"),
            "pydca-torch": ("pydca_tpu_torch.cli.main", "run_pydca"),
            "a2m2aln-torch": ("pydca_tpu_torch.extras.a2m2aln", "run_a2m2aln")}
    assert console_scripts() == want
