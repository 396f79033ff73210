"""``plmdca warmup`` / ``mfdca warmup`` of the port and its build cache.

Both subcommands run on ``--device cpu`` (nothing to build) and print the
JAX CLI's line for the (N, L, q) that the JAX package's ``read_msa`` gives
the same file.  On ``--device cuda`` they build, through
``ops/_build.build`` (patched here: no nvcc on this host), the libraries a
run would load.  ``runtime.enable_compilation_cache`` picks the build
directory from its argument, ``PYDCA_TPU_CACHE_DIR`` or the package's own
``_build/``.
"""

import logging
import re

import numpy as np
import pytest

from pydca_tpu.io import fasta as jfasta
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import runtime, warmup
from pydca_tpu_torch.cli import mfdca_main, plmdca_main
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.synthetic import planted_family, write_family_fasta

CLIS = {"plmdca": (plmdca_main.run_plm_dca, "plmDCA"),
        "mfdca": (mfdca_main.run_meanfield_dca, "mfDCA")}
LINE = r"warmed {} cache for N=(\d+), L=(\d+), q=(\d+) \((\d+\.\d) s build\)"


@pytest.fixture(autouse=True)
def restore_build_dir(monkeypatch):
    """Every test leaves ``_build.BUILD_DIR`` as it found it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)


@pytest.fixture
def family_file(tmp_path):
    """A family with duplicate rows, so N after the dedup is below the draw's."""
    codes = planted_family(60, 17, 21, seed=3, n_pairs=2, n_ancestors=4)[0]
    codes = np.concatenate([codes, codes[:9]])
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.PROTEIN)
    return fa


@pytest.fixture
def built(monkeypatch):
    """``_build.build`` recording its names and writing an empty library
    where ``library_path`` says."""
    names = []

    def fake_build(name):
        names.append(name)
        out = _build.library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.touch()
        return out

    monkeypatch.setattr(_build, "build", fake_build)
    return names


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_warmup_on_cpu_prints_the_jax_line(cli, family_file, capsys, built):
    run, what = CLIS[cli]
    assert run(["warmup", "protein", family_file, "--device", "cpu"]) >= 0.0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(LINE.format(what), line)
    assert m, line
    jmsa = jfasta.read_msa(family_file, "protein")
    assert tuple(int(v) for v in m.groups()[:3]) == (jmsa.num_seqs, jmsa.seqs_len, jmsa.q)
    assert jmsa.num_seqs < 69  # the duplicates are gone
    assert built == []  # the CPU builds nothing


@pytest.mark.parametrize("cli,want", [("plmdca", ["identity_counts", "plm_passes"]),
                                      ("mfdca", ["identity_counts", "weighted_gram"])])
def test_warmup_on_a_card_builds_what_the_run_loads(cli, want, family_file, capsys, built,
                                                    tmp_path, monkeypatch):
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path / "cache"))
    CLIS[cli][0](["warmup", "protein", family_file, "--device", "cuda"])
    assert sorted(built) == want
    for name in want:  # the CLI moved the cache first
        assert _build.library_path(name).parent == tmp_path / "cache" / "torch_build"
        assert _build.library_path(name).exists()
    assert "warmed" in capsys.readouterr().out


def test_plm_warmup_takes_the_jax_flags(family_file, capsys, built):
    plmdca_main.run_plm_dca([
        "warmup", "protein", family_file, "--seqid", "0.7", "--max_iterations", "20",
        "--seq_block", "16", "--precision", "float32", "--chunk_size", "7",
        "--param_space", "compact", "--mesh", "single", "--device", "cpu",
    ])
    assert re.fullmatch(LINE.format("plmDCA"), capsys.readouterr().out.strip())


@pytest.mark.parametrize("flags,route,warns", [
    (["--precision", "bfloat16"], "fused, bfloat16 products", False),
    (["--param_space", "w2"], "fused, float32 products", True),
    (["--param_space", "w2", "--precision", "bfloat16"], "fused, bfloat16 products", True),
], ids=["bfloat16", "w2", "w2_under_bfloat16"])
def test_warmup_takes_precision_and_space(flags, route, warns, family_file, capsys, caplog,
                                          built):
    """``warmup --precision bfloat16`` / ``--param_space w2``: the JAX
    CLI's line, and the route a run would take logged; ``w2`` fits the
    compact layout, with the engine's warning."""
    with caplog.at_level(logging.INFO, logger="pydca_tpu_torch"):
        plmdca_main.run_plm_dca(["warmup", "protein", family_file, "--device", "cpu"] + flags)
    assert re.fullmatch(LINE.format("plmDCA"), capsys.readouterr().out.strip())
    assert route in caplog.text
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert warned == (["param_space='w2' is accepted for the JAX package's interface; the fit "
                       "runs in the compact parameter layout"] if warns else [])
    assert built == []


@pytest.mark.parametrize("n,streamed", [(2000, False), (70000, True)])
def test_plm_warmup_reports_streaming(n, streamed, caplog):
    """(N, L, q) decide only whether the fit streams: past 1 GiB of logits
    (``plm.streaming_block``) it says over which blocks."""
    with caplog.at_level(logging.INFO, logger="pydca_tpu_torch.warmup"):
        warmup.warmup_plm(n, 195, 21, chunk_size=25, device="cpu")
    text = caplog.text
    assert "chunks of 25" in text
    assert ("streamed over blocks of 65552" in text) == streamed
    assert ("fused" in text) == (not streamed)


@pytest.mark.parametrize("case", ["argument", "variable", "empty variable", "default"])
def test_enable_compilation_cache_chooses_the_build_dir(case, tmp_path, monkeypatch):
    arg = None
    if case == "argument":
        arg, want = str(tmp_path / "arg"), tmp_path / "arg"
        monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path / "ignored"))
    elif case == "variable":
        monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path / "env"))
        want = tmp_path / "env" / "torch_build"
    else:
        if case == "empty variable":
            monkeypatch.setenv(runtime.CACHE_ENV, "")
        want = _build.DEFAULT_BUILD_DIR
    assert runtime.enable_compilation_cache(arg) == want
    assert _build.BUILD_DIR == want
    assert want.is_dir() or want == _build.DEFAULT_BUILD_DIR
    for name in ("identity_counts", "weighted_gram"):
        assert _build.library_path(name).parent == want
    assert not (tmp_path / "ignored").exists()


def test_cache_dir_that_cannot_be_made_is_logged(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    before = _build.BUILD_DIR
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.runtime"):
        assert runtime.enable_compilation_cache(str(blocker / "cache")) == before
    assert _build.BUILD_DIR == before
    assert "could not create the kernel build cache" in caplog.text
