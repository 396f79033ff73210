"""Packaging for pydca_tpu, the TPU-native DCA framework.

Console scripts mirror the reference's entry points (``setup.py:67-73`` of
KIT-MBS/pydca): ``mfdca``, ``plmdca``, ``pydca``.  The optional native FASTA
codec extension builds lazily at runtime (see pydca_tpu/native), so no
compiler is required at install time.  ``pydca_tpu_torch`` is the
PyTorch/CUDA port (needs ``torch``); its CUDA sources under ``csrc/`` build
with nvcc at first use on a card, its FASTA codec under ``native/`` with
g++, into ``$PYDCA_TPU_CACHE_DIR/torch_build`` when that is set.  The
port's console scripts carry a ``-torch`` suffix.
"""

from setuptools import find_packages, setup

setup(
    name="pydca_tpu",
    version="0.1.0",
    description="TPU-native Direct Coupling Analysis (mfDCA + plmDCA) on JAX",
    packages=find_packages(
        include=["pydca_tpu", "pydca_tpu.*", "pydca_tpu_torch", "pydca_tpu_torch.*"]
    ),
    # the port's CUDA sources compile with nvcc, its codec with g++, at first use
    package_data={"pydca_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "torch"],
    entry_points={
        "console_scripts": [
            "mfdca=pydca_tpu.cli.mfdca_main:run_meanfield_dca",
            "plmdca=pydca_tpu.cli.plmdca_main:run_plm_dca",
            "pydca=pydca_tpu.cli.main:run_pydca",
            "a2m2aln=pydca_tpu.extras.a2m2aln:run_a2m2aln",
            "mfdca-torch=pydca_tpu_torch.cli.mfdca_main:main",
            "plmdca-torch=pydca_tpu_torch.cli.plmdca_main:main",
            "pydca-torch=pydca_tpu_torch.cli.main:run_pydca",
            "a2m2aln-torch=pydca_tpu_torch.extras.a2m2aln:run_a2m2aln",
        ],
    },
)
