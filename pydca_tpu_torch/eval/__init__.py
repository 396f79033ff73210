from .pdb import PDBContent, Residue, parse_pdb_atoms  # noqa: F401
from .visualizer import (  # noqa: F401
    DCAContent,
    DCAVisualizer,
    RefSeqContent,
    RNASecStructContent,
)
