"""pydca_tpu — Direct Coupling Analysis on JAX, run on an NVIDIA GPU.

Brand-new JAX/XLA/Pallas implementation with the capabilities of KIT-MBS/pydca
(mean-field DCA and pseudolikelihood-maximization DCA for protein/RNA MSAs),
designed around matmuls: the counting layer is one-hot matmuls, plmDCA is a single
large matmul per L-BFGS iteration, and the N (alignment depth) axis shards
data-parallel over a device mesh with psum-merged statistics and gradients.
"""

__version__ = "0.1.0"

from .alphabets import PROTEIN, RNA, Alphabet, get_alphabet
from .io.fasta import MSA, read_msa
from .meanfield import MeanFieldDCA

__all__ = [
    "Alphabet",
    "PROTEIN",
    "RNA",
    "get_alphabet",
    "MSA",
    "read_msa",
    "MeanFieldDCA",
    "PlmDCA",
]


def __getattr__(name):
    # Lazy import to keep `import pydca_tpu` light.
    if name == "PlmDCA":
        from .plm import PlmDCA

        return PlmDCA
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
