"""``mfdca`` console entry point — mean-field DCA CLI.

Mirrors the reference CLI surface (``pydca/mfdca_main.py``): subcommands
``compute_di``, ``compute_fn``, ``compute_params``, ``compute_fi``,
``compute_fij``, ``compute_fields``; flags ``--seqid --pseudocount
--refseq_file --apc --ranked_by --linear_dist --num_site_pairs --output_dir
--verbose``; output file naming ``MFDCA_{apc,raw}_{di,fn}_scores_<msa>.txt``
(``mfdca_main.py:185-220``).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..io import output as dca_utilities
from ..meanfield import MeanFieldDCA

DCA_COMPUTATION_SUBCOMMANDS = (
    "compute_di",
    "compute_fn",
    "compute_params",
    "compute_fi",
    "compute_fij",
    "compute_fields",
    "compute_weights",
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mfdca",
        description="Mean-field direct coupling analysis (pydca_tpu on JAX)",
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)
    for name, desc in [
        ("compute_di", "compute direct-information DCA scores"),
        ("compute_fn", "compute Frobenius-norm DCA scores"),
        ("compute_params", "extract fields and ranked couplings"),
        ("compute_fi", "compute (regularized) single-site frequencies"),
        ("compute_fij", "compute (regularized) pair-site frequencies"),
        ("compute_fields", "compute local fields"),
        ("compute_weights", "compute per-sequence reweighting factors"),
    ]:
        sp = subparsers.add_parser(name, help=desc)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("msa_file")
        sp.add_argument("--seqid", type=float, help="sequence identity threshold")
        sp.add_argument("--pseudocount", type=float, help="relative pseudocount")
        sp.add_argument("--refseq_file", help="FASTA file with reference sequence")
        sp.add_argument("--output_dir", help="output directory")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--apc", action="store_true", help="average product correction")
        sp.add_argument(
            "--mesh",
            choices=["auto", "single"],
            default="auto",
            help="auto (default): shard over all visible devices when more "
            "than one is present; single: one device",
        )
        if name == "compute_params":
            sp.add_argument(
                "--ranked_by",
                choices=["FN", "FN_APC", "DI", "DI_APC", "fn", "fn_apc", "di", "di_apc"],
            )
            sp.add_argument("--linear_dist", type=int)
            sp.add_argument("--num_site_pairs", type=int)

    # warm the persistent compilation cache for a dataset's shapes
    sw = subparsers.add_parser(
        "warmup",
        help="compile the mfDCA programs for this MSA's shapes into the "
        "persistent cache (no compute); the next mfdca process on the "
        "same MSA starts cache-warm",
    )
    sw.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sw.add_argument("msa_file")
    sw.add_argument("--seqid", type=float)
    sw.add_argument("--pseudocount", type=float)
    sw.add_argument(
        "--mesh",
        choices=["auto", "single"],
        default="auto",
        help="warm the programs for the matching compute_* --mesh mode",
    )
    sw.add_argument("--verbose", action="store_true")

    # family batching: N MSAs -> one vmapped mean-field device program
    sb = subparsers.add_parser(
        "compute_fn_batch",
        help="FN scores for MANY MSA families in one vmapped device program",
    )
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+", help="one FASTA file per family")
    sb.add_argument("--seqid", type=float)
    sb.add_argument("--pseudocount", type=float)
    sb.add_argument("--output_dir")
    sb.add_argument("--verbose", action="store_true")
    sb.add_argument("--apc", action="store_true")
    return parser


def execute_from_command_line(
    msa_file=None,
    biomolecule=None,
    seqid=None,
    pseudocount=None,
    the_command=None,
    refseq_file=None,
    verbose=False,
    output_dir=None,
    apc=False,
    ranked_by=None,
    linear_dist=None,
    num_site_pairs=None,
    mesh="auto",
):
    if verbose:
        configure_logging()
    if the_command not in DCA_COMPUTATION_SUBCOMMANDS:
        raise SystemExit(f"unknown command {the_command}")

    kwargs = {}
    if pseudocount is not None:
        kwargs["pseudocount"] = pseudocount
    if seqid is not None:
        kwargs["seqid"] = seqid
    if mesh == "auto":
        kwargs["mesh"] = "auto"
    inst = MeanFieldDCA(msa_file, biomolecule, **kwargs)

    seqbackmapper = None
    if refseq_file:
        seqbackmapper = SequenceBackmapper(
            alignment_data=list(inst.msa.data),
            refseq_file=refseq_file,
            biomolecule=inst.biomolecule,
        )
    # Deferred: metadata includes Meff (= the weights), which the fused
    # pipeline program computes together with the scores; building it up
    # front would compile and dispatch a separate weights-only device
    # program first.  Each branch calls this after its compute.
    def param_metadata():
        return dca_utilities.mfdca_param_metadata(inst)

    if not output_dir:
        base, _ = os.path.splitext(os.path.basename(msa_file))
        output_dir = "MFDCA_output_" + base
    dca_utilities.create_directories(output_dir)

    if the_command == "compute_di":
        if apc:
            sorted_di = inst.compute_sorted_DI_APC(seqbackmapper=seqbackmapper)
            score_type = " MF DI average product corrected (APC)"
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="MFDCA_apc_di_scores_", postfix=".txt"
            )
        else:
            sorted_di = inst.compute_sorted_DI(seqbackmapper=seqbackmapper)
            score_type = "raw DI"
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="MFDCA_raw_di_scores_", postfix=".txt"
            )
        dca_utilities.write_sorted_dca_scores(
            path, sorted_di, metadata=param_metadata(), score_type=score_type
        )

    if the_command == "compute_fn":
        if apc:
            score_type = "MFDCA Frobenius norm, average product corrected (APC)"
            sorted_fn = inst.compute_sorted_FN_APC(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="MFDCA_apc_fn_scores_", postfix=".txt"
            )
        else:
            score_type = "MFDCA raw Frobenius norm"
            sorted_fn = inst.compute_sorted_FN(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="MFDCA_raw_fn_scores_", postfix=".txt"
            )
        dca_utilities.write_sorted_dca_scores(
            path, sorted_fn, metadata=param_metadata(), score_type=score_type
        )

    if the_command == "compute_fields":
        fields = inst.compute_fields()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="fields_", postfix=".txt"
        )
        dca_utilities.write_fields_csv(path, sorted(fields.items()), metadata=metadata)

    if the_command == "compute_params":
        fields, couplings = inst.compute_params(
            seqbackmapper=seqbackmapper,
            ranked_by=ranked_by,
            linear_dist=linear_dist,
            num_site_pairs=num_site_pairs,
        )
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="fields_", postfix=".txt"
        )
        meta = list(param_metadata())
        meta.append(
            "#\tTotal number of sites whose fields are extracted: {}".format(
                len(fields)
            )
        )
        dca_utilities.write_fields_csv(path, fields, metadata=meta)
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="couplings_", postfix=".txt"
        )
        meta = list(param_metadata())
        meta.append(
            "#\tTotal number of site pairs whose couplings are extracted: {}".format(
                len(couplings)
            )
        )
        meta.append(
            "#\tDCA ranking method used: {}".format(
                (ranked_by or "FN_APC").upper()
            )
        )
        meta.append(
            "#\tMinimum separation beteween site pairs in sequence: |i - j| > {}".format(
                linear_dist if linear_dist is not None else 4
            )
        )
        dca_utilities.write_couplings_csv(path, couplings, metadata=meta)

    if the_command == "compute_weights":
        import numpy as np

        weights = np.asarray(inst.get_sequences_weight())
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="weights_", postfix=".txt"
        )
        dca_utilities.write_sequence_weights(
            path, weights, ids=inst.msa.ids, metadata=param_metadata()
        )

    if the_command == "compute_fi":
        fi = inst.get_reg_single_site_freqs()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="fi_", postfix=".txt"
        )
        dca_utilities.write_single_site_freqs(
            path,
            fi,
            seqs_len=inst.sequences_len,
            num_site_states=inst.num_site_states,
            metadata=metadata,
        )

    if the_command == "compute_fij":
        fij = inst.get_reg_pair_site_freqs()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="fij_", postfix=".txt"
        )
        dca_utilities.write_pair_site_freqs(
            path,
            fij,
            seqs_len=inst.sequences_len,
            num_site_states=inst.num_site_states,
            metadata=metadata,
        )


def execute_batch(
    msa_files,
    biomolecule,
    seqid=None,
    pseudocount=None,
    output_dir=None,
    apc=False,
    verbose=False,
):
    """N families -> one vmapped mean-field program -> per-family files."""
    if verbose:
        configure_logging()
    from ..family import FamilyBatch, family_meanfield_scores
    from ..io.fasta import read_msa

    msas = [read_msa(f, biomolecule) for f in msa_files]
    batch = FamilyBatch(msas)
    scores_per_family = family_meanfield_scores(
        batch,
        seqid=0.8 if seqid is None else float(seqid),
        pseudocount=0.5 if pseudocount is None else float(pseudocount),
        apc=apc,
    )
    if not output_dir:
        output_dir = "MFDCA_batch_output"
    dca_utilities.create_directories(output_dir)
    prefix = "MFDCA_apc_fn_scores_" if apc else "MFDCA_raw_fn_scores_"
    score_type = (
        "MFDCA Frobenius norm, average product corrected (APC)"
        if apc
        else "MFDCA raw Frobenius norm"
    )
    paths = []
    for msa_file, msa, scores in zip(msa_files, msas, scores_per_family):
        meta = [
            "# PARAMETERS USED FOR THIS COMPUTATION: ",
            "#      Sequence type: {}".format(msa.alphabet.name),
            "#      Total number of sequences in alignment data: {}".format(
                msa.num_seqs
            ),
            "#      Length of sequences in alignment data: {}".format(
                msa.seqs_len
            ),
            "#      Computed in a family batch of {} MSAs".format(len(msas)),
        ]
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix=prefix, postfix=".txt"
        )
        dca_utilities.write_sorted_dca_scores(
            path, scores, metadata=meta, score_type=score_type
        )
        paths.append(path)
    return paths


def run_meanfield_dca(argv=None):
    from ..runtime import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if args.the_command == "warmup":
        if args.verbose:
            configure_logging()
        from ..io.fasta import read_msa
        from ..warmup import warmup_meanfield

        msa = read_msa(args.msa_file, args.biomolecule)
        dt = warmup_meanfield(
            msa.num_seqs,
            msa.seqs_len,
            msa.q,
            seqid=0.8 if args.seqid is None else args.seqid,
            pseudocount=0.5 if args.pseudocount is None else args.pseudocount,
            mesh=None if args.mesh == "single" else args.mesh,
        )
        print(
            f"warmed mfDCA cache for N={msa.num_seqs}, L={msa.seqs_len}, "
            f"q={msa.q} ({dt:.1f} s compile)"
        )
        return
    if args.the_command == "compute_fn_batch":
        execute_batch(
            msa_files=args.msa_files,
            biomolecule=args.biomolecule,
            seqid=args.seqid,
            pseudocount=args.pseudocount,
            output_dir=args.output_dir,
            apc=args.apc,
            verbose=args.verbose,
        )
        return
    execute_from_command_line(
        msa_file=args.msa_file,
        biomolecule=args.biomolecule,
        seqid=args.seqid,
        pseudocount=args.pseudocount,
        the_command=args.the_command,
        refseq_file=args.refseq_file,
        verbose=args.verbose,
        output_dir=args.output_dir,
        apc=args.apc,
        ranked_by=getattr(args, "ranked_by", None),
        linear_dist=getattr(args, "linear_dist", None),
        num_site_pairs=getattr(args, "num_site_pairs", None),
        mesh=args.mesh,
    )


if __name__ == "__main__":
    run_meanfield_dca()
