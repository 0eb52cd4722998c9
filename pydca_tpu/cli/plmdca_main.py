"""``plmdca`` console entry point — pseudolikelihood-maximization DCA CLI.

Mirrors the reference CLI (``pydca/plmdca_main.py``): subcommands
``compute_fn``, ``compute_di``, ``compute_params``; adds ``--lambda_h
--lambda_J --max_iterations --num_threads`` to the common flags; output naming
``PLMDCA_{apc,raw}_{fn,di}_scores_<msa>.txt`` (``plmdca_main.py:195-222``).
``--num_threads`` is accepted for compatibility; compute runs on the device.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..io import output as dca_utilities
from ..plm import PlmDCA

logger = logging.getLogger(__name__)

SUBCOMMANDS = ("compute_fn", "compute_di", "compute_params")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plmdca",
        description=(
            "Pseudolikelihood-maximization direct coupling analysis "
            "(pydca_tpu on JAX)"
        ),
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)
    for name, desc in [
        ("compute_fn", "compute Frobenius-norm DCA scores"),
        ("compute_di", "compute direct-information DCA scores"),
        ("compute_params", "extract fields and ranked couplings"),
    ]:
        sp = subparsers.add_parser(name, help=desc)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("msa_file")
        sp.add_argument("--seqid", type=float)
        sp.add_argument("--lambda_h", type=float)
        sp.add_argument("--lambda_J", type=float)
        sp.add_argument("--max_iterations", type=int)
        sp.add_argument("--num_threads", type=int, help="ignored (compute runs on the device)")
        sp.add_argument(
            "--seq_block", type=int,
            help="stream the loss over sequence blocks of this size "
            "(auto-enabled for very deep alignments)",
        )
        sp.add_argument(
            "--precision",
            choices=["auto", "bfloat16", "float32"],
            help="matmul operand precision (default auto = float32 operands, "
            "which a GPU multiplies as TF32 under JAX's DEFAULT precision; "
            "bfloat16 casts the operands explicitly)",
        )
        sp.add_argument(
            "--param_space",
            choices=["auto", "w2", "compact"],
            help="optimizer parameterization: compact (= auto default) uses "
            "the reference's flat pair layout; w2 runs L-BFGS over the full "
            "symmetric coupling matrix (cheaper per evaluation, 2x optimizer "
            "memory/traffic)",
        )
        sp.add_argument(
            "--checkpoint",
            metavar="PATH",
            help="periodically save the optimizer state to PATH and resume "
            "from it if it exists",
        )
        sp.add_argument(
            "--mesh",
            choices=["auto", "single"],
            default="auto",
            help="auto (default): shard sequences over all visible devices "
            "when more than one is present; single: one device",
        )
        sp.add_argument("--refseq_file")
        sp.add_argument("--output_dir")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--apc", action="store_true")
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
        help="compile the plmDCA programs for this MSA's shapes into the "
        "persistent cache (no compute); the next plmdca process on the "
        "same MSA starts cache-warm",
    )
    sw.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sw.add_argument("msa_file")
    sw.add_argument("--seqid", type=float)
    sw.add_argument("--max_iterations", type=int)
    sw.add_argument("--seq_block", type=int)
    sw.add_argument(
        "--precision", choices=["auto", "bfloat16", "float32"]
    )
    sw.add_argument("--chunk_size", type=int)
    sw.add_argument(
        "--param_space", choices=["auto", "w2", "compact"], default="auto"
    )
    sw.add_argument(
        "--mesh",
        choices=["auto", "single"],
        default="auto",
        help="warm the programs for the matching compute_* --mesh mode "
        "(auto = GSPMD-sharded over all visible devices; default matches "
        "the compute commands)",
    )
    sw.add_argument("--verbose", action="store_true")

    # family batching: N MSAs padded to one (F, Nmax, Lmax) block, fitted
    # and scored in one vmapped device program (pydca_tpu.family)
    sb = subparsers.add_parser(
        "compute_fn_batch",
        help="FN scores for MANY MSA families in one vmapped device program",
    )
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+", help="one FASTA file per family")
    sb.add_argument("--seqid", type=float)
    sb.add_argument("--max_iterations", type=int)
    sb.add_argument("--output_dir")
    sb.add_argument("--verbose", action="store_true")
    sb.add_argument("--apc", action="store_true")
    sb.add_argument(
        "--no_bucket",
        action="store_true",
        help="disable (N, L) bucketing and pad all families to one block "
        "(bucketing groups similar-size families per compiled program, "
        "cutting padded-FLOP waste on heterogeneous batches)",
    )
    return parser


def execute_from_command_line(
    msa_file=None,
    biomolecule=None,
    the_command=None,
    seqid=None,
    lambda_h=None,
    lambda_J=None,
    max_iterations=None,
    num_threads=None,
    refseq_file=None,
    verbose=False,
    output_dir=None,
    apc=False,
    ranked_by=None,
    linear_dist=None,
    num_site_pairs=None,
    seq_block=None,
    precision=None,
    checkpoint=None,
    mesh="auto",
    param_space="auto",
):
    if verbose:
        configure_logging()
    inst = PlmDCA(
        msa_file,
        biomolecule,
        seqid=seqid,
        lambda_h=lambda_h,
        lambda_J=lambda_J,
        max_iterations=max_iterations,
        num_threads=num_threads,
        verbose=verbose,
        seq_block=seq_block,
        precision=precision,
        checkpoint_path=checkpoint,
        mesh="auto" if mesh == "auto" else None,
        param_space=param_space,
    )
    seqbackmapper = None
    if refseq_file:
        seqbackmapper = SequenceBackmapper(
            alignment_data=list(inst.msa.data),
            refseq_file=refseq_file,
            biomolecule=inst.biomolecule,
        )
    param_metadata = dca_utilities.plmdca_param_metadata(inst)
    if not output_dir:
        base, _ = os.path.splitext(os.path.basename(msa_file))
        output_dir = "PLMDCA_output_" + base
    dca_utilities.create_directories(output_dir)

    if the_command == "compute_fn":
        if apc:
            score_type = "PLMDCA Frobenius norm, average product corrected (APC)"
            scores = inst.compute_sorted_FN_APC(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="PLMDCA_apc_fn_scores_", postfix=".txt"
            )
        else:
            score_type = "PLMDCA Frobenius norm, non-APC (not average product corrected)"
            scores = inst.compute_sorted_FN(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="PLMDCA_raw_fn_scores_", postfix=".txt"
            )
        dca_utilities.write_sorted_dca_scores(
            path, scores, metadata=param_metadata, score_type=score_type
        )

    if the_command == "compute_di":
        if apc:
            score_type = "PLMDCA  DI scores, average product corrected (APC)"
            scores = inst.compute_sorted_DI_APC(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="PLMDCA_apc_di_scores_", postfix=".txt"
            )
        else:
            score_type = "PLMDCA DI scores, non-APC (not average product corrected)"
            scores = inst.compute_sorted_DI(seqbackmapper=seqbackmapper)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, msa_file, prefix="PLMDCA_raw_di_scores_", postfix=".txt"
            )
        dca_utilities.write_sorted_dca_scores(
            path, scores, metadata=param_metadata, score_type=score_type
        )

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
        meta = list(param_metadata)
        meta.append(
            "#\tTotal number of sites whose fields are extracted: {}".format(
                len(fields)
            )
        )
        dca_utilities.write_fields_csv(path, fields, metadata=meta)
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="couplings_", postfix=".txt"
        )
        meta = list(param_metadata)
        meta.append(
            "#\tTotal number of site pairs whose couplings are extracted: {}".format(
                len(couplings)
            )
        )
        meta.append("#\tDCA ranking method used: {}".format((ranked_by or "FN_APC").upper()))
        meta.append(
            "#\tMinimum separation beteween site pairs in sequence: |i - j| > {}".format(
                linear_dist if linear_dist is not None else 4
            )
        )
        dca_utilities.write_couplings_csv(path, couplings, metadata=meta)


def execute_batch(
    msa_files,
    biomolecule,
    seqid=None,
    max_iterations=None,
    output_dir=None,
    apc=False,
    verbose=False,
    bucket=True,
):
    """N families -> vmapped fits -> per-family ranked score files.

    By default families are grouped into (N, L) buckets with one compiled
    program per bucket (``family_plm_fit_bucketed``), which bounds
    padded-FLOP waste on heterogeneous batches; ``bucket=False`` pads
    everything to a single block."""
    if verbose:
        configure_logging()
    from ..family import (
        FamilyBatch,
        family_plm_fit,
        family_plm_fit_bucketed,
        family_plm_scores,
    )
    from ..io.fasta import read_msa

    msas = [read_msa(f, biomolecule) for f in msa_files]
    seqid_v = 0.8 if seqid is None else float(seqid)
    iters = 100 if max_iterations is None else int(max_iterations)
    if bucket:
        scores_per_family, stats_d = family_plm_fit_bucketed(
            msas, seqid=seqid_v, max_iterations=iters, apc=apc
        )
        logger.info(
            "family batch: %d families in %d buckets, padded-FLOP waste "
            "%.2fx (single-block: %.2fx)",
            len(msas),
            stats_d["num_buckets"],
            stats_d["bucketed_waste"],
            stats_d["single_block_waste"],
        )
    else:
        batch = FamilyBatch(msas)
        thetas, _states = family_plm_fit(
            batch, seqid=seqid_v, max_iterations=iters
        )
        scores_per_family = family_plm_scores(batch, thetas, apc=apc)
    if not output_dir:
        output_dir = "PLMDCA_batch_output"
    dca_utilities.create_directories(output_dir)
    prefix = "PLMDCA_apc_fn_scores_" if apc else "PLMDCA_raw_fn_scores_"
    score_type = (
        "PLMDCA Frobenius norm, average product corrected (APC)"
        if apc
        else "PLMDCA Frobenius norm, non-APC (not average product corrected)"
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


def run_plm_dca(argv=None):
    from ..runtime import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if args.the_command == "warmup":
        if args.verbose:
            configure_logging()
        from ..io.fasta import read_msa
        from ..plm import resolve_precision
        from ..warmup import warmup_plm

        msa = read_msa(args.msa_file, args.biomolecule)
        dt = warmup_plm(
            msa.num_seqs,
            msa.seqs_len,
            msa.q,
            seqid=0.8 if args.seqid is None else args.seqid,
            max_iterations=100
            if args.max_iterations is None
            else args.max_iterations,
            seq_block=args.seq_block,
            mm_bf16=resolve_precision(args.precision),
            chunk_size=50 if args.chunk_size is None else args.chunk_size,
            param_space=args.param_space,
            mesh=None if args.mesh == "single" else args.mesh,
        )
        print(
            f"warmed plmDCA cache for N={msa.num_seqs}, L={msa.seqs_len}, "
            f"q={msa.q} ({dt:.1f} s compile)"
        )
        return
    if args.the_command == "compute_fn_batch":
        execute_batch(
            msa_files=args.msa_files,
            biomolecule=args.biomolecule,
            seqid=args.seqid,
            max_iterations=args.max_iterations,
            output_dir=args.output_dir,
            apc=args.apc,
            verbose=args.verbose,
            bucket=not args.no_bucket,
        )
        return
    execute_from_command_line(
        msa_file=args.msa_file,
        biomolecule=args.biomolecule,
        the_command=args.the_command,
        seqid=args.seqid,
        lambda_h=args.lambda_h,
        lambda_J=args.lambda_J,
        max_iterations=args.max_iterations,
        num_threads=args.num_threads,
        refseq_file=args.refseq_file,
        seq_block=args.seq_block,
        precision=args.precision,
        checkpoint=args.checkpoint,
        mesh=args.mesh,
        param_space=getattr(args, "param_space", None) or "auto",
        verbose=args.verbose,
        output_dir=args.output_dir,
        apc=args.apc,
        ranked_by=getattr(args, "ranked_by", None),
        linear_dist=getattr(args, "linear_dist", None),
        num_site_pairs=getattr(args, "num_site_pairs", None),
    )


if __name__ == "__main__":
    run_plm_dca()
