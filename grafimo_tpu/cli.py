"""Command line interface.

Reproduces the reference's two-subcommand CLI surface and flag set
(``src/grafimo/__main__.py:119-413``, ``GRAFIMOArgumentParser.py:18-135``)
over the JAX scan pipeline.
"""

import argparse
import multiprocessing
import sys

from grafimo_tpu import __version__
from grafimo_tpu.config import BuildVG, Findmotif
from grafimo_tpu.errors import GrafimoError
from grafimo_tpu.utils.constants import DEFAULT_OUTDIR, NOMAP, UNIF
from grafimo_tpu.utils.misc import parse_namemap


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="grafimo-tpu",
        description=(
            "GRAFIMO-TPU: scan genome variation graphs for DNA motif "
            "occurrences on an accelerator"
        ),
    )
    parser.add_argument(
        "workflow", choices=["buildvg", "findmotif"],
        help="workflow to run",
    )
    general = parser.add_argument_group("General options")
    general.add_argument("--version", action="version", version=__version__)
    general.add_argument(
        "-j", "--cores", type=int, default=0, dest="cores",
        help="number of host CPU cores (0 = all). Default: %(default)s.",
    )
    general.add_argument(
        "--verbose", action="store_true", default=False,
        help="print additional information",
    )
    general.add_argument(
        "--debug", action="store_true", default=False,
        help="trace the full error stack",
    )
    general.add_argument(
        "-o", "--out", type=str, default="", dest="out",
        help="output directory",
    )
    build = parser.add_argument_group("Buildvg options")
    build.add_argument(
        "-l", "--linear-genome", type=str, default="", dest="linear_genome",
        help="reference genome FASTA",
    )
    build.add_argument(
        "-v", "--vcf", type=str, default="", dest="vcf",
        help="phased VCF (may be bgzipped). With findmotif: build the "
             "haplotype panel for graphs that import without one (the "
             "reference's interactive indexing of a bare .vg)",
    )
    build.add_argument(
        "--chroms-build", nargs="*", default=[], dest="chroms_build",
        help="chromosomes to build graphs for (default: all in FASTA)",
    )
    build.add_argument(
        "--chroms-prefix-build", type=str, default="",
        dest="chroms_prefix_build",
        help="prefix for graph file names",
    )
    build.add_argument(
        "--chroms-namemap-build", type=str, default=NOMAP,
        dest="chroms_namemap_build",
        help="chromosome name-map file",
    )
    build.add_argument(
        "--reindex", action="store_true", default=False,
        help="rebuild graphs even when present (compat flag)",
    )
    build.add_argument(
        "--export", type=str, default="", choices=["", "gfa", "vg"],
        dest="export",
        help="also write each graph as a vg-toolkit artifact (GFA 1.1 "
        "with haplotype W lines, or BGZF .vg protobuf)",
    )
    find = parser.add_argument_group("Findmotif options")
    find.add_argument(
        "-g", "--genome-graph", type=str, default="", dest="graph_genome",
        help="single variation graph (.gvt.npz)",
    )
    find.add_argument(
        "-d", "--genome-graph-dir", type=str, default="",
        dest="graph_genome_dir",
        help="directory of per-chromosome variation graphs",
    )
    find.add_argument(
        "-b", "--bedfile", type=str, default="", help="UCSC BED regions file"
    )
    find.add_argument(
        "-m", "--motif", nargs="+", default=[], dest="motif",
        help="motif PWM file(s) (JASPAR, MEME, TRANSFAC or PFM)",
    )
    find.add_argument(
        "-k", "--bgfile", type=str, default=UNIF, dest="bgfile",
        help="background file (Markov Background Model format)",
    )
    find.add_argument(
        "-p", "--pseudo", type=float, default=0.1, dest="pseudo",
        help="pseudocount added to motif counts. Default: %(default)s.",
    )
    find.add_argument(
        "-t", "--threshold", type=float, default=1e-4, dest="threshold",
        help="p-value (or q-value with --qvalueT) report threshold. "
             "Default: %(default)s.",
    )
    find.add_argument(
        "-q", "--no-qvalue", action="store_true", default=False,
        dest="no_qvalue", help="skip q-value computation",
    )
    find.add_argument(
        "-r", "--no-reverse", action="store_true", default=False,
        dest="no_reverse", help="scan only the forward strand",
    )
    find.add_argument(
        "-f", "--text-only", action="store_true", default=False,
        dest="text_only", help="print results to stdout",
    )
    find.add_argument(
        "--chroms-find", nargs="*", default=[], dest="chroms_find",
        help="chromosomes to scan (default: those in the BED file)",
    )
    find.add_argument(
        "--chroms-prefix-find", type=str, default="",
        dest="chroms_prefix_find", help="graph file name prefix",
    )
    find.add_argument(
        "--chroms-namemap-find", type=str, default=NOMAP,
        dest="chroms_namemap_find", help="chromosome name-map file",
    )
    find.add_argument(
        "--recomb", action="store_true", default=False,
        help="report also unobserved recombinant windows",
    )
    find.add_argument(
        "--qvalueT", action="store_true", default=False, dest="qval_t",
        help="apply the threshold on q-values",
    )
    find.add_argument(
        "--top-graphs", type=int, default=0, dest="top_graphs",
        help="write images of the top N region graphs",
    )
    find.add_argument(
        "--engine", type=str, default="runs", choices=["runs", "windows"],
        help="scan engine: run-compressed device scan (default) or the "
             "per-window reference path",
    )
    find.add_argument(
        "--profile", type=str, default="", dest="profile_dir",
        help="write a jax profiler trace of the scan phase to this "
             "directory",
    )
    find.add_argument(
        "--cache-dir", type=str, default="", dest="cache_dir",
        help="persist/reuse extracted scan batches (checkpoint/resume for "
             "large scans)",
    )
    find.add_argument(
        "--coordinator", type=str, default="", dest="coordinator",
        help="multi-host: jax.distributed coordinator address host:port "
             '(or "auto" to autodetect in managed cluster environments)',
    )
    find.add_argument(
        "--num-processes", type=int, default=0, dest="num_processes",
        help="multi-host: total number of processes",
    )
    find.add_argument(
        "--process-id", type=int, default=-1, dest="process_id",
        help="multi-host: this process's index (0-based)",
    )
    return parser


def args_to_workflow(args: argparse.Namespace):
    cores = args.cores if args.cores > 0 else multiprocessing.cpu_count()
    outdir = args.out if args.out else DEFAULT_OUTDIR
    if args.workflow == "buildvg":
        if args.graph_genome or args.graph_genome_dir or args.bedfile or \
                args.motif:
            raise ValueError(
                "findmotif options are not allowed with the buildvg workflow"
            )
        if not args.linear_genome or not args.vcf:
            raise ValueError(
                "buildvg requires --linear-genome and --vcf"
            )
        return BuildVG(
            reference_genome=args.linear_genome,
            vcf=args.vcf,
            chroms=args.chroms_build,
            chroms_prefix=args.chroms_prefix_build,
            namemap=parse_namemap(args.chroms_namemap_build),
            cores=cores,
            outdir=outdir,
            reindex=args.reindex,
            export=args.export,
            verbose=args.verbose,
            debug=args.debug,
        )
    if args.linear_genome or args.export:
        raise ValueError(
            "buildvg options are not allowed with the findmotif workflow"
        )
    return Findmotif(
        bedfile=args.bedfile,
        motifs=args.motif,
        graph_genome=args.graph_genome,
        graph_genome_dir=args.graph_genome_dir,
        chroms=args.chroms_find,
        chroms_prefix=args.chroms_prefix_find,
        namemap=parse_namemap(args.chroms_namemap_find),
        bgfile=args.bgfile,
        pseudo=args.pseudo,
        threshold=args.threshold,
        no_qvalue=args.no_qvalue,
        no_reverse=args.no_reverse,
        text_only=args.text_only,
        qval_t=args.qval_t,
        recomb=args.recomb,
        top_graphs=args.top_graphs,
        cores=cores,
        outdir=outdir,
        verbose=args.verbose,
        debug=args.debug,
        engine=args.engine,
        profile_dir=args.profile_dir,
        cache_dir=args.cache_dir,
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        vcf=args.vcf,
    )


def main(argv=None) -> int:
    """Run one workflow with the reference's error discipline: EVERY
    uncaught exception prints one red line and exits 1 unless ``--debug``
    (the reference installs a global ``sys.excepthook`` for this,
    ``grafimo.py:29`` + ``utils.py:63-80``); SIGINT prints a notice and
    exits 2 (``utils.py:54-60``)."""
    from grafimo_tpu.workflows import buildvg, findmotif

    parser = get_parser()
    args = parser.parse_args(argv)
    try:
        workflow = args_to_workflow(args)
        if args.workflow == "buildvg":
            buildvg(workflow)
        else:
            findmotif(workflow)
    except KeyboardInterrupt:
        sys.stderr.write("\nCaught SIGINT. GRAFIMO-TPU will exit\n")
        return 2
    except GrafimoError as e:
        if args.debug:
            raise
        sys.stderr.write(f"\033[31m\nERROR: {e}\033[0m\n")
        return 1
    except Exception as e:  # noqa: BLE001 — excepthook semantics
        if args.debug:
            raise
        sys.stderr.write(f"\033[31m\nERROR: {e}\033[0m\n")
        return 1
    return 0
