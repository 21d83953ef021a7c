"""Workflow orchestration: ``buildvg`` and ``findmotif``.

Reference: ``src/grafimo/grafimo.py:32-192`` + ``constructVG.py:137-293``.
Both workflows are in-memory pipelines here — no subprocesses, no tmp-dir
file bus:

``buildvg``: FASTA + phased VCF -> one ``.gvt`` site graph (with the
haplotype bitset index) per chromosome, replacing the reference's
``vg construct`` / ``vg index`` XG+GBWT artifacts.

``findmotif``: graphs + BED + motif PWMs -> per-motif scored report.  One
extraction pass per distinct motif width shared across motifs (reference
``grafimo.py:176``, ``motif_set.py:97-102``), window batches streamed
through the device scoring path, reports written per motif.
"""

import os
import time
from typing import Dict, List, Tuple

from grafimo_tpu.config import BuildVG, Findmotif
from grafimo_tpu.errors import GraphError
from grafimo_tpu.graph.extract import extract_region
from grafimo_tpu.graph.sitegraph import SiteGraph, build_graph
from grafimo_tpu.io.bed import read_bed_regions
from grafimo_tpu.io.fasta import fasta_chrom_names, read_fasta
from grafimo_tpu.io.vcf import read_vcf_records
from grafimo_tpu.models.motif import MotifSet
from grafimo_tpu.models.parse import load_motifs
from grafimo_tpu.report.writer import print_results, write_results
from grafimo_tpu.scan import ScanStats, compute_results
from grafimo_tpu.utils.compile_cache import enable_compile_cache
from grafimo_tpu.utils.constants import DEFAULT_OUTDIR

GVT_SUFFIX = ".gvt.npz"


def print_welcome() -> None:
    """Startup banner (reference ``printWelcomeMsg``,
    ``grafimo.py:195-217``)."""
    from grafimo_tpu import __version__

    print("\n" + "*" * 54)
    print("  GRAFIMO-TPU — variation-graph motif scanning")
    print(f"  version {__version__}")
    print("*" * 54 + "\n")


def check_deps() -> None:
    """Preflight the compute stack (reference ``check_deps`` verified the
    external vg/tabix/dot binaries, ``utils.py:188-209``; this framework
    has no external binaries — it verifies the jax backend and reports
    whether the native engine is available)."""
    import jax

    devices = jax.devices()
    if not devices:
        raise RuntimeError("no jax devices available")
    try:
        from grafimo_tpu.native import seq_tail_sums  # noqa: F401

        native = "native engine: available"
    except Exception as e:
        native = f"native engine: unavailable ({e}); python fallbacks active"
    print(
        f"compute backend: {devices[0].platform} x{len(devices)} "
        f"({devices[0].device_kind}); {native}"
    )


def graph_filename(outdir: str, prefix: str, chrom: str) -> str:
    return os.path.join(outdir, f"{prefix}{chrom}{GVT_SUFFIX}")


def buildvg(workflow: BuildVG) -> List[str]:
    """Build per-chromosome site graphs (reference ``construct_vg``,
    ``constructVG.py:137-293``); returns the written graph paths."""
    workflow.validate()
    print_welcome()
    outdir = workflow.outdir
    if outdir == DEFAULT_OUTDIR:
        outdir = os.getcwd()
    os.makedirs(outdir, exist_ok=True)
    chroms = workflow.chroms
    if not chroms:
        chroms = fasta_chrom_names(workflow.reference_genome)
    if workflow.verbose:
        print(f"Building variation graphs for chromosomes: {chroms}")
    seqs = read_fasta(workflow.reference_genome, chroms)
    written = []
    for chrom in chroms:
        if chrom not in seqs:
            raise GraphError(
                f"chromosome {chrom} not found in "
                f"{workflow.reference_genome}"
            )
        start = time.time()
        name = chrom
        if workflow.namemap:
            name = workflow.namemap.get(chrom, chrom)
        path = graph_filename(outdir, workflow.chroms_prefix, name)
        export_path = (
            path[: -len(GVT_SUFFIX)] + "." + workflow.export
            if workflow.export
            else None
        )
        if os.path.isfile(path) and not workflow.reindex:
            # reference skips recomputing indexes unless --reindex
            # (constructVG.py:213-236)
            print(f"graph for {chrom} exists ({path}); skipping "
                  f"(use --reindex to rebuild)")
            written.append(path)
            if export_path and not os.path.isfile(export_path):
                _export_graph(SiteGraph.load(path), export_path)
            continue
        records, n_hap = read_vcf_records(workflow.vcf, chrom)
        graph = build_graph(chrom, seqs[chrom], records, n_hap=n_hap)
        graph.save(path)
        written.append(path)
        if export_path:
            _export_graph(graph, export_path)
        if workflow.verbose:
            print(
                f"graph for {chrom}: {graph.n_nodes} nodes, "
                f"{len(graph.sites)} sites, "
                f"{graph.haplo.n_hap if graph.haplo else 0} haplotypes "
                f"({time.time() - start:.2f}s) -> {path}"
            )
    return written


def _resolve_graph_path(workflow: Findmotif, chrom: str) -> str:
    """Map a BED chromosome name to its graph file (reference name-map /
    prefix translation, ``extract_regions.py:135-226``).  Native ``.gvt``
    graphs take precedence; a vg-exported ``.gfa`` is accepted too."""
    c = chrom[3:] if chrom.startswith("chr") else chrom
    if workflow.namemap:
        c = workflow.namemap.get(c, c)
        name = c
    else:
        name = f"{workflow.chroms_prefix}{c}"
    gvt = os.path.join(workflow.graph_genome_dir, f"{name}{GVT_SUFFIX}")
    if os.path.isfile(gvt):
        return gvt
    for ext in (".gfa", ".vg", ".xg"):
        cand = os.path.join(workflow.graph_genome_dir, f"{name}{ext}")
        if os.path.isfile(cand):
            return cand
    return gvt


def _display_chrom(workflow: Findmotif, chrom: str) -> str:
    """Chromosome name used in region strings (reference strips the
    prefix, ``extract_regions.py:160-164``)."""
    c = chrom[3:] if chrom.startswith("chr") else chrom
    if workflow.namemap:
        return workflow.namemap.get(c, c)
    return c


def _xg_conversion_error(path: str, cause: str = "") -> GraphError:
    """Actionable error for a vg ``.xg`` index that the native parser
    (``graph/xg.py``) could not read — e.g. an XG format version this
    framework has no byte-layout oracle for.  The reference scans
    ``.xg`` through the vg binary (``vg find -x``,
    ``extract_regions.py:180``, ``workflow.py:629``); unparsable files
    need a one-time export."""
    stem = os.path.splitext(path)[0]
    why = f" ({cause})" if cause else ""
    return GraphError(
        f"{path} could not be parsed natively{why}. Export it once "
        f"with\n\n"
        f"    vg convert -p {path} > {stem}.vg\n"
        f"    (or: vg view -g {path} > {stem}.gfa)\n\n"
        f"(a {os.path.basename(stem)}.gbwt sidecar next to the export is "
        f"imported natively for the haplotype panel) and re-run against "
        f"the exported graph."
    )


def load_graph_file(path: str) -> SiteGraph:
    """Load a variation graph: native ``.gvt.npz``, a vg protobuf
    ``.vg`` (``graph/vgproto.py``), a vg succinct ``.xg`` index
    (``graph/xg.py``), or a vg-exported ``.gfa`` (``graph/gfa.py``).
    A ``.gbwt`` sidecar next to a ``.vg``/``.xg`` or W-line-less GFA
    supplies the haplotype panel (``graph/gbwt.py``)."""
    if path.endswith(".xg"):
        from grafimo_tpu.graph.xg import xg_to_sitegraph

        gbwt = path[:-3] + ".gbwt"
        try:
            return xg_to_sitegraph(
                path, gbwt=gbwt if os.path.isfile(gbwt) else None
            )
        except GraphError as exc:
            raise _xg_conversion_error(path, cause=str(exc)) from exc
    for ext, loader_name in ((".gfa", "gfa"), (".vg", "vgproto")):
        if path.endswith(ext):
            if loader_name == "gfa":
                from grafimo_tpu.graph.gfa import (
                    gfa_to_sitegraph as loader,
                )
            else:
                from grafimo_tpu.graph.vgproto import (
                    vg_to_sitegraph as loader,
                )
            gbwt = path[: -len(ext)] + ".gbwt"
            return loader(
                path, gbwt=gbwt if os.path.isfile(gbwt) else None
            )
    return SiteGraph.load(path)


def _warn(msg: str) -> None:
    import sys

    sys.stderr.write(f"\033[33mWARNING: {msg}\033[0m\n")


def _ensure_haplotypes(
    workflow: Findmotif, graph: SiteGraph, path: str
) -> SiteGraph:
    """Haplotype-panel bootstrap for graphs that import without a
    GBWT/walk index — the reference's interactive indexing of a bare
    ``.vg`` (``grafimo.py:134-162`` -> ``vg index -G .gbwt -v VCF``,
    ``constructVG.py:343``), made non-interactive via ``--vcf``.

    With ``--vcf``: rebuild the graph from its own reference backbone +
    the VCF's phased genotypes, which recreates the haplotype bitset
    index (and must reproduce the imported topology — a mismatch means
    the VCF is not the one the graph was built from).  Without: warn
    loudly, since every window then reports haplotype frequency 0 and
    is dropped unless ``--recomb``."""
    if graph.haplo is not None:
        return graph
    if not workflow.vcf:
        _warn(
            f"{path}: no haplotype index (no .gbwt sidecar / GFA walks) "
            f"— every window reports haplotype frequency 0 and is "
            f"dropped from the report unless --recomb. Pass --vcf "
            f"PHASED.vcf.gz to build the panel from the graph's VCF, or "
            f"rebuild with buildvg."
        )
        return graph
    records, n_hap = read_vcf_records(workflow.vcf, graph.chrom)
    if not records:
        raise GraphError(
            f"--vcf {workflow.vcf}: no usable records for chromosome "
            f"{graph.chrom!r} — cannot build a haplotype panel for "
            f"{path}"
        )
    rebuilt = build_graph(graph.chrom, graph.seq, records, n_hap=n_hap)
    if sorted(rebuilt.node_seqs[1:]) != sorted(graph.node_seqs[1:]):
        _warn(
            f"{path}: graph rebuilt from --vcf differs from the "
            f"imported topology — is {workflow.vcf} the VCF this graph "
            f"was built from? Scanning the rebuilt graph."
        )
    if workflow.verbose:
        print(
            f"haplotype panel for {graph.chrom} built from "
            f"{workflow.vcf} ({rebuilt.haplo.n_hap if rebuilt.haplo else 0}"
            f" haplotypes)"
        )
    return rebuilt


def _load_graphs(
    workflow: Findmotif, chroms_in_bed: List[str]
) -> Dict[str, Tuple[str, SiteGraph]]:
    """Load the graph for every requested chromosome; returns
    ``{bed_chrom: (display_name, graph)}``."""
    selected = workflow.chroms
    graphs: Dict[str, Tuple[str, SiteGraph]] = {}
    if workflow.has_graphgenome():
        g = load_graph_file(workflow.graph_genome)
        g = _ensure_haplotypes(workflow, g, workflow.graph_genome)
        for chrom in chroms_in_bed:
            c = chrom[3:] if chrom.startswith("chr") else chrom
            if selected and c not in selected:
                continue
            if c == g.chrom or chrom == g.chrom:
                graphs[chrom] = (_display_chrom(workflow, chrom), g)
        if not graphs:
            raise GraphError(
                f"graph chromosome {g.chrom!r} does not match any BED "
                f"chromosome {chroms_in_bed}"
            )
        return graphs
    for chrom in chroms_in_bed:
        c = chrom[3:] if chrom.startswith("chr") else chrom
        if selected and c not in selected:
            continue
        path = _resolve_graph_path(workflow, chrom)
        if not os.path.isfile(path):
            raise GraphError(
                f"unable to locate {path} — are your graphs named with "
                f'"chr"? Consider --chroms-prefix-find or '
                f"--chroms-namemap-find"
            )
        g = _ensure_haplotypes(workflow, load_graph_file(path), path)
        graphs[chrom] = (_display_chrom(workflow, chrom), g)
    return graphs


def _scan_cache_path(workflow: Findmotif, regions, width: int) -> str:
    """Checkpoint file for one (graph inputs, region set, width); keyed by
    graph paths + mtimes so edited graphs invalidate the cache."""
    import hashlib

    import jax

    h = hashlib.sha256()
    h.update(b"scan-cache-v1")
    if jax.process_count() > 1:
        # per-host region shards differ: key the checkpoint per process
        h.update(f"proc{jax.process_index()}/{jax.process_count()}".encode())
    sources = []
    if workflow.has_graphgenome():
        sources.append(workflow.graph_genome)
    else:
        for chrom in sorted(regions):
            sources.append(_resolve_graph_path(workflow, chrom))
    for p in sources:
        try:
            h.update(f"{p}:{os.path.getmtime(p)}".encode())
        except OSError:
            h.update(p.encode())
    for chrom in sorted(regions):
        h.update(chrom.encode())
        for s, e in regions[chrom]:
            h.update(f"{s}-{e};".encode())
    h.update(str(width).encode())
    os.makedirs(workflow.cache_dir, exist_ok=True)
    return os.path.join(
        workflow.cache_dir, f"scan_{h.hexdigest()[:20]}.npz"
    )


def findmotif(workflow: Findmotif) -> List[str]:
    """Scan the variation graph(s) for motif occurrences
    (reference ``findmotif``, ``grafimo.py:80-192``); returns the written
    report directories (empty for ``--text-only``)."""
    workflow.validate()
    enable_compile_cache()
    # multi-host: initialise jax.distributed BEFORE any backend
    # touch (the mesh must span all hosts' devices); single-host runs
    # skip this entirely (SURVEY.md §2.18/§5.8)
    n_proc, proc_id = 1, 0
    if workflow.coordinator or workflow.num_processes:
        from grafimo_tpu.parallel.cluster import initialize_cluster

        initialize_cluster(
            coordinator_address=(
                None
                if workflow.coordinator in ("", "auto")
                else workflow.coordinator
            ),
            num_processes=workflow.num_processes or None,
            process_id=(
                workflow.process_id if workflow.process_id >= 0 else None
            ),
        )
        import jax

        n_proc = jax.process_count()
        proc_id = jax.process_index()
    if proc_id == 0:
        print_welcome()
        check_deps()
    # motifs
    motif_set = MotifSet()
    for motif_file in workflow.motifs:
        motif_set.add(
            load_motifs(
                motif_file, workflow.bgfile, workflow.pseudo,
                workflow.no_reverse,
            )
        )
    print(f"Read {len(motif_set)} motif(s); widths: {sorted(motif_set.widths)}")
    # regions + graphs
    regions, region_num = read_bed_regions(workflow.bedfile)
    if proc_id == 0:
        print(f"Found {region_num} regions in {workflow.bedfile}")
    graphs = _load_graphs(workflow, list(regions.keys()))
    if n_proc > 1:
        # deterministic round-robin region shard per host — every host
        # scans its own regions; histograms merge inside the scan
        # (runscan.compute_results_runs) and host 0 writes the report
        from grafimo_tpu.parallel.cluster import shard_regions

        flat = [
            (chrom, s, e)
            for chrom in regions
            for (s, e) in regions[chrom]
        ]
        mine = shard_regions(flat, proc_id, n_proc)
        regions = {}
        for chrom, s, e in mine:
            regions.setdefault(chrom, []).append((s, e))
        if workflow.verbose:
            print(
                f"process {proc_id}/{n_proc}: scanning "
                f"{len(mine)}/{len(flat)} regions"
            )
    # optional structured profiling of the scan phase (the reference only
    # had wall-clock timers, SURVEY.md §5.1; this emits a full jax
    # profiler trace viewable in tensorboard/xprof)
    profile_ctx = None
    if workflow.profile_dir:
        import contextlib

        import jax

        profile_ctx = contextlib.ExitStack()
        profile_ctx.enter_context(
            jax.profiler.trace(workflow.profile_dir)
        )
    # one extraction pass per distinct width, shared by all motifs of that
    # width (reference grafimo.py:176)
    results: Dict[str, object] = {}
    if workflow.engine == "runs":
        # production path: run-compressed extraction + device conv scan,
        # all same-width motifs in one pass
        from grafimo_tpu.runscan import (
            build_region_runs,
            compute_results_runs,
        )

        for width in sorted(motif_set.widths):
            t0 = time.time()
            region_runs_list = []
            for chrom, (display, graph) in graphs.items():
                region_runs_list.extend(
                    build_region_runs(
                        graph, display, regions.get(chrom, []), width
                    )
                )
            cache_path = None
            if workflow.cache_dir:
                cache_path = _scan_cache_path(workflow, regions, width)
            if workflow.verbose:
                materialised = [
                    r for r in region_runs_list if r.payloads is not None
                ]
                if materialised:
                    n_runs = sum(len(r.payloads) for r in materialised)
                    print(
                        f"width {width}: {n_runs} runs over "
                        f"{len(region_runs_list)} regions in "
                        f"{time.time() - t0:.2f}s"
                    )
                else:
                    print(
                        f"width {width}: {len(region_runs_list)} regions "
                        f"prepared (native batch pipeline) in "
                        f"{time.time() - t0:.2f}s"
                    )
            tables = compute_results_runs(
                motif_set.by_width(width),
                region_runs_list,
                threshold=workflow.threshold,
                no_qvalue=workflow.no_qvalue,
                qval_t=workflow.qval_t,
                no_reverse=workflow.no_reverse,
                recomb=workflow.recomb,
                verbose=workflow.verbose,
                cores=workflow.cores,
                cache_path=cache_path,
            )
            results.update(tables)
    else:  # per-window reference engine
        batches_per_width = {}
        for width in sorted(motif_set.widths):
            batches = []
            t0 = time.time()
            for chrom, (display, graph) in graphs.items():
                for start, stop in regions.get(chrom, []):
                    batch = extract_region(
                        graph, start, stop, width, chrom_display=display,
                        both_strands=True,
                    )
                    if len(batch):
                        batches.append(batch)
            batches_per_width[width] = batches
            if workflow.verbose:
                n = sum(len(b) for b in batches)
                print(
                    f"width {width}: extracted {n} candidate windows in "
                    f"{time.time() - t0:.2f}s"
                )
        for motif in motif_set:
            stats = ScanStats()
            results[motif.motif_id] = compute_results(
                motif,
                batches_per_width[motif.width],
                threshold=workflow.threshold,
                no_qvalue=workflow.no_qvalue,
                qval_t=workflow.qval_t,
                no_reverse=workflow.no_reverse,
                recomb=workflow.recomb,
                stats=stats,
            )
            print(f"Scanned sequences:\t{stats.seqs_scanned}")
            print(f"Scanned nucleotides:\t{stats.nucs_scanned}")
    if profile_ctx is not None:
        profile_ctx.close()
        print(f"profiler trace written to {workflow.profile_dir}")
    # write / print reports per motif; in a multi-host run every host
    # holds the identical merged results — host 0 writes
    if n_proc > 1 and proc_id != 0:
        return []
    outdirs = []
    chrom_graphs = {d: g for (d, g) in graphs.values()}
    for motif in motif_set:
        table = results[motif.motif_id]
        if workflow.text_only:
            print_results(table)
        else:
            outdirs.append(
                write_results(
                    table,
                    motif.motif_id,
                    len(motif_set),
                    workflow.outdir,
                    no_qvalue=workflow.no_qvalue,
                    top_graphs=workflow.top_graphs,
                    graphs=chrom_graphs,
                    verbose=workflow.verbose,
                )
            )
    return outdirs
