"""Command-line interface.

Mirrors the reference's command tree (``/root/reference/src/cli.rs:53-138``):

  varlociraptor-tpu preprocess variants REF --bam BAM --candidates VCF ...
  varlociraptor-tpu call variants generic --scenario YAML --obs S=OBS ...
  varlociraptor-tpu call variants tumor-normal --tumor OBS --normal OBS ...
  varlociraptor-tpu filter-calls control-fdr CALLS --events E --fdr A ...
  varlociraptor-tpu filter-calls posterior-odds --odds LEVEL --events E CALLS
  varlociraptor-tpu estimate alignment-properties REF --bam BAM
  varlociraptor-tpu estimate contamination --sample OBS --contaminant OBS
  varlociraptor-tpu estimate mutational-burden ...
  varlociraptor-tpu decode-phred
  varlociraptor-tpu genotype
  varlociraptor-tpu methylation-candidates REF OUTPUT
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="varlociraptor-tpu",
        description="Bayesian variant calling in JAX (varlociraptor capabilities)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    # ---- preprocess ----
    pre = sub.add_parser("preprocess", help="preprocess a sample into observations")
    pre_sub = pre.add_subparsers(dest="kind", required=True)
    pv = pre_sub.add_parser("variants")
    pv.add_argument("reference")
    pv.add_argument("--bam", required=True)
    pv.add_argument("--candidates", required=True)
    pv.add_argument("--output", required=True)
    pv.add_argument("--sample-name", default="sample")
    pv.add_argument("--alignment-properties", default=None)
    pv.add_argument("--max-depth", type=int, default=200)
    pv.add_argument(
        "--realignment-window", "--indel-window", type=int, default=64,
        dest="realignment_window",
        help="window around breakpoints for realignment "
             "(reference flag name: --indel-window, cli.rs:310-316)",
    )
    pv.add_argument(
        "--reference-buffer-size", type=int, default=10,
        help="number of contigs kept in the FASTA LRU buffer (cli.rs:268-276)",
    )
    pv.add_argument(
        "--min-bam-refetch-distance", type=int, default=1,
        help="accepted for reference compatibility (cli.rs:278-288); the "
             "block-cached indexed BAM reader makes refetch batching "
             "unnecessary, so the value is not used",
    )
    pv.add_argument("--pairhmm-mode", default="exact", choices=["exact", "fast", "homopolymer"])
    pv.add_argument("--omit-insert-size", action="store_true")
    pv.add_argument("--threads", type=int, default=1,
                    help="worker processes (host data parallelism; equivalent "
                         "to per-region sharding)")
    pv.add_argument("--report-fragment-ids", action="store_true")
    pv.add_argument("--region", default=None,
                    help="restrict to CHROM or CHROM:START-END (region sharding)")
    pv.add_argument("--output-raw-observations", default=None,
                    help="directory for per-locus raw-observation TSVs")
    pv.add_argument("--log-mode", default="default",
                    choices=["default", "each-record"],
                    help="progress logging granularity (cli.rs:348-357)")
    pv.add_argument(
        "--propagate-info-fields",
        nargs="*",
        default=[],
        help="candidate INFO fields copied through to the final calls",
    )

    # ---- call ----
    call = sub.add_parser("call", help="call variants from observations")
    call_sub = call.add_subparsers(dest="kind", required=True)
    cv = call_sub.add_parser("variants")
    cv_sub = cv.add_subparsers(dest="mode", required=True)

    cg = cv_sub.add_parser("generic")
    cg.add_argument("--scenario", required=True)
    cg.add_argument("--obs", nargs="+", required=True, help="sample=observations.jsonl pairs")
    cg.add_argument("--output", required=True)
    for flag in (
        "omit-strand-bias",
        "omit-read-orientation-bias",
        "omit-read-position-bias",
        "omit-softclip-bias",
        "omit-homopolymer-artifact-detection",
        "omit-alt-locus-bias",
    ):
        cg.add_argument(f"--{flag}", action="store_true")
    cg.add_argument("--full-prior", action="store_true")
    cg.add_argument("--resolution", type=float, default=0.01)
    cg.add_argument("--testcase-locus", default=None, help="CHROM:POS or 'all'")
    cg.add_argument("--testcase-prefix", default=None)
    cg.add_argument("--testcase-anonymous", action="store_true")

    tn = cv_sub.add_parser("tumor-normal")
    tn.add_argument("--tumor", required=True)
    tn.add_argument("--normal", required=True)
    tn.add_argument("--purity", type=float, default=1.0)
    tn.add_argument("--output", required=True)

    # experimental CNV segmentation (the reference ships this disabled,
    # cli.rs:641-680; same caveat applies)
    cn = call_sub.add_parser(
        "cnvs", help="EXPERIMENTAL: HMM CNV segmentation of tumor/normal calls"
    )
    cn.add_argument("calls", help="tumor-normal calls VCF/BCF")
    cn.add_argument("--output", required=True)
    cn.add_argument("--tumor-sample", default="tumor")
    cn.add_argument("--normal-sample", default="normal")
    cn.add_argument("--purity", type=float, required=True)
    cn.add_argument("--min-bayes-factor", type=float, default=1.01)
    cn.add_argument("--max-dist", type=int, default=10**9)
    cn.add_argument("--tumor-obs", default=None,
                    help="tumor observation file: per-locus depth comes from "
                         "its depth observations (raw pre-subsampling "
                         "coverage) instead of the calls' FORMAT DP")
    cn.add_argument("--normal-obs", default=None)

    # ---- filter-calls ----
    fc = sub.add_parser("filter-calls", help="filter calls")
    fc_sub = fc.add_subparsers(dest="method", required=True)
    fdr = fc_sub.add_parser("control-fdr")
    fdr.add_argument("calls")
    fdr.add_argument("--output", required=True)
    fdr.add_argument("--events", nargs="+", required=True)
    fdr.add_argument("--fdr", type=float, required=True)
    fdr.add_argument("--var", default=None, help="variant type (SNV/MNV/INS/DEL/...)")
    fdr.add_argument("--min-len", type=int, default=None)
    fdr.add_argument("--max-len", type=int, default=None)
    fdr.add_argument("--mode", default="global-strict",
                     choices=["local-strict", "global-strict", "local-smart", "global-smart"])
    fdr.add_argument("--retain-artifacts", action="store_true")

    odds = fc_sub.add_parser("posterior-odds")
    odds.add_argument("calls")
    odds.add_argument("--output", required=True)
    odds.add_argument("--events", nargs="+", required=True)
    odds.add_argument("--odds", required=True,
                      choices=["none", "barely", "positive", "strong", "very-strong"])

    # ---- estimate ----
    est = sub.add_parser("estimate", help="estimations")
    est_sub = est.add_subparsers(dest="what", required=True)
    ap = est_sub.add_parser("alignment-properties")
    ap.add_argument("reference")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--omit-insert-size", action="store_true")
    ap.add_argument("--num-records", type=int, default=None)

    ct = est_sub.add_parser("contamination")
    ct.add_argument("--sample", required=True)
    ct.add_argument("--contaminant", required=True)
    ct.add_argument("--output", default=None)
    ct.add_argument("--output-plot", default=None)
    ct.add_argument("--output-max-vaf-variants", default=None)
    ct.add_argument("--prior-estimate", type=float, default=None)
    ct.add_argument("--prior-considered-cells", type=int, default=None)
    ct.add_argument("--resolution", type=int, default=100)

    mb = est_sub.add_parser("mutational-burden")
    mb.add_argument("calls", nargs="?", default=None)
    mb.add_argument("--events", nargs="+", required=True)
    mb.add_argument("--sample", nargs="+", required=True,
                    help="sample name(s); several allowed with --mode multibar")
    mb.add_argument("--coding-genome-size", type=float, default=3e7)
    mb.add_argument("--mode", default="curve",
                    choices=["curve", "hist", "multibar", "table"])
    mb.add_argument("--cutoff", type=float, default=0.2,
                    help="minimal VAF for the multibar plot (--vaf-cutoff)")
    mb.add_argument("--vaf-cutoff", type=float, dest="cutoff",
                    help="reference flag name for --cutoff")

    # ---- conversions ----
    dp = sub.add_parser("decode-phred", help="PHRED PROB_* -> linear probabilities")
    dp.add_argument("calls", nargs="?", default=None)
    dp.add_argument("--output", default=None)

    gt = sub.add_parser("genotype", help="derive GT from AF")
    gt.add_argument("calls", nargs="?", default=None)
    gt.add_argument("--output", default=None)

    # ---- methylation candidates ----
    mc = sub.add_parser("methylation-candidates")
    mc.add_argument("reference")
    mc.add_argument("output")
    mc.add_argument(
        "--motif",
        default="CG",
        help="comma-separated list of CG, CHG, CHH, GATC (cli.rs:128-132)",
    )

    # ---- plot (vega-lite JSON to stdout) ----
    pl = sub.add_parser("plot")
    pl_sub = pl.add_subparsers(dest="what", required=True)
    sc = pl_sub.add_parser("scatter")
    sc.add_argument("calls")
    sc.add_argument("--sample-x", required=True)
    # nargs="+" matches the reference's multi-sample -y (cli.rs:403-404)
    sc.add_argument("--sample-y", required=True, nargs="+")
    vp = pl_sub.add_parser("variant-calling-prior")
    vp.add_argument("--scenario", required=True)
    vp.add_argument("--contig", required=True)
    vp.add_argument("--sample", required=True)

    return p


def run(argv=None):
    args = build_parser().parse_args(argv)

    if args.command == "preprocess":
        from .calling.preprocess import PreprocessOptions, preprocess
        from .estimation.alignment_properties import AlignmentProperties

        props = None
        if args.alignment_properties:
            props = AlignmentProperties.from_json(
                open(args.alignment_properties).read()
            )
        n = preprocess(
            candidates_path=args.candidates,
            bam_path=args.bam,
            reference_path=args.reference,
            output_path=args.output,
            sample_name=args.sample_name,
            alignment_properties=props,
            options=PreprocessOptions(
                max_depth=args.max_depth,
                indel_window=args.realignment_window,
                pairhmm_mode=args.pairhmm_mode,
                omit_insert_size=args.omit_insert_size,
                propagate_info_fields=tuple(args.propagate_info_fields),
                output_raw_observations=args.output_raw_observations,
                report_fragment_ids=args.report_fragment_ids,
                region=args.region,
                log_mode=args.log_mode,
                n_workers=args.threads,
                reference_buffer_size=args.reference_buffer_size,
            ),
        )
        print(f"preprocessed {n} candidate records", file=sys.stderr)
        return 0

    if args.command == "call" and args.kind == "cnvs":
        from .calling.cnvs import call_cnvs

        n = call_cnvs(
            args.calls,
            args.output,
            tumor_sample=args.tumor_sample,
            normal_sample=args.normal_sample,
            purity=args.purity,
            min_bayes_factor=args.min_bayes_factor,
            max_dist=args.max_dist,
            tumor_obs=args.tumor_obs,
            normal_obs=args.normal_obs,
        )
        print(f"called {n} CNV segments (EXPERIMENTAL)", file=sys.stderr)
        return 0

    if args.command == "call":
        from .calling.call import CallOptions, call_generic
        from .grammar.scenario import Scenario, tumor_normal_scenario

        if args.mode == "generic":
            scenario = Scenario.from_path(args.scenario)
            obs = dict(kv.split("=", 1) for kv in args.obs)
            if args.testcase_prefix and args.testcase_locus:
                # capture a replayable testcase (testcase/builder.rs) using
                # the bam/reference/candidate paths recorded in each
                # observation file's header
                from .calling.observations import ObservationReader
                from .testcase_builder import build_testcase

                sample_bams = {}
                sample_opts = {}
                ref_path = candidates = None
                for name, path in obs.items():
                    hdr = ObservationReader(path).header.get("options", {})
                    sample_bams[name] = hdr["bam"]
                    ref_path = hdr["reference"]
                    candidates = hdr.get("candidates")
                    sample_opts[name] = json.dumps(
                        {"Preprocess": {"kind": {"Variants": hdr}}}
                    )
                if candidates is None:
                    raise SystemExit(
                        "observation files lack candidate path; rerun preprocess"
                    )
                build_testcase(
                    args.testcase_prefix,
                    args.testcase_locus,
                    candidates,
                    ref_path,
                    sample_bams,
                    scenario_path=args.scenario,
                    sample_options=sample_opts,
                    anonymize=args.testcase_anonymous,
                )
                print(
                    f"testcase written to {args.testcase_prefix}", file=sys.stderr
                )
            options = CallOptions(
                omit_strand_bias=args.omit_strand_bias,
                omit_read_orientation_bias=args.omit_read_orientation_bias,
                omit_read_position_bias=args.omit_read_position_bias,
                omit_softclip_bias=args.omit_softclip_bias,
                omit_homopolymer_artifact_detection=args.omit_homopolymer_artifact_detection,
                omit_alt_locus_bias=args.omit_alt_locus_bias,
                full_prior=args.full_prior,
                resolution=args.resolution,
            )
            n = call_generic(scenario, obs, args.output, options)
        else:
            scenario = tumor_normal_scenario(args.purity)
            obs = {"tumor": args.tumor, "normal": args.normal}
            n = call_generic(scenario, obs, args.output, CallOptions())
        print(f"called {n} records", file=sys.stderr)
        return 0

    if args.command == "filter-calls":
        if args.method == "control-fdr":
            from .filtration.fdr import control_fdr

            local = args.mode.startswith("local")
            smart = args.mode.endswith("smart")
            n = control_fdr(
                args.calls,
                args.output,
                events=args.events,
                alpha=args.fdr,
                vartype=args.var,
                min_len=args.min_len,
                max_len=args.max_len,
                local=local,
                smart=smart,
                smart_retain_artifacts=args.retain_artifacts,
            )
        else:
            from .filtration.posterior_odds import filter_by_odds

            n = filter_by_odds(args.calls, args.output, args.events, args.odds)
        print(f"kept {n} records", file=sys.stderr)
        return 0

    if args.command == "estimate":
        if args.what == "alignment-properties":
            from .estimation.alignment_properties import estimate
            from .io.bam import BamReader
            from .io.fasta import FastaBuffer

            _ref = FastaBuffer(args.reference)
            props = estimate(
                BamReader(args.bam, reference=_ref),
                omit_insert_size=args.omit_insert_size,
                num_records=args.num_records,
                reference=_ref,
            )
            print(props.to_json())
            return 0
        if args.what == "contamination":
            from .estimation.contamination import (
                estimate_contamination,
                write_plot,
                write_tsv,
            )

            prior = None
            if (args.prior_estimate is None) != (args.prior_considered_cells is None):
                print(
                    "--prior-estimate requires --prior-considered-cells "
                    "(and vice versa)",
                    file=sys.stderr,
                )
                return 1
            if args.prior_estimate is not None:
                prior = (args.prior_estimate, args.prior_considered_cells)
            result = estimate_contamination(
                args.sample,
                args.contaminant,
                prior_estimate=prior,
                resolution=args.resolution,
            )
            out = open(args.output, "w") if args.output else sys.stdout
            write_tsv(result, out)
            if args.output:
                out.close()
            if args.output_plot:
                write_plot(result, args.output_plot)
            if args.output_max_vaf_variants:
                with open(args.output_max_vaf_variants, "w") as f:
                    print("chrom\tpos", file=f)
                    for chrom, pos in result["max_vaf_variants"]:
                        print(f"{chrom}\t{pos}", file=f)
            print(
                f"max posterior contamination: "
                f"{result['max_posterior_contamination']:.4f} "
                f"({result['n_variants']} informative variants)",
                file=sys.stderr,
            )
            return 0
        if args.what == "mutational-burden":
            from .estimation.mutational_burden import collect_estimates

            spec = collect_estimates(
                args.calls,
                events=args.events,
                sample=args.sample,
                coding_genome_size=args.coding_genome_size,
                mode=args.mode,
                cutoff=args.cutoff,
            )
            if args.mode == "table":
                print(spec["table"])
            else:
                print(json.dumps(spec, indent=1))
            return 0

    if args.command == "decode-phred":
        from .conversion.decode_phred import decode_phred

        decode_phred(args.calls, args.output)
        return 0

    if args.command == "genotype":
        from .conversion.genotype import genotype

        genotype(args.calls, args.output)
        return 0

    if args.command == "methylation-candidates":
        from .candidates.methylation import find_candidates

        n = find_candidates(args.reference, args.output, motif=args.motif)
        print(f"found {n} candidates", file=sys.stderr)
        return 0

    if args.command == "plot":
        if args.what == "variant-calling-prior":
            from .estimation.prior_plot import plot_variant_calling_prior
            from .grammar.scenario import Scenario

            spec = plot_variant_calling_prior(
                Scenario.from_path(args.scenario), args.contig, args.sample
            )
            print(json.dumps(spec, indent=2))
            return 0
        from .estimation.sample_variants import vaf_scatter

        print(json.dumps(vaf_scatter(args.calls, args.sample_x, args.sample_y)))
        return 0

    raise SystemExit(f"unknown command {args.command}")


def main():
    from .utils.jaxcache import enable as _enable_xla_cache

    _enable_xla_cache()
    sys.exit(run())


if __name__ == "__main__":
    main()
