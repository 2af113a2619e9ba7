"""traincascade-compatible CLI.

Mirrors the reference binary's flag surface (traincascade.cpp:39-166):
defaults numPos=2000, numNeg=1000, numStages=20, winSize 24×24, HAAR
BASIC, GAB stumps. Precalc buffer budgets map onto FeatureCache block
residency (train/boost.py), the device analogue of the reference's
valCache / sorted-index buffers.
"""

from __future__ import annotations

import argparse
import sys

from cascadeclassifier_tpu.models.model import FEATURE_TYPE_IDS, BOOST_TYPE_IDS
from cascadeclassifier_tpu.train.boost import BoostParams
from cascadeclassifier_tpu.train.trainer import CascadeTrainer


def build_parser():
    p = argparse.ArgumentParser(
        prog="tpu-traincascade",
        description="JAX cascade classifier trainer "
        "(opencv_traincascade-compatible)",
        add_help=False,  # -h means sample height, like the reference CLI
    )
    p.add_argument("--help", action="help")
    p.add_argument("-data", required=True, help="output directory")
    p.add_argument("-vec", required=True, help=".vec file with positives")
    p.add_argument("-bg", required=True, help="background image list")
    p.add_argument("-numPos", type=int, default=2000)
    p.add_argument("-numNeg", type=int, default=1000)
    p.add_argument("-numStages", type=int, default=20)
    p.add_argument("-precalcValBufSize", type=int, default=1024,
                   help="resident feature-value budget, MB")
    p.add_argument("-precalcIdxBufSize", type=int, default=1024,
                   help="resident sort-order budget, MB")
    p.add_argument("-baseFormatSave", action="store_true")
    p.add_argument("-numThreads", type=int, default=None,
                   help="accepted for compatibility")
    p.add_argument("-acceptanceRatioBreakValue", type=float, default=-1.0)
    # cascade params
    p.add_argument("-stageType", default="BOOST", choices=["BOOST"])
    p.add_argument("-featureType", default="HAAR",
                   choices=["HAAR", "LBP", "HOG"])
    p.add_argument("-w", type=int, default=24, dest="win_w")
    p.add_argument("-h", type=int, default=24, dest="win_h")
    # boost params
    p.add_argument("-bt", default="GAB", choices=["DAB", "RAB", "LB", "GAB"])
    p.add_argument("-minHitRate", type=float, default=0.995)
    p.add_argument("-maxFalseAlarmRate", type=float, default=0.5)
    p.add_argument("-weightTrimRate", type=float, default=0.95)
    p.add_argument("-maxDepth", type=int, default=1)
    p.add_argument("-maxWeakCount", type=int, default=100)
    # haar params
    p.add_argument("-mode", default="BASIC", choices=["BASIC", "CORE", "ALL"])
    # multi-chip (new capability vs the reference, SURVEY §2.6): shard the
    # feature axis of the split search over a device mesh
    p.add_argument("-numDevices", type=int, default=None,
                   help="devices in the feature-sharded training mesh "
                   "(0/1 = single device; default: all local devices "
                   "when more than one is visible)")
    p.add_argument("-distCoordinator", default=None,
                   help="host:port of process 0 for multi-host training "
                   "(jax.distributed over DCN)")
    p.add_argument("-distNumProcesses", type=int, default=None)
    p.add_argument("-distProcessId", type=int, default=None)
    return p


def resolve_mesh(args):
    """Build the training mesh the flags describe (None = single device).

    Multi-host first: -distCoordinator triggers jax.distributed.initialize
    so jax.devices() spans every host's chips over DCN; the feature mesh
    then covers the global device set."""
    import jax

    if args.distCoordinator is not None:
        from cascadeclassifier_tpu.parallel.sharded import init_distributed

        init_distributed(
            args.distCoordinator,
            args.distNumProcesses,
            args.distProcessId,
        )
    n = args.numDevices
    if n is None:
        n = len(jax.devices())
    if n is not None and n <= 1:
        return None
    from cascadeclassifier_tpu.parallel.sharded import make_mesh

    return make_mesh(n)


def make_trainer(args, mesh=None):
    boost = BoostParams(
        boost_type=BOOST_TYPE_IDS[args.bt],
        min_hit_rate=args.minHitRate,
        max_false_alarm=args.maxFalseAlarmRate,
        weight_trim_rate=args.weightTrimRate,
        max_depth=args.maxDepth,
        weak_count=args.maxWeakCount,
    )
    return CascadeTrainer(
        feature_type=FEATURE_TYPE_IDS[args.featureType],
        win_w=args.win_w,
        win_h=args.win_h,
        haar_mode=args.mode,
        boost=boost,
        precalc_val_mb=args.precalcValBufSize,
        precalc_idx_mb=args.precalcIdxBufSize,
        mesh=mesh,
    )


def print_parameters(args, trainer):
    """Reference-style parameter echo (traincascade.cpp prints the same
    block before training; the feature-count line matches res/README.md
    transcripts)."""
    print("PARAMETERS:")
    print(f"cascadeDirName: {args.data}")
    print(f"vecFileName: {args.vec}")
    print(f"bgFileName: {args.bg}")
    print(f"numPos: {args.numPos}")
    print(f"numNeg: {args.numNeg}")
    print(f"numStages: {args.numStages}")
    print(f"precalcValBufSize[Mb] : {args.precalcValBufSize}")
    print(f"precalcIdxBufSize[Mb] : {args.precalcIdxBufSize}")
    print(f"acceptanceRatioBreakValue : {args.acceptanceRatioBreakValue:g}")
    print(f"stageType: {args.stageType}")
    print(f"featureType: {args.featureType}")
    print(f"sampleWidth: {args.win_w}")
    print(f"sampleHeight: {args.win_h}")
    print(f"boostType: {args.bt}")
    print(f"minHitRate: {args.minHitRate}")
    print(f"maxFalseAlarmRate: {args.maxFalseAlarmRate}")
    print(f"weightTrimRate: {args.weightTrimRate}")
    print(f"maxDepth: {args.maxDepth}")
    print(f"maxWeakCount: {args.maxWeakCount}")
    print(
        "Number of unique features given windowSize "
        f"[{args.win_w},{args.win_h}] : {trainer.evaluator.var_count}"
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = resolve_mesh(args)
    trainer = make_trainer(args, mesh=mesh)
    print_parameters(args, trainer)
    if mesh is not None:
        print(f"trainingMesh: {dict(mesh.shape)}")
    model = trainer.train(
        args.data,
        args.vec,
        args.bg,
        num_pos=args.numPos,
        num_neg=args.numNeg,
        num_stages=args.numStages,
        acceptance_ratio_break=args.acceptanceRatioBreakValue,
        base_format_save=args.baseFormatSave,
    )
    return 0 if model is not None else 1


if __name__ == "__main__":
    sys.exit(main())
