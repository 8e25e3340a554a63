"""One of `chip_smoke.py`'s phases on the MovieLens-1M-shaped corpus
alone: phase J (the fifteen plain sequence models, J1 and J2), phase K
(the last seven: GRU4RecF, SASRecF, FDSA, RepeatNet, GRU4RecKG, KSR and
S3Rec, K1 and K2), phase L (the general models: the seven traditional
ones, L1, LightGCN and the six graph models, L2, and the `-m` entry, L3)
phase M (the rest of the general family: the eight pair and pointwise
models, M1, the seven user-batch models, M2, and the `-m` entry, M3, whose
runs share L3's child), phase N (the ten knowledge models on the corpus's
interactions with a seeded knowledge graph, N1, and CKE by the `-m`
entry, N2) or phase O (the mesh, in its own child process: the exchanges
at S = 1 on NCCL, O1, serving under the mesh with kernel 1, O2, 16 mesh
steps of xDeepFM and BPR against the plain trainer's, O3, the `-m`
entry's main with the multi-process flags, O4, and one model of each loss
class, 4 mesh steps and a test pass against the plain trainer's, O5),
phase P (the surfaces
after a run, on dataset/synth-ind: the hyper-parameter search by its `-m`
entry, P1, the case study on phase A's checkpoint, run first, P2, the cost
report of xDeepFM, P3, the significance test, P4, and the TensorBoard
writer, P5); or the gathers' backward
alone (`--phase gathers`: `csrc/embed_grad.cu`'s checks on both routes,
`chip_smoke.embed_grad_cases`, and its timings, `embed_grad_timing`, with
a batch call on both sort routes around SMALL_MAX, `embed_grad_routes`).

Runs on the card only. From the repo's root:

    python tools/chip_phase.py --phase J
    python tools/chip_phase.py --phase K
    python tools/chip_phase.py --phase L
    python tools/chip_phase.py --phase M
    python tools/chip_phase.py --phase N
    python tools/chip_phase.py --phase O
    python tools/chip_phase.py --phase P
    python tools/chip_phase.py --phase gathers

It builds the gathers' backward kernel (`csrc/embed_grad.cu`, also the
graph models' segment sum), writes phase I's corpus
(`chip_smoke.ml1m_inter_file`), for phase J loads it (`create_dataset`,
`data_preparation`), for phases L and M loads it as a general dataset
(`l_corpus`), for phase N writes its knowledge graph beside them and
loads both (`n_corpus`), runs the phase's parts with their checks (phase
K writes and loads its own item and entity files beside the
interactions; every `-m` run goes to the script's one shared CLI child,
stopped at the end), and
prints each part's launches, the kernels its graphed passes replayed, the
phase's times line and the card's name and power limit. About 2-3
minutes a phase on one H100.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PHASES = {"J": (("J1", "j1_sequential"), ("J2", "j2_cli")),
          "K": (("K1", "k1_sequential"), ("K2", "k2_cli")),
          "L": (("L2", "l2_graph"), ("L3", "l3_cli"), ("L1", "l1_traditional")),
          # M3's runs share L3's child
          "M": (("M1", "m1_pairs"), ("M2", "m2_users"), ("L3", "l3_cli"), ("M3", "m3_cli")),
          "N": (("N1", "n1_knowledge"), ("N2", "n2_cli")),
          "O": (),  # chip_smoke.phase_o runs the parts in its child
          # P2 reads phase A's checkpoint: phase A runs first
          "P": (("A", "cli_retrieval"), ("P1", "p1_hyper"), ("P2", "p2_case_study"),
                ("P3", "p3_flops"), ("P4", "p4_significance"), ("P5", "p5_tensorboard")),
          "gathers": ()}


def gathers() -> None:
    """The gathers' backward's checks and timings."""
    t0 = time.perf_counter()
    times = cs.embed_grad_timing(cs.embed_grad_cases())
    cs.log(f"phase gathers: checks and timings {time.perf_counter() - t0:.1f} s: "
           + json.dumps({"kernel": times, "cases": cs.EMBED_GRAD_TIMES}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=sorted(PHASES), default="J")
    args = parser.parse_args(argv)
    phase = args.phase
    if not cs.torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card: {smi}")
    os.environ["OOVREC_DISABLE_TENSORBOARD"] = "1"  # as chip_smoke.main; P5 lifts it
    t0 = time.perf_counter()
    if phase == "O":  # kernels 1, 4 / 5 and the gathers' backward; about two minutes
        cs.cuda_build.build_kernels(["topk_score", "cin_fused", "cin_fused_bwd", "embed_grad"])
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()  # O5's files: phases I's, K's and N's
        cs.ml1m_inter_file()
        cs.ml1m_side_files()
        cs.n_kg_files()
        cs.log(f"O5's files {time.perf_counter() - t0:.1f} s")
        cs.log(f"phase O launches {cs.phase_o()}")
        cs.log(smi)
        return 0
    cs.cuda_build.build_kernels(["topk_score", "cin_fused", "cin_fused_bwd", "embed_grad"]
                                if phase == "P" else ["embed_grad"])
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    for line in cs.cuda_build.LIBRARIES.build_log.get("embed_grad", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Function" in line:
            cs.log(f"  embed_grad: {line.strip()}")
    if phase == "gathers":
        gathers()
        cs.log(smi)
        return 0
    t0 = time.perf_counter()
    if phase != "P":
        cs.ml1m_inter_file()
    if phase == "J":
        base = cs.seq_cfg("GRU4Rec")
        ds = cs.create_dataset(base)
        cs.I_CORPUS.update(ds=ds, loaders=cs.data_preparation(base, ds))
    if phase in ("L", "M"):
        cs.l_corpus(ahead=phase == "L")
    if phase == "N":
        cs.n_corpus()
    cs.log(f"corpus {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for part, name in PHASES[phase]:
        cs.reset_kernel_counts()
        cs.sync()
        t1 = time.perf_counter()
        out = getattr(cs, name)()
        cs.sync()
        seen = {**cs.kernel_counts(), **(out if isinstance(out, dict) else {})}
        cs.log(f"phase {part}: {time.perf_counter() - t1:.1f} s, kernel launches {seen}")
    cs.stop_cli_server()
    cs.log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    cs.log(f"phase {phase} kernels replayed, from the traces: " + json.dumps(cs.F_TRACE))
    cs.log(f"phase {phase} times: " + json.dumps(getattr(cs, f"{phase}_TIMES")))
    if phase == "L":
        cs.log("the edge segment sum (ops/embed_grad.py:segment_sum): "
               + json.dumps(cs.L_TIMES["segment sum"]))
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
