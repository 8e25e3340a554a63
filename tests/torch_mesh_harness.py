"""Every registered model on the port's mesh: the worker and its cases.

`tests/test_torch_mesh_{context,sequential,general,knowledge}.py` spawn
this file once a family on 2 gloo ranks (`python
tests/torch_mesh_harness.py <family> <rank> <world> <dir>`; the pattern of
`tests/test_torch_multiprocess.py`, so neither JAX nor `tests/conftest.py`
runs in the workers). For each case of the family a rank

  1. builds the dataset, the loaders and the model of the case's command
     line on toy-ind / toy-kg (no mesh yet, so the loaders are not split),
     and takes the first training batch cut to an odd row count (each
     array's leading axis one row shorter where it is even), so the data
     axis pads it;
  2. runs the port's single-process step (`Trainer._apply_step`, no mesh)
     on the batch padded as `pad_batch` pads it;
  3. runs the mesh step ({data: world}, `use_mesh`) from the same initial
     state on the rank's rows of the unpadded batch;
  4. runs two more mesh steps with the trainer's own draws and hashes every
     parameter and buffer.

The steps use `learner: sgd` at a learning rate of 1, so the parameters
after a step are the initial ones less the gradient, and equal parameters
are equal gradients. Steps 2 and 3 see the same random draws: a replay
(`_Draws`) records each draw from the trainer's dropout generator in the
single-process step and hands the mesh step's k-th draw the k-th recorded
one, whole where the shapes agree (a draw every rank repeats) and the
rank's block of rows where the recorded draw has n_data times the rows (a
per-row draw).

Each case → the two losses, for each parameter and buffer the largest
difference and the largest magnitude, and the hash after step 4. A case
that raises returns its traceback.
"""

import hashlib
import os
import pickle
import subprocess
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tests", "assets")
TIMEOUT = 400
# the loss to 1e-5 relative; each parameter's and buffer's change to 1e-5
# of its largest magnitude plus 1e-7 (a gradient that is 0 but for the
# rounding, as a bias's before a BatchNorm): the ranks' partial sums add in
# another order
RTOL, ATOL = 1e-5, 1e-7

LOAD_COL = ("--load_col={'inter': ['user_id','item_id','rating','timestamp','is_new'], "
            "'user': ['user_id','age','gender'], 'item': ['item_id','price','category']}")
COMMON = ["--dataset=toy-ind", f"--data_path={ASSETS}", "--train_batch_size=16",
          "--embedding_size=8", "--add_oov_buckets=True", "--n_user_oov_buckets=8",
          "--n_item_oov_buckets=8", LOAD_COL, "--inductive_mapper=random"]
RANKING = ["--model_eval_type=ranking", "--numerical_features=['age','price']",
           "--threshold={'rating': 4}", "--mlp_hidden_size=[16,8]", "--cin_layer_size=[8,8]"]
SEQUENTIAL = ["--dataset=toy-ind", f"--data_path={ASSETS}", "--train_batch_size=16",
              "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4", LOAD_COL]
FEATURES = "--selected_features=['category']"
KNOWLEDGE = ["--dataset=toy-kg", f"--data_path={ASSETS}", "--train_batch_size=16",
             "--embedding_size=8",
             "--load_col={'inter': ['user_id','item_id','rating','timestamp']}"]

CONTEXT_MODELS = ["LR", "FM", "DeepFM", "FFM", "DCN", "AutoInt", "FNN", "PNN", "AFM", "FwFM",
                  "DSSM", "FiGNN", "EulerNet", "NFM", "KD_DAGFM", "WideDeep", "DCNV2",
                  "xDeepFM"]
SEQUENTIAL_MODELS = ["GRU4Rec", "SASRec", "NARM", "STAMP", "FPMC", "BERT4Rec", "Caser",
                     "NextItNet", "DIN", "DIEN", "HGN", "FOSSIL", "TransRec", "SHAN", "NPE",
                     "HRM", "CORE", "SRGNN", "GCSAN", "LightSANs", "SINE", "GRU4RecF",
                     "SASRecF", "FDSA", "S3Rec", "RepeatNet", "GRU4RecKG", "KSR"]
GENERAL_MODELS = ["BPR", "DirectAU", "Pop", "Random", "ItemKNN", "EASE", "SLIMElastic",
                  "ADMMSLIM", "NCEPLRec", "LightGCN", "NGCF", "SGL", "SpectralCF", "GCMC",
                  "DGCF", "NCL", "NeuMF", "DMF", "SimpleX", "FISM", "NAIS", "LINE",
                  "ConvNCF", "NNCF", "MultiVAE", "MultiDAE", "CDAE", "RecVAE", "MacridVAE",
                  "ENMF", "RaCT"]
KNOWLEDGE_MODELS = ["CKE", "CFKG", "KGAT", "KGCN", "KGNNLS", "MKR", "KTUP", "RippleNet",
                    "KGIN", "MCCLK"]


def _cases():
    """{family: {case: argv}}: one case a registered model, at its YAML
    widths and rates but for the command line's, plus the variants whose
    loss takes another path."""
    out = {
        "context": {m: [f"--model={m}", *COMMON, *RANKING] for m in CONTEXT_MODELS},
        "sequential": {m: [f"--model={m}", *SEQUENTIAL]
                       + ([FEATURES] if m in ("GRU4RecF", "SASRecF", "FDSA", "S3Rec") else [])
                       for m in SEQUENTIAL_MODELS},
        "general": {m: [f"--model={m}", *COMMON] for m in GENERAL_MODELS},
        "knowledge": {m: [f"--model={m}", *KNOWLEDGE] for m in KNOWLEDGE_MODELS},
    }
    out["context"].update({
        f"KD_DAGFM-{p}": ["--model=KD_DAGFM", *COMMON, *RANKING, f"--phase={p}"]
        for p in ("distillation", "finetuning")})
    out["sequential"].update({
        "S3Rec-finetune": ["--model=S3Rec", *SEQUENTIAL, FEATURES, "--train_stage=finetune"],
        "DIEN-presampled": ["--model=DIEN", *SEQUENTIAL, "--dien_neg_sampling=presampled"],
        "RepeatNet-joint": ["--model=RepeatNet", *SEQUENTIAL, "--joint_train=True"],
    })
    out["general"].update({
        f"RaCT-{s}": ["--model=RaCT", *COMMON, f"--train_stage={s}"]
        for s in ("actor_pretrain", "critic_pretrain")})
    out["knowledge"].update({
        "CFKG-transe": ["--model=CFKG", *KNOWLEDGE, "--loss_function=transe"],
    })
    for argvs in out.values():
        for name, argv in argvs.items():
            if name.startswith("KGAT"):
                argv += ["--layers=[8,8]", "--kg_embedding_size=8"]
            if name.startswith("MCCLK"):
                argv.append("--knn_k=3")
    return out


CASES = _cases()


# ---------------------------------------------------------------- workers


class _Draws(TorchDispatchMode):
    """A dispatch mode over the draws from `generator`: it records each one,
    or with `recorded` overwrites the k-th draw with the k-th recorded one,
    whole or as this rank's block of rows (module docstring)."""

    def __init__(self, generator, recorded=None, rank=0, world=1):
        super().__init__()
        self.key = (generator.device, generator.initial_seed())
        self.recorded = [] if recorded is None else recorded
        self.replay = recorded is not None
        self.rank, self.world, self.k = rank, world, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        gen = kwargs.get("generator")
        # the dispatcher hands over a new wrapper of the same generator
        if gen is None or (gen.device, gen.initial_seed()) != self.key:
            return out
        if not self.replay:
            self.recorded.append(out.detach().clone())
            return out
        rec = self.recorded[self.k]
        self.k += 1
        if tuple(out.shape) == tuple(rec.shape):
            out.copy_(rec)
        elif (out.dim() and out.shape[0] * self.world == rec.shape[0]
              and tuple(out.shape[1:]) == tuple(rec.shape[1:])):
            b = out.shape[0]
            out.copy_(rec[self.rank * b:(self.rank + 1) * b])
        else:
            raise AssertionError(f"draw {self.k} of {func}: shape {tuple(out.shape)} "
                                 f"against the recorded {tuple(rec.shape)}")
        return out


def _odd(batch):
    """Each array's leading axis cut to an odd length."""
    import numpy as np

    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v[: len(v) - 1] if v.ndim >= 1 and len(v) % 2 == 0 else v
    return out


def _setup(argv, over):
    """(config, dataset, model, the odd first training batch) of `argv`,
    built with no mesh active."""
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.cli.run import apply_paper_protocol
    from oovrec_tpu_torch.config import Config, parse_cli_args
    from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
    from oovrec_tpu_torch.parallel import mesh as pmesh

    pmesh._ACTIVE = None
    args = apply_paper_protocol(parse_cli_args(argv))
    args.update(over)
    cfg = Config(args)
    ds = create_dataset(cfg)
    train, _valid, _test = data_preparation(cfg, ds)
    batch = _odd(next(iter(train)))
    return args, ds, build_model_and_state(cfg, ds), batch


def _state(model):
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _one_case(argv, rank, world, tmp):
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.transfer import to_device_batch
    from oovrec_tpu_torch.parallel.mesh import pad_batch
    from oovrec_tpu_torch.train.trainer import Trainer

    over = {"device": "cpu", "learner": "sgd", "learning_rate": 1.0, "log_tensorboard": False,
            "checkpoint_dir": os.path.join(tmp, f"ckpt_{rank}"), "host_scan_steps": 1,
            "device_epoch": False, "worker": 0}
    args, ds, model, batch = _setup(argv, over)
    init = _state(model)

    # the single-process step on the padded global batch
    ref = Trainer(Config(args), model)
    with _Draws(ref.dropout_generator) as rec:
        loss_ref = ref._apply_step(to_device_batch(pad_batch(batch, world), "cpu"))
    after_ref = _state(model)

    # the mesh step from the same state on this rank's rows
    mesh_args = dict(args, use_mesh=True, mesh={"data": world})
    mesh_model = build_model_and_state(Config(mesh_args), ds)
    mesh_model.load_state_dict(init)
    tr = Trainer(Config(mesh_args), mesh_model)
    with _Draws(tr.dropout_generator, rec.recorded, rank, world):
        loss_mesh = tr._apply_step(tr._to_device(batch))
    after_mesh = _state(mesh_model)
    diffs = {}
    for k, v in after_ref.items():
        if v.is_floating_point():
            d = float((after_mesh[k].double() - v.double()).abs().max()) if v.numel() else 0.0
            scale = float((v.double() - init[k].double()).abs().max()) if v.numel() else 0.0
            diffs[k] = (d, scale)
        else:
            diffs[k] = (0.0 if torch.equal(after_mesh[k], v) else float("inf"), 0.0)

    # two more steps with the trainer's own draws; every rank's state hashed
    for _ in range(2):
        tr._apply_step(tr._to_device(batch))
    h = hashlib.sha256()
    for k, v in sorted(_state(mesh_model).items()):
        h.update(k.encode())
        h.update(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
                 if v.numel() else b"")
    return {"loss_ref": float(loss_ref), "loss_mesh": float(loss_mesh), "diffs": diffs,
            "hash": h.hexdigest()}


def join_group(rank, world, tmp):
    """This worker process as rank `rank` of a gloo group of `world`, met
    at a `file://` rendezvous in `tmp`."""
    sys.path.insert(0, REPO)
    from oovrec_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank,
                           device="cpu", timeout_s=TIMEOUT - 20)


def leave_group(out, rank, tmp):
    """Write this rank's result to `tmp/out_<rank>.pkl` and leave."""
    import torch.distributed as dist

    with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(script, world, tmp, *args, payload=None):
    """Run `python <script> <rank> <world> <dir> *args` as `world`
    processes in a new directory under `tmp` (with `payload` pickled there
    as `payload.pkl`), killed after TIMEOUT s. → each rank's result."""
    tmp = os.path.join(str(tmp), f"ranks-{world}-{time.monotonic_ns()}")
    os.makedirs(tmp)
    if payload is not None:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), str(r), str(world), tmp,
                               *args], cwd=tmp, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"{script} on {world} ranks did not finish in {TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {script} failed:\n{log[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _worker_main(argv):
    rank, world, tmp, family = int(argv[0]), int(argv[1]), argv[2], argv[3]
    join_group(rank, world, tmp)
    os.chdir(tmp)
    out = {}
    for name, case_argv in CASES[family].items():
        t0 = time.time()
        try:
            out[name] = _one_case(case_argv, rank, world, tmp)
        except Exception:  # the case fails in its own test; the others run on
            out[name] = {"error": traceback.format_exc()}
        out[name]["seconds"] = time.time() - t0
    leave_group(out, rank, tmp)


def spawn(family, tmp, world=2):
    """Run `family`'s cases on `world` gloo ranks; → each rank's results."""
    return run_ranks(__file__, world, tmp, family)


def check_case(results, name, exact=False):
    """The assertions of one case over every rank's result: the mesh step
    against the single-process step to the stated tolerance (`exact`: bit
    for bit), and the ranks' states equal after the steps."""
    for r, res in enumerate(results):
        assert "error" not in res[name], f"rank {r}:\n{res[name]['error']}"
    rtol, atol = (0.0, 0.0) if exact else (RTOL, ATOL)
    for res in results:
        c = res[name]
        assert abs(c["loss_mesh"] - c["loss_ref"]) <= rtol * abs(c["loss_ref"]) + (
            0.0 if exact else 1e-12), (c["loss_mesh"], c["loss_ref"])
        bad = {k: (d, s) for k, (d, s) in c["diffs"].items() if d > rtol * s + atol}
        assert not bad, bad
    hashes = {res[name]["hash"] for res in results}
    assert len(hashes) == 1, "the ranks' parameters and buffers differ after the steps"


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
