"""Every dense training step can be captured as a CUDA graph.

On the card `train/cuda_graph.py` captures `Trainer._apply_step` for every
dense step. A capture refuses an op that reads the device from the host
(`.item()`, `bool(t)`, `torch.equal`) or whose output shape depends on the
data (`nonzero`, boolean indexing, `unique`, `masked_select`), and a random
draw from a generator the graph does not know. The CPU cannot capture, so
here each model, embedder and learner trains one CLI epoch on toy-ind on the CPU
while a dispatch mode records, inside `_apply_step` only, every such op
and every draw from a generator other than the trainer's dropout
generator (the one `StepGraphs` registers with its graphs). None may
appear.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oovrec_tpu_torch.cli.run import main as port_main
from oovrec_tpu_torch.train.trainer import Trainer

from tests.test_torch_cli import (
    ASSETS,
    COMMON,
    LOAD_COL,
    MAPPER,
    RANKING,
    RETRIEVAL,
    SKILL_RANKING,
)

# ops whose result the host must read, or whose shape the data decides
HOST_READS = {"_local_scalar_dense", "nonzero", "nonzero_numpy", "argwhere", "masked_select",
              "_unique", "_unique2", "unique_dim", "unique_consecutive", "equal",
              "is_nonzero", "allclose"}
INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}
DHE = ["--dhe_num_hashes=8", "--dhe_layer_size=16"]
TRACKS = {
    "bpr-random": RETRIEVAL + MAPPER,
    **{f"bpr-{e}": RETRIEVAL + [f"--inductive_embedder={e}"] + (DHE if "dhe" in e else [])
       for e in ("lsh", "slsh", "dnn", "knn", "dhe", "fdhe", "zero", "mean")},
    "directau": ["--model=DirectAU", *MAPPER],
    "xdeepfm": RANKING + MAPPER + ["--fused_cin=True"],
    "xdeepfm-lsh": RANKING + ["--inductive_embedder=lsh", "--dropout_prob=0.2"],
    "widedeep-lsh": SKILL_RANKING[:-3] + SKILL_RANKING[-2:] + ["--inductive_embedder=lsh"],
    "dcnv2-stacked": ["--model=DCNV2", *RANKING[1:], *MAPPER, "--cross_layer_num=2"],
    "dcnv2-parallel": ["--model=DCNV2", *RANKING[1:], *MAPPER, "--cross_layer_num=2",
                       "--structure=parallel"],
    "dcnv2-mixed": ["--model=DCNV2", *RANKING[1:], *MAPPER, "--cross_layer_num=2",
                    "--mixed=True"],
    # adagrad, rmsprop, bf16 first moments; LR, FM, DeepFM and FFM
    "bpr-adagrad": RETRIEVAL + MAPPER + ["--learner=adagrad"],
    "bpr-rmsprop": RETRIEVAL + MAPPER + ["--learner=rmsprop"],
    "bpr-adam-bf16": RETRIEVAL + MAPPER + ["--optimizer_mu_dtype=bfloat16"],
    "bpr-torch-adam-bf16": RETRIEVAL + MAPPER + ["--optimizer_mu_dtype=bfloat16",
                                                 "--optimizer_skip_zero_grads=True"],
    "xdeepfm-adagrad": RANKING + MAPPER + ["--fused_cin=True", "--learner=adagrad"],
    **{name.lower(): [f"--model={name}", *RANKING[1:], *MAPPER]
       for name in ("LR", "FM", "DeepFM", "FFM")},
    "deepfm-lsh": ["--model=DeepFM", *RANKING[1:4], "--inductive_embedder=lsh",
                   "--dropout_prob=0.2"],
    # the rest of the zoo; AutoInt's MLP and EulerNet's two Dropout modules
    # draw masks at their YAML rates, AFM's and NFM's Dropout at 0.3
    **{name.lower(): [f"--model={name}", *RANKING[1:], *MAPPER]
       for name in ("DCN", "AutoInt", "FNN", "PNN", "AFM", "FwFM", "DSSM", "FiGNN", "EulerNet",
                    "NFM")},
    "pnn-outer": ["--model=PNN", *RANKING[1:], *MAPPER, "--use_outer=True"],
    "afm-dropout": ["--model=AFM", *RANKING[1:4], *MAPPER, "--dropout_prob=0.3"],
    "nfm-dropout-lsh": ["--model=NFM", *RANKING[1:4], "--inductive_embedder=lsh",
                        "--dropout_prob=0.3"],
    **{f"kd_dagfm-{phase}": ["--model=KD_DAGFM", *RANKING[1:], *MAPPER, f"--phase={phase}"]
       for phase in ("teacher_training", "distillation", "finetuning")},
    "kd_dagfm-outer": ["--model=KD_DAGFM", *RANKING[1:], *MAPPER, "--phase=distillation",
                       "--interaction_type=outer"],
}
# the sequential models on toy-ind's timestamps, at their YAML dropout
# rates (the attention's weight dropout included), without the OOV regime
SEQUENTIAL = ["--dataset=toy-ind", f"--data_path={ASSETS}", "--train_batch_size=16",
              "--embedding_size=8", "--MAX_ITEM_LIST_LENGTH=4", LOAD_COL,
              "--log_tensorboard=False"]
TRACKS.update({f"seq-{name.lower()}": [f"--model={name}", *SEQUENTIAL]
               for name in ("GRU4Rec", "SASRec", "NARM", "STAMP", "FPMC", "BERT4Rec",
                            "Caser", "NextItNet", "DIN", "DIEN", "HGN", "FOSSIL", "TransRec",
                            "SHAN", "NPE", "HRM", "CORE", "SRGNN", "GCSAN", "LightSANs",
                            "SINE")})
# DIEN's negatives drawn on the device (its default) and presampled; SHAN
# through the inverse_itemseq transform; the other pool and encoder types
TRACKS.update({
    "seq-dien-presampled": ["--model=DIEN", *SEQUENTIAL, "--dien_neg_sampling=presampled"],
    "seq-shan-inverse": ["--model=SHAN", *SEQUENTIAL, "--transform=inverse_itemseq"],
    "seq-hgn-max": ["--model=HGN", *SEQUENTIAL, "--pool_type=max"],
    "seq-core-trm": ["--model=CORE", *SEQUENTIAL, "--dnn_type=trm"],
})
# the last seven: the feature-fused models and S3Rec over toy-ind's item
# `category` (the packed table a buffer), S3Rec's pretraining drawing its
# masks, negatives and segment starts and its finetuning, RepeatNet's
# scatters, the KG models on the seeded entity table (toy-ind ships no
# preload), frozen and trainable
FEATURES = "--selected_features=['category']"
TRACKS.update({
    **{f"seq-{name.lower()}": [f"--model={name}", *SEQUENTIAL, FEATURES]
       for name in ("GRU4RecF", "SASRecF", "FDSA", "S3Rec")},
    "seq-s3rec-finetune": ["--model=S3Rec", *SEQUENTIAL, FEATURES, "--train_stage=finetune"],
    "seq-repeatnet": ["--model=RepeatNet", *SEQUENTIAL],
    "seq-repeatnet-joint": ["--model=RepeatNet", *SEQUENTIAL, "--joint_train=True"],
    "seq-gru4reckg": ["--model=GRU4RecKG", *SEQUENTIAL],
    "seq-ksr": ["--model=KSR", *SEQUENTIAL],
    "seq-ksr-trainable": ["--model=KSR", *SEQUENTIAL, "--freeze_kg=False"],
})

# the graph models on toy-ind's training edges with the OOV
# regime, NGCF's message dropout, GCMC's dropout and SGL's edge masks at
# their YAML rates
TRACKS.update({f"general-{name.lower()}": [f"--model={name}", *MAPPER]
               for name in ("LightGCN", "NGCF", "SGL", "SpectralCF", "GCMC", "DGCF", "NCL")})
# the pair and pointwise embedding models and the user-batch models at
# their YAML rates (NeuMF's and NNCF's MLP dropout, the autoencoders' keep
# masks and ε, ENMF's dropout, RaCT's held-out mask), RaCT in each stage
TRACKS.update({f"general-{name.lower()}": [f"--model={name}", *MAPPER]
               for name in ("NeuMF", "DMF", "SimpleX", "FISM", "NAIS", "LINE", "ConvNCF",
                            "NNCF", "MultiVAE", "MultiDAE", "CDAE", "RecVAE", "MacridVAE",
                            "ENMF")})
TRACKS.update({f"general-ract-{stage}": ["--model=RaCT", *MAPPER, f"--train_stage={stage}"]
               for stage in ("actor_pretrain", "critic_pretrain", "finetune")})
# the knowledge models on toy-kg (its triples and negative tails in every
# batch), at their YAML rates (KGAT's and KGIN's message dropout), with
# CFKG's TransE loss, MCCLK's kNN graph at k 3 and KGAT's two layers
KNOWLEDGE = ["--dataset=toy-kg", f"--data_path={ASSETS}", "--train_batch_size=16",
             "--embedding_size=8", "--log_tensorboard=False",
             "--load_col={'inter': ['user_id','item_id','rating','timestamp']}"]
TRACKS.update({f"kg-{name.lower()}": [f"--model={name}", *KNOWLEDGE]
               for name in ("CKE", "CFKG", "KGCN", "KGNNLS", "MKR", "KTUP", "RippleNet",
                            "KGIN")})
TRACKS.update({
    "kg-cfkg-transe": ["--model=CFKG", *KNOWLEDGE, "--loss_function=transe"],
    "kg-kgat": ["--model=KGAT", *KNOWLEDGE, "--layers=[8,8]", "--kg_embedding_size=8"],
    "kg-mcclk": ["--model=MCCLK", *KNOWLEDGE, "--knn_k=3"],
})


class _Recorder(TorchDispatchMode):
    def __init__(self, allowed_generator):
        super().__init__()
        self.allowed = allowed_generator
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in HOST_READS:
            self.seen.append(name)
        elif name in INDEXING:
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
                   for t in indices or ()):
                self.seen.append(f"{name} by a mask")
        elif name == "repeat_interleave" and kwargs.get("output_size") is None and (
                isinstance(args[0], torch.Tensor) and args[0].dtype != torch.float32
                and len(args) == 1):
            self.seen.append(name)
        gen = kwargs.get("generator")
        # the dispatcher hands over a new wrapper of the same generator
        if gen is not None and (gen.device, gen.initial_seed()) != (
                self.allowed.device, self.allowed.initial_seed()):
            self.seen.append(f"{name} from another generator")
        return func(*args, **kwargs)


@pytest.mark.parametrize("track", sorted(TRACKS))
def test_dense_step_reads_nothing_back(track, tmp_path, monkeypatch):
    seen, steps = [], []
    apply_step = Trainer._apply_step

    def recorded(self, batch, trainable=None, count=None):
        with _Recorder(self.dropout_generator) as rec:
            out = apply_step(self, batch, trainable, count)
        seen.extend(rec.seen)
        steps.append(1)
        return out

    monkeypatch.setattr(Trainer, "_apply_step", recorded)
    monkeypatch.chdir(tmp_path)
    verbatim = track == "widedeep-lsh" or track.startswith(("seq-", "kg-"))
    argv = TRACKS[track] if verbatim else COMMON + TRACKS[track]
    argv = [a for a in argv if not a.startswith(("--epochs", "--checkpoint_dir"))]
    port_main(argv + ["--epochs=1", "--device=cpu", f"--hash_key_dir={tmp_path / 'keys'}",
                      f"--checkpoint_dir={tmp_path / 'saved'}", "--inductive_eval=False"])
    assert steps, "no dense step ran"
    assert not seen, sorted(set(seen))


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("case", ["WideDeep", "DCNV2-stacked", "DCNV2-parallel",
                                  "DCNV2-mixed", "xDeepFM", "LR", "FM", "DeepFM", "FFM",
                                  "DCN", "AutoInt", "FNN", "PNN", "PNN-outer", "AFM", "FwFM",
                                  "DSSM", "FiGNN", "EulerNet", "NFM", "KD_DAGFM",
                                  "KD_DAGFM-outer"])
def test_sequence_fields_read_nothing_back(case, embedder):
    """The context models over token_seq / float_seq fields (which toy-ind
    lacks), on a batch with padded rows: the loss and its gradient."""
    from oovrec_tpu_torch.inductive import InductiveSpec
    from oovrec_tpu_torch.models import FieldSpec, get_model_class
    from tests import test_torch_context_models as ctx

    from tests import test_torch_context_zoo as zoo

    common = ctx.COMMON
    if case in zoo.MODELS:
        name, kw, common = zoo._name(case), zoo.MODELS[case], dict(embedding_size=8)
    else:
        name, kw = ctx.MODELS[case] if case in ctx.MODELS else ("xDeepFM", dict(
            mlp_hidden_size=(16, 8), cin_layer_size=(6, 6), fused_cin=False))
    spec = InductiveSpec(**ctx.SPECS[embedder])
    model = get_model_class(name)(FieldSpec(**ctx.FIELDS), spec=spec, device="cpu",
                                  embedder_state=ctx._estate(embedder) or None,
                                  **common, **kw)
    batch = ctx._torch_batch(ctx._batch(embedder, seed=5, n_pad=ctx.N_PAD))
    params = [p for _, p in model.named_parameters()]
    with _Recorder(torch.Generator()) as rec:
        loss = model.calculate_loss(batch)
        torch.autograd.grad(loss, params, allow_unused=True)
    assert not rec.seen, sorted(set(rec.seen))
