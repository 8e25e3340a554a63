"""Every dense training step can be captured as a CUDA graph.

On the card `train/cuda_graph.py` captures `Trainer._apply_step` for every
dense step. A capture refuses an op that reads the device from the host
(`.item()`, `bool(t)`, `torch.equal`) or whose output shape depends on the
data (`nonzero`, boolean indexing, `unique`, `masked_select`), and a random
draw from a generator the graph does not know. The CPU cannot capture, so
here each model and embedder trains one CLI epoch on toy-ind on the CPU
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

from tests.test_torch_cli import COMMON, MAPPER, RANKING, RETRIEVAL, SKILL_RANKING

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
}


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
    argv = TRACKS[track] if track == "widedeep-lsh" else COMMON + TRACKS[track]
    argv = [a for a in argv if not a.startswith(("--epochs", "--checkpoint_dir"))]
    port_main(argv + ["--epochs=1", "--device=cpu", f"--hash_key_dir={tmp_path / 'keys'}",
                      f"--checkpoint_dir={tmp_path / 'saved'}", "--inductive_eval=False"])
    assert steps, "no dense step ran"
    assert not seen, sorted(set(seen))


@pytest.mark.parametrize("embedder", ["random", "lsh"])
@pytest.mark.parametrize("case", ["WideDeep", "DCNV2-stacked", "DCNV2-parallel",
                                  "DCNV2-mixed", "xDeepFM"])
def test_sequence_fields_read_nothing_back(case, embedder):
    """The context models over token_seq / float_seq fields (which toy-ind
    lacks), on a batch with padded rows: the loss and its gradient."""
    from oovrec_tpu_torch.inductive import InductiveSpec
    from oovrec_tpu_torch.models import FieldSpec, get_model_class
    from tests import test_torch_context_models as ctx

    name, kw = ctx.MODELS[case] if case in ctx.MODELS else ("xDeepFM", dict(
        mlp_hidden_size=(16, 8), cin_layer_size=(6, 6), fused_cin=False))
    spec = InductiveSpec(**ctx.SPECS[embedder])
    model = get_model_class(name)(FieldSpec(**ctx.FIELDS), spec=spec, device="cpu",
                                  embedder_state=ctx._estate(embedder) or None,
                                  **ctx.COMMON, **kw)
    batch = ctx._torch_batch(ctx._batch(embedder, seed=5, n_pad=ctx.N_PAD))
    params = [p for _, p in model.named_parameters()]
    with _Recorder(torch.Generator()) as rec:
        loss = model.calculate_loss(batch)
        torch.autograd.grad(loss, params, allow_unused=True)
    assert not rec.seen, sorted(set(rec.seen))
