"""The port's CLAP_SED and DASM_HTSAT, their steps and the query-bank tools,
held against the JAX package on the CPU.

The forwards (CLAP_SED on its own bank with a pad mask and on an external
query; DASM_HTSAT with learnable queries, two projector modalities with
``tgt_mask`` and the 'logit' head, one bank through the audio projector with
no decoder and no head, one projector, the CNN branch with ``encoder_win``)
with the seeded port state dicts carried into JAX by ``convert_clap_sed`` /
``convert_dasm`` and back by ``load_jax_params``; one ``ClapStep`` against
``make_clap_step`` and one ``DASMStep`` on DASM_HTSAT against
``make_dasm_step``, each fed the draws JAX makes, with bn0's running
statistics and CLAP_SED's decayed ``text_query``; the query tools and the
``build_text`` CLI against JAX's; the codec at CLAP's 31.25 hop; and what
the JAX package refuses (CLAP_SED given ``query_type``, a learnable
DASM_HTSAT given a bank, its DASM step's augmentations on the 4-d mel).
Everything is float32, at ``tests/test_torch_port_htsat.py``'s tiny HTSAT.

The JAX programs compile once each at OPT0 in three worker processes started
with the module (``tests/torch_port_htsat_family_jax.py``, which imports no
torch), while the port-only tests, which come first, run.
"""

import concurrent.futures
import json
import multiprocessing
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.core.codec import LabelCodec as JaxCodec
from transformer4sed_tpu.frontend import augment as jax_augment
from transformer4sed_tpu.recipes import queries as jax_queries
from transformer4sed_tpu.train import optim as jax_optim
from transformer4sed_tpu_torch.core.codec import LabelCodec
from transformer4sed_tpu_torch.frontend import augment
from transformer4sed_tpu_torch.models import htsat_heads
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.parallel import multihost
from transformer4sed_tpu_torch.recipes import audioset_strong, clap, cli, dasm_recipe, queries
from transformer4sed_tpu_torch.recipes import serve
from transformer4sed_tpu_torch.train import optim
from transformer4sed_tpu_torch.utils.weights import (
    init_weights_,
    jax_params_to_state_dict,
    jax_style_path,
    load_jax_params,
)
from transformer4sed_tpu_torch.utils.yamlio import safe_dump
from tests import torch_port_htsat_family_jax as fam
from tests.test_torch_port_train import _IdentityFrontend
from tests.torch_port_htsat_family_jax import (
    AT_KEEP,
    B,
    CLAP,
    CLAP_COMMON,
    DASM,
    DASM_STEP,
    LOSS,
    MEL_F,
    MEL_T,
    OPT,
    VARIANTS,
    banks,
    constructor,
    forward_kwargs,
    jax_variables,
    mel,
    step_batch,
)

# model outputs after a dozen f32 matmuls summed in another order; the
# sigmoid of logits / 0.1 magnifies them 10x (tests/test_torch_port_dasm.py)
ATOL_FORWARD = 2e-5
# trajectory bound of tests/test_torch_port_train.py (test_torch_parity.py:2392-2412)
ATOL_LOSS = RTOL_LOSS = 2e-5
# params after an AdamW step at lr 1e-4 .. 4e-4 from gradients that agree to f32
# rounding (tests/test_torch_port_supervised.py, tests/test_torch_port_dasm.py)
ATOL_PARAMS = 5e-5
# elementwise f32 functions and small sums: a few ulps
ATOL_ELEM = 1e-6
# the gradients sum T products of O(1) terms: a few ulps of that sum
# (tests/test_torch_port_parallel.py)
ATOL_GRAD = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _port(variant, seed=0):
    net, kw = constructor(variant)
    return init_weights_(getattr(htsat_heads, net)(**kw, device="cpu"), seed=seed)


def _step_port():
    return init_weights_(htsat_heads.DASM_HTSAT(**DASM_STEP, device="cpu"), seed=0)


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The JAX side in four worker processes started with the module (their
    tracing would hold this process's GIL): the DASM_HTSAT step, DASM_HTSAT's
    forwards, CLAP_SED's forwards with the refusals, the CLAP step."""
    states = {v: _np_state(_port(v)) for v in VARIANTS}
    states["dasm_step"] = _np_state(_step_port())
    clap_states = {v: sd for v, sd in states.items() if v.startswith("clap")}
    pool = concurrent.futures.ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
        "spawn"))
    futures = {
        "dasm": pool.submit(fam.dasm_step, states["dasm_step"]),
        "dasm_forward": pool.submit(fam.forward_outputs, {
            v: states[v] for v in VARIANTS if v not in clap_states}),
        "clap_forward": pool.submit(fam.forward_outputs, clap_states),
        "refusals": pool.submit(fam.refusals, states["clap_own_bank_pad_mask"],
                                states["dasm_learnable_sigmoid_pad_mask"]),
        "clap": pool.submit(fam.clap_step, states["clap_own_bank_pad_mask"])}
    yield futures
    pool.shutdown(wait=True)


# -- the weight bridge, the options, the codec ----------------------------------------------


@pytest.mark.parametrize("variant", ["clap_own_bank_pad_mask",
                                     "dasm_two_modalities_logit_tgt_mask",
                                     "dasm_one_projector_text", "dasm_cnn_branch_windows"])
def test_weight_bridge_both_ways(variant):
    """A seeded port state dict through the JAX package's converter
    (``convert_clap_sed`` / ``convert_dasm``) and back through
    ``load_jax_params``, bn0's batch statistics included, is the same state
    dict; ``jax_params_to_state_dict`` names every JAX leaf as upstream."""
    net, _ = VARIANTS[variant]
    port = _port(variant)
    variables = jax_variables(net, _np_state(port))
    assert set(variables["batch_stats"]["backbone"]["bn0"]) == {"mean", "var"}
    back = load_jax_params(_port(variant, seed=1), variables)
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    names = port.state_dict().keys()
    assert set(jax_params_to_state_dict(variables, names=names)) <= set(names)
    if net == "CLAP_SED":
        assert jax_style_path("audio_projector.layers.1.weight") == (
            "audio_projector/layers_1/kernel")
        assert jax_style_path("text_query") == "text_query"
        assert jax_style_path("backbone.bn0.running_var", 1) == "backbone/bn0/var"


@pytest.mark.parametrize("kw,item", [(dict(decoder="gru"), "item 12"),
                                     (dict(decoder="conformer"), "item 12"),
                                     (dict(mlm_dict={"mask_rate": 0.75}), "item 14")])
def test_dasm_htsat_unported_options_raise_naming_their_queue_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        htsat_heads.DASM_HTSAT(**{**DASM, **kw}, device="cpu")


def test_codec_at_clap_hop_matches_jax():
    """clap.yaml's grid: 32 frames a 10-s clip at net_subsample 31.25, events
    encoded and decoded on the non-integer hop as JAX does."""
    kw = dict(labels=("a", "b", "c"), audio_len=10.0, frame_len=1024, frame_hop=320,
              net_pooling=31.25, sr=32000)
    ours, theirs = LabelCodec(**kw), JaxCodec(**kw)
    assert ours.n_frames == theirs.n_frames == 32
    events = [("a", 0.13, 2.71), ("b", 5.0, 9.99), ("c", 9.5, 10.0), ("a", 3.3, 3.31)]
    grid = ours.encode_strong(events)
    np.testing.assert_array_equal(grid, theirs.encode_strong(events))
    assert ours.decode_strong(grid) == theirs.decode_strong(grid)


# -- the query tools ------------------------------------------------------------------------


def test_query_tools_match_jax(tmp_path):
    """``extract_audio_queries`` (labels taken onto a coarser embedding grid,
    the cap of a class once its count passes the threshold, a class never
    seen), ``build_text_query_bank`` (the prompted and the bare label, the
    encoder plug point for the rest, L2 rows) and the table and label
    readers, against JAX's on the same inputs."""
    rng = np.random.RandomState(5)
    batches = [{"wav": rng.randn(2, 7, 6).astype(np.float32),
                "label": (rng.rand(2, 4, 10) > 0.6).astype(np.float32)} for _ in range(3)]
    batches[0]["label"][:, 3] = 0.0
    for b in batches:
        b["label"][:, 2] = 0.0  # class 2 is never seen
    for cap in ((), (0, 1)):
        got = queries.extract_audio_queries(lambda w: w, batches, 4, 6, cap_classes=cap,
                                            cap_threshold=3)
        want = jax_queries.extract_audio_queries(lambda w: w, batches, 4, 6, cap_classes=cap,
                                                 cap_threshold=3)
        np.testing.assert_allclose(got, want, atol=ATOL_ELEM)
        assert not got[2].any()
    labels = ["Bark", "Siren", "Doorbell"]
    names = ["sound of Bark", "Siren", "sound of Cat"]
    table = rng.randn(3, 5).astype(np.float32)

    def encoder(prompts):
        return np.full((len(prompts), 5), float(len(prompts[0])), np.float32)

    for normalize in (False, True):
        got = queries.build_text_query_bank(labels, names, table, text_encoder=encoder,
                                            normalize=normalize)
        want = jax_queries.build_text_query_bank(labels, names, table, text_encoder=encoder,
                                                 normalize=normalize)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="1 labels missing"):
        queries.build_text_query_bank(labels, names, table)
    (tmp_path / "l.json").write_text(json.dumps({"b": 1, "a": 0}))
    (tmp_path / "l.txt").write_text("x\n\ny\n")
    for f in ("l.json", "l.txt"):
        assert queries.load_labels(str(tmp_path / f)) == jax_queries.load_labels(str(tmp_path / f))
    np.savez(tmp_path / "t.npz", names=np.array(names), embeddings=table)
    got, want = (m.load_embedding_table(str(tmp_path / "t.npz"))
                 for m in (queries, jax_queries))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_build_text_cli_matches_jax(tmp_path, capsys):
    """``queries build_text`` from a labeldict and an ``.npy`` table with its
    names file: the bank and its names file equal the JAX CLI's, bitwise."""
    labels = {"Speech": 0, "Bark": 1, "Siren": 2}
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    np.save(tmp_path / "table.npy", np.random.RandomState(6).randn(4, 8).astype(np.float32))
    (tmp_path / "names.txt").write_text("sound of Bark\nSiren\nsound of Speech\nCat\n")
    outs = {}
    for tag, main in (("port", queries.main), ("jax", jax_queries.main)):
        out = tmp_path / tag / "bank.npy"
        assert main(["build_text", "--labels", str(tmp_path / "labels.json"), "--embeddings",
                     str(tmp_path / "table.npy"), "--embedding_names",
                     str(tmp_path / "names.txt"), "--out", str(out), "--normalize"]) == 0
        outs[tag] = (np.load(out), (tmp_path / tag / "bank_names.txt").read_text())
    assert np.array_equal(outs["port"][0], outs["jax"][0]) and outs["port"][1] == outs["jax"][1]
    assert "wrote 3x8 query bank" in capsys.readouterr().out


# -- the stage and serving refusals ---------------------------------------------------------


def _clap_config(tmp_path):
    """config/clap/clap.yaml with the tiny CLAP_SED."""
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include

    config = load_yaml_with_include("config/clap/clap.yaml")
    config["CLAP_SED"]["init_kwargs"] = json.loads(json.dumps(CLAP))  # tuples -> lists
    path = tmp_path / "clap.yaml"
    path.write_text(safe_dump(config))
    return str(path)


def test_clap_train_refuses_several_ranks(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="clap_train under several ranks .* item 15"):
        cli.main(["clap_train", "--config_dir", _clap_config(tmp_path), "--save_folder",
                  str(tmp_path / "run"), "--device", "cpu"])


def test_clap_with_query_is_refused_where_jax_fails(jax_side, tmp_path, capsys):
    """JAX's serve passes ``query_type`` with every ``--query`` and CLAP_SED
    has no such argument (a TypeError); the port's serve and infer refuse
    the pair when they read the flags. A learnable-query DASM_HTSAT given a
    bank fails in JAX (it has no projectors to look up) and uses the bank as
    it is in the port, as DASM does in both."""
    errors = jax_side["refusals"].result()
    assert errors["clap_query_type"].startswith("TypeError") and (
        "query_type" in errors["clap_query_type"])
    assert errors["learnable_external_query"].startswith("AttributeError")
    cfg = _clap_config(tmp_path)
    for main, extra in ((serve.main, ["--wav_dir", ".", "--out_dir", str(tmp_path / "o")]),
                        (cli_infer_main, ["--wav", "x.wav"])):
        with pytest.raises(SystemExit):
            main(["--config_dir", cfg, "--ckpt", "c.pt", "--query", "q.npy", "--device", "cpu",
                  *extra])
        assert "--query with CLAP_SED" in capsys.readouterr().err
    port = _port("dasm_learnable_sigmoid_pad_mask").eval()
    with torch.no_grad():
        own = port(torch.from_numpy(mel(1, 4)))
        given = port(torch.from_numpy(mel(1, 4)), query=port.at_query.detach().numpy())
    assert torch.equal(own.strong, given.strong)


def cli_infer_main(argv):
    from transformer4sed_tpu_torch.recipes import infer

    return infer.main(argv)


# -- the forwards against the JAX program ---------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(jax_side, variant):
    port = _port(variant).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(mel(2, 3)), **{
            k: (torch.from_numpy(v) if k == "pad_mask" else v)
            for k, v in forward_kwargs(variant).items()})
    net, _ = VARIANTS[variant]
    want = jax_side["clap_forward" if net == "CLAP_SED" else "dasm_forward"].result()[variant]
    assert set(want) == {f for f in ("strong", "weak", "at_out") if getattr(got, f) is not None}
    for f, w in want.items():
        np.testing.assert_allclose(getattr(got, f).numpy(), w, atol=ATOL_FORWARD, err_msg=f)
    pad = forward_kwargs(variant).get("pad_mask")
    if pad is not None:  # both networks zero the padded frames, with no clamp after
        assert (got.strong[1][:, pad[1]] == 0).all()


# -- the steps against the JAX steps --------------------------------------------------------


def _draw(st, filt=True):
    views = [augment.ViewDraw()]
    if filt:
        views = [augment.ViewDraw(filt=augment.FiltAugDraw(
            st["n_bands"], torch.from_numpy(st["band_raw"]), torch.from_numpy(st["band_db"])))]
    return audioset_strong.SupervisedDraw(None, torch.from_numpy(st["shifts"]), st["do_mix"],
                                          torch.from_numpy(st["perm"]), st["c"], views)


def _port_opt(**extra):
    return optim.ParamGroupConfig(**{k: optim.GroupSpec(**v) for k, v in fam.opt_spec(
        **extra).items()}, clip_grad=0.5)


def _held(port, end, start):
    """The port's params and running statistics against JAX's end state;
    the names that did not move."""
    for name, want in jax_params_to_state_dict(end, names=port.state_dict().keys()).items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), want, atol=ATOL_PARAMS,
                                   err_msg=name)
    return {n for n, v in port.state_dict().items() if torch.equal(v, start[n])}


def test_clap_step_matches_jax(jax_side):
    """One ``ClapStep`` against ``make_clap_step`` with JAX's draws (AslLoss;
    the labels of classes 0, 2 and 3 shifted by ``floor(shift / 3)``, 3 =
    round(100 / 32); mixup; filt_aug; the common rows of the bank): the
    loss, the params, bn0's running statistics, and ``text_query``, which
    only AdamW's decay moves."""
    st, end = jax_side["clap"].result()
    port = _port("clap_own_bank_pad_mask")
    start = {k: v.clone() for k, v in port.state_dict().items()}
    cfg = audioset_strong.SupervisedConfig(**LOSS, mixup_prob=1.0, model_kwargs={"temp_w": 1.0})
    stepper = clap.ClapStep(port, _IdentityFrontend(), cfg, _port_opt(), common_mask=CLAP_COMMON,
                            query_bank=banks(2, 5)[0])
    assert stepper.labels["text_query"] == "head" and st["do_mix"] and (st["shifts"] != 0).any()
    pm = stepper.step(step_batch(5, fam.CLAP_FRAMES), None, _draw(st))
    np.testing.assert_allclose(float(pm["loss_class_strong"]), st["metrics"]["loss_class_strong"],
                               atol=ATOL_LOSS, rtol=RTOL_LOSS)
    assert stepper.step_count == 1
    still = _held(port, end, start)
    assert not still & {"text_query", "backbone.bn0.running_mean", "backbone.bn0.running_var"}
    head = OPT["head"]
    np.testing.assert_allclose(port.text_query.detach().numpy(), start["text_query"].numpy() * (
        1 - head["lr"] * head["weight_decay"]), atol=ATOL_ELEM)


def test_dasm_htsat_step_matches_jax(jax_side):
    """One ``DASMStep`` forward and backward on the two-modality DASM_HTSAT
    (no SED decoder: its XL decoder is DASM's) against ``make_dasm_step``
    with JAX's draws (the (C+1)-way CE, mixup, the AT decoder's dropout
    masks, the per-query modality pick; no shift or filt_aug): the losses,
    every gradient and bn0's running statistics after it; and the AudioSet
    optimizer's groups on DASM_HTSAT's params, label by label."""
    st, end = jax_side["dasm"].result()
    port = _step_port()
    cfg = dasm_recipe.DASMTrainConfig(out_type="logit", w_at=0.7, max_shift_frame=0,
                                      mixup_prob=1.0, transform_choice=(0, 0, 0, 0),
                                      model_kwargs={"temp_w": 0.1})
    stepper = dasm_recipe.DASMStep(port, _IdentityFrontend(), cfg, _port_opt(),
                                   query=[torch.from_numpy(b) for b in banks()])
    masks = [torch.from_numpy(m).float() / AT_KEEP for m in st["masks"]]
    assert len(masks) == 4 and st["do_mix"] and not st["shifts"].any()
    pm = stepper.forward_backward(step_batch(3, fam.DASM_FRAMES), None, _draw(st, filt=False),
                                  masks, query_pick=torch.from_numpy(st["pick"]))
    for k in ("loss_total", "loss_class_strong", "loss_class_at_specific"):
        np.testing.assert_allclose(float(pm[k]), st["metrics"][k], atol=ATOL_LOSS,
                                   rtol=RTOL_LOSS, err_msg=k)
    want = jax_params_to_state_dict(end, names=port.state_dict().keys())
    grads = {n: p.grad for n, p in port.named_parameters()}
    for name, w in want.items():
        got = grads[name] if name in grads else port.state_dict()[name]
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL_GRAD, err_msg=name)
    assert grads["query_projector.1.0.weight"].abs().max() > 0  # the audio modality drawn
    params = jax_variables("DASM_HTSAT", _np_state(port))["params"]
    labels = jax_optim.label_params(params, fam.opt_cfg(at_decoder=True, query=True))
    coded = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), fam.GROUPS.index(lab), np.float32), labels, params)
    ours = optim.label_params(grads, _port_opt(at_decoder=True, query=True))
    assert {"encoder_high", "encoder_low", "decoder", "at_decoder", "head"} <= set(ours.values())
    for name, arr in jax_params_to_state_dict(coded, names=grads.keys()).items():
        assert np.all(arr == fam.GROUPS.index(ours[name])), name


class _Capture(torch.nn.Module):
    """A query network that records the mel it is given."""

    query_projector = None

    def __init__(self):
        super().__init__()
        self.at_query = torch.nn.Parameter(torch.zeros(3, 2))
        self.seen = []

    def forward(self, mel, train=False, temp_w=0.1, **kw):
        self.seen.append(mel)
        strong = torch.sigmoid(self.at_query.sum() + torch.zeros(mel.shape[0], 3, 64))
        return SEDOutput(strong=strong, at_out=strong.mean(-1))


def test_dasm_step_shifts_the_htsat_mel_in_time_where_jax_rolls_its_bins():
    """The port's DASM step turns DASM_HTSAT's [B, 1, T, F] mel to [B, F, T]
    for the augmentations and back: the shift rolls time. JAX's step hands
    the 4-d mel over as it is: its frame shift rolls the last axis, the mel
    bins, and its filt_aug refuses a 4-d input."""
    x = mel(B, 7)
    shifts = np.array([3, -5, 0, 7])
    model = _Capture()
    cfg = dasm_recipe.DASMTrainConfig(mixup_prob=0.0, model_kwargs={"temp_w": 0.1})
    stepper = dasm_recipe.DASMStep(model, _IdentityFrontend(), cfg, _port_opt())
    draw = audioset_strong.SupervisedDraw(None, torch.from_numpy(shifts), False,
                                          torch.arange(B), 1.0, [augment.ViewDraw()])
    stepper.loss_fn({"wav": x, "labels": np.zeros((B, 3, 64), np.float32)}, None, draw)
    want = np.stack([np.roll(x[i], s, axis=1) for i, s in enumerate(shifts)])
    np.testing.assert_array_equal(model.seen[0].numpy(), want)
    key = jax.random.PRNGKey(3)
    drawn = np.asarray((jax.random.normal(key, (B,)) * 90).astype(jnp.int32))
    rolled = jax_augment.frame_shift(key, jnp.asarray(x), max_shift_frame=90)
    np.testing.assert_array_equal(np.asarray(rolled), np.stack(
        [np.roll(x[i], s, axis=-1) for i, s in enumerate(drawn)]))
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_augment.filt_aug(jax.random.PRNGKey(0), jnp.asarray(x))
