"""The JAX side of ``tests/test_torch_port_options.py``'s two finetune2 eval
forwards, run in a worker process.

It imports JAX, numpy and the JAX package only (no torch and nothing of the
port), so that a spawned worker starts in about half the time; it takes the
port's seeded weights as numpy state dicts and returns numpy. The tiny
configurations live here, where both sides read them.
"""

import jax
import jax.numpy as jnp
import numpy as np

from transformer4sed_tpu.models.passt_cnn import PaSST_CNN as JaxPaSSTCNN
from transformer4sed_tpu.models.passt_sed import PaSST_SED as JaxSED
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from tests.torch_port_jax import jit0

# the tiny PaSST_SED of tests/test_torch_port_train.py: the backbone's nominal
# time grid (11 patches) is the 121-frame clip's, so only the windows (5
# patches) draw a time-embedding offset in training
TINY = dict(
    class_num=2, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
    decoder_num_heads=4, passt_feature_layer=2, decoder_layer_num=1,
    decoder_pos_emd_len=120, at_adapter=True, at_adapter_heads=4, backbone_img_size=(128, 120),
)
FRAMES = 121
# windows of 64 frames at a step of 20: starts 0, 20, 40 (width 64) and 60
# (a ragged 61), two width groups; offsets round(s * 120 / 121)
WIN = dict(encoder_win=True, win_param=(64, 20), mix_rate=0.3)
BANDS = (3, 8, 1, 300)  # decoder_win_len, one per head
# the finetune2 PaSST_SED: local attention, nearest interpolation
TINY_FT2 = dict(TINY, decoder_win_len=list(BANDS), interpolate_mode="nearest")
# PaSST_CNN of tests/test_torch_port_pmam.py's shape, with the windows
TINY_CNN = dict(nb_filters=(4, 8), kernel_size=(3, 3), padding=(1, 1), stride=(1, 1),
                pooling=((2, 8), (2, 16)), activation="cg", conv_dropout=0.0)
TINY_PMAM = dict(TINY, class_num=3, embed_dim=48, f_pool="attention", cnn_name="base",
                 cnn_param=TINY_CNN)


def mel(b, seed):
    return (np.random.RandomState(seed).randn(b, 128, FRAMES) * 0.5).astype(np.float32)


def pad_mask():
    """The padded tail of the second clip (on the 120-frame output grid)."""
    pm = np.zeros((2, 120), bool)
    pm[1, 70:] = True
    return pm


def jax_variables(sd, name, cfg):
    params, state = convert_torch_checkpoint(sd, name, init_kwargs=cfg)
    return {"params": params, **state}


def finetune2_evals(sed_sd, cnn_sd):
    """JAX ``apply`` of the finetune2 PaSST_SED (windows, local attention,
    nearest interpolation, a padded tail) and of PaSST_CNN with the windows,
    from the port's state dicts: {name: {strong, weak, at_out}}."""
    sed, cnn = JaxSED(**TINY_FT2), JaxPaSSTCNN(**TINY_PMAM)
    want_sed = jit0(lambda v, m, p: sed.apply(v, m, pad_mask=p, temp_w=0.5, **WIN))(
        jax_variables(sed_sd, "PaSST_SED", TINY_FT2), jnp.asarray(mel(2, seed=1)),
        jnp.asarray(pad_mask()))
    want_cnn = jit0(lambda v, m: cnn.apply(v, m, temp_w=0.5, **WIN))(
        jax_variables(cnn_sd, "PaSST_CNN", TINY_PMAM), jnp.asarray(mel(2, seed=2)))
    return jax.tree_util.tree_map(np.asarray, {
        name: {k: getattr(out, k) for k in ("strong", "weak", "at_out")}
        for name, out in (("passt_sed", want_sed), ("passt_cnn", want_cnn))})
