"""The attention kernels; importing the package registers their custom ops
(``t4s::flash_nhd_fwd``, ``t4s::xl_nhd_fwd``, ``t4s::xl_hm_fwd``,
``t4s::window_fwd``), which an exported serving program calls."""

from transformer4sed_tpu_torch.kernels import flash_attention, window_attention, xl_attention  # noqa: F401
