"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (counterpart of ``mxnet_tpu/pallas_kernels``): a CUDA tensor
launches the kernel, a CPU or ``meta`` tensor takes the plain version."""
from .box_nms import box_nms_sorted, box_nms_sorted_reference, nms_plan
from .correlation import (correlation, correlation_bwd,
                          correlation_reference)
from .dropout import (hash_dropout, hash_dropout_bwd,
                      hash_dropout_reference)
from .flash import (flash_attention, flash_attention_bwd,
                    flash_attention_bwd_reference, flash_attention_fwd,
                    flash_attention_reference)
from .fused_layers import (fused_bias_gelu, fused_bias_gelu_bwd,
                           fused_bias_gelu_bwd_reference,
                           fused_bias_gelu_reference, fused_layer_norm,
                           fused_layer_norm_bwd,
                           fused_layer_norm_bwd_reference,
                           fused_layer_norm_reference, fused_rms_norm,
                           fused_rms_norm_bwd, fused_rms_norm_bwd_reference,
                           fused_rms_norm_reference)
from .fused_optimizer import (adam_sweep_reference, adamw_sweep_reference,
                              fused_adam_sweep, fused_adamw_sweep,
                              fused_lamb_sweep, fused_sgd_sweep,
                              lamb_sweep_reference, sgd_sweep_reference)
from .gradient_compression import (twobit_quantize,
                                   twobit_quantize_reference)
from .paged_attention import (paged_attention_kernel,
                              paged_attention_reference,
                              paged_attention_split_reference, paged_splits)
from .roi_align import roi_align, roi_align_bwd, roi_align_reference

__all__ = ["hash_dropout", "hash_dropout_bwd", "hash_dropout_reference",
           "fused_rms_norm", "fused_rms_norm_reference",
           "fused_rms_norm_bwd", "fused_rms_norm_bwd_reference",
           "fused_layer_norm", "fused_layer_norm_reference",
           "fused_layer_norm_bwd", "fused_layer_norm_bwd_reference",
           "fused_bias_gelu", "fused_bias_gelu_reference",
           "fused_bias_gelu_bwd", "fused_bias_gelu_bwd_reference",
           "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference",
           "fused_sgd_sweep", "sgd_sweep_reference",
           "fused_adam_sweep", "adam_sweep_reference",
           "fused_adamw_sweep", "adamw_sweep_reference",
           "fused_lamb_sweep", "lamb_sweep_reference",
           "paged_attention_kernel", "paged_attention_reference",
           "paged_attention_split_reference", "paged_splits",
           "twobit_quantize", "twobit_quantize_reference",
           "box_nms_sorted", "box_nms_sorted_reference", "nms_plan",
           "roi_align", "roi_align_bwd", "roi_align_reference",
           "correlation", "correlation_bwd", "correlation_reference"]


def launch_counters() -> dict:
    """``{(wrapper, attribute): count}`` over every launch counter of the
    kernel wrappers above (``launches``, ``wgmma_launches``, ...), of
    each live ``mx.rtc`` kernel and of the RNN op's cuDNN route: what a
    CUDA graph capture puts back and each replay adds again."""
    from .. import rtc
    from ..ops.rnn import cudnn_rnn_layer

    out = {(k, "launches"): k.launches for k in rtc.live_kernels()}
    out[(cudnn_rnn_layer, "launches")] = cudnn_rnn_layer.launches
    for name in __all__:
        fn = globals()[name]
        for attr, v in vars(fn).items():
            if attr.endswith("launches") and isinstance(v, int):
                out[(fn, attr)] = v
    return out
