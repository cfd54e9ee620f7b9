from gpvae_tpu.utils.profiling import (
    trace,
    StepTimer,
    cholesky_flops,
    device_memory_stats,
    card_info,
)
from gpvae_tpu.utils.compile_cache import enable_compile_cache
from gpvae_tpu.utils.debug import (
    assert_finite,
    check_finite,
    enable_nan_debugging,
)

__all__ = [
    "trace",
    "StepTimer",
    "cholesky_flops",
    "device_memory_stats",
    "card_info",
    "assert_finite",
    "check_finite",
    "enable_nan_debugging",
    "enable_compile_cache",
]
