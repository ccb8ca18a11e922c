"""jxl_coder: JPEG XL codec in JAX for an NVIDIA GPU.

From-scratch reimplementation of the capability surface of awxkee/jxl-coder
(see SURVEY.md): host-side Python/C++ bitstream layer, device-side jnp
compute compiled by XLA, group-grid sharding via shard_map.
"""
__version__ = "0.1.0"
