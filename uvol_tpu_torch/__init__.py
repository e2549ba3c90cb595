"""uvol_tpu_torch — the PyTorch/CUDA port of uvol_tpu's device codec chain.

The JAX package `uvol_tpu` stays the reference; this package computes
the same bytes with PyTorch on an NVIDIA Hopper card, and with plain
PyTorch on the CPU. Layout mirrors the reference so each module has an
obvious counterpart:

  ops.quantize, ops.prediction   quantize / zigzag / delta (plain torch)
  codecs.basis.etc               ETC1 block codec, plain twins
  codecs.basis.etc_cuda          ETC1 image encode/decode wrappers over
                                 the hand-written kernels in csrc/etc1.cu
  codecs.basis.etc1s_cuda        ETC1S palette-build kernels K4-K6 (csrc/
                                 etc1s.cu) and their plain twins
  codecs.basis.etc1s_encode      ETC1S/BasisLZ segment encoder, device side
  models.sequence                Geometry/TextureSequenceCodec (.uvtg, .ktx2)
  convert                        codec state from a JAX codec
  entry                          the fused forward step of __graft_entry__

Host layers without JAX (rANS symbol coding, buffers, KTX2, zstd, the
native rANS library, the Basis transcoder, Huffman coder and ETC1S bit
emission) are imported from `uvol_tpu` as they are. This
package never imports `jax`.
"""

from uvol_tpu_torch._device import resolve_device  # noqa: F401

__version__ = "0.1.0"
