"""uvol_tpu_torch — the PyTorch/CUDA port of uvol_tpu's device codec chain.

The JAX package `uvol_tpu` stays the reference; this package computes
the same bytes with PyTorch on an NVIDIA Hopper card, and with plain
PyTorch on the CPU. Layout mirrors the reference so each module has an
obvious counterpart:

  ops.quantize, ops.prediction   quantize / zigzag / delta (plain torch)
  ops.pallas_kernels             K3, the fused quantize+delta+zigzag of the
                                 geometry encode (csrc/geometry.cu), and
                                 its plain twin
  codecs.basis.etc               ETC1 block codec, plain twins
  codecs.basis.etc_cuda          ETC1 image encode/decode wrappers over
                                 the hand-written kernels in csrc/etc1.cu
  codecs.basis.etc1s_cuda        ETC1S palette-build kernels K4-K6 (csrc/
                                 etc1s.cu) and their plain twins
  codecs.basis.etc1s_encode      ETC1S/BasisLZ segment encoder
  models.sequence                Geometry/TextureSequenceCodec (.uvtg, .ktx2)
  convert                        codec state from a JAX codec
  entry                          the fused forward step of __graft_entry__

The host layers (varint/buffer, rANS and symbol coding, KTX2, zstd, the
Basis transcoder's RGBA decode, the Huffman coder, the ETC1S bit
emission, and the C++ loops of `native/`) are the port's own copies of
the reference's modules, byte for byte in what they emit. This package
imports neither `jax` nor the JAX package.
"""

__version__ = "0.1.0"


def __getattr__(name: str):
    # `resolve_device` on first use: importing the package imports no torch,
    # so the encoder CLI's spawned Draco workers start on numpy alone
    if name == "resolve_device":
        from uvol_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'uvol_tpu_torch' has no attribute {name!r}")
