"""Output serialization (BMP) and file helpers."""

from pim_jpeg_decoder_tpu_torch.io.bmp import write_bmp, encode_bmp, read_bmp

__all__ = ["write_bmp", "encode_bmp", "read_bmp"]
