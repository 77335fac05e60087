"""JPEG marker constants (ITU-T T.81 Table B.1).

Equivalent of the reference's marker constant block
(reference: src/headers/jpeg.h:6-79) — every marker the reference knows,
plus name lookup for diagnostics.
"""

# Start/End of image
SOI = 0xFFD8
EOI = 0xFFD9

# Start of Frame markers, non-differential, Huffman coding
SOF0 = 0xFFC0  # Baseline DCT
SOF1 = 0xFFC1  # Extended sequential DCT
SOF2 = 0xFFC2  # Progressive DCT
SOF3 = 0xFFC3  # Lossless (sequential)
# Start of Frame markers, differential, Huffman coding
SOF5 = 0xFFC5
SOF6 = 0xFFC6
SOF7 = 0xFFC7
# Start of Frame markers, non-differential, arithmetic coding
SOF9 = 0xFFC9
SOF10 = 0xFFCA
SOF11 = 0xFFCB
# Start of Frame markers, differential, arithmetic coding
SOF13 = 0xFFCD
SOF14 = 0xFFCE
SOF15 = 0xFFCF

# Huffman / arithmetic table definitions
DHT = 0xFFC4  # Define Huffman Table(s)
DAC = 0xFFCC  # Define Arithmetic Coding conditioning(s)

# Restart interval markers RST0..RST7
RST0 = 0xFFD0
RST1 = 0xFFD1
RST2 = 0xFFD2
RST3 = 0xFFD3
RST4 = 0xFFD4
RST5 = 0xFFD5
RST6 = 0xFFD6
RST7 = 0xFFD7

# Other segment markers
SOS = 0xFFDA  # Start of Scan
DQT = 0xFFDB  # Define Quantization Table(s)
DNL = 0xFFDC  # Define Number of Lines
DRI = 0xFFDD  # Define Restart Interval
DHP = 0xFFDE  # Define Hierarchical Progression
EXP = 0xFFDF  # Expand Reference Component(s)

# Application segments APP0..APP15
APP0 = 0xFFE0
APP1 = 0xFFE1
APP2 = 0xFFE2
APP3 = 0xFFE3
APP4 = 0xFFE4
APP5 = 0xFFE5
APP6 = 0xFFE6
APP7 = 0xFFE7
APP8 = 0xFFE8
APP9 = 0xFFE9
APP10 = 0xFFEA
APP11 = 0xFFEB
APP12 = 0xFFEC
APP13 = 0xFFED
APP14 = 0xFFEE
APP15 = 0xFFEF

# JPEG extensions / reserved
JPG = 0xFFC8
JPG0 = 0xFFF0
JPG1 = 0xFFF1
JPG2 = 0xFFF2
JPG3 = 0xFFF3
JPG4 = 0xFFF4
JPG5 = 0xFFF5
JPG6 = 0xFFF6
JPG7 = 0xFFF7
JPG8 = 0xFFF8
JPG9 = 0xFFF9
JPG10 = 0xFFFA
JPG11 = 0xFFFB
JPG12 = 0xFFFC
JPG13 = 0xFFFD

COM = 0xFFFE  # Comment
TEM = 0xFF01  # Temporary private use in arithmetic coding

# Marker classes useful for dispatch
SOF_MARKERS = (SOF0, SOF1, SOF2, SOF3, SOF5, SOF6, SOF7,
               SOF9, SOF10, SOF11, SOF13, SOF14, SOF15)
RST_MARKERS = tuple(range(RST0, RST7 + 1))
APP_MARKERS = tuple(range(APP0, APP15 + 1))
JPG_SKIP_MARKERS = tuple(range(JPG0, JPG13 + 1))

_NAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int) and k.isupper()}


def marker_name(marker: int) -> str:
    """Human-readable marker name for diagnostics."""
    return _NAMES.get(marker, f"0x{marker:04X}")
