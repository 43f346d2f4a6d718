"""Luma weights and sRGB transfer-curve constants (reference:
src/color.zig:63-89), copied from zignal_tpu/color/_scalar.py."""

LUMA_R = 0.2126  # Rec.709
LUMA_G = 0.7152
LUMA_B = 0.0722

SRGB_LINEAR_THRESHOLD = 0.0031308
SRGB_GAMMA_THRESHOLD = 0.04045
SRGB_GAMMA_OFFSET = 0.055
SRGB_GAMMA_SCALE = 1.055
SRGB_LINEAR_SLOPE = 12.92
SRGB_GAMMA_EXPONENT = 2.4
