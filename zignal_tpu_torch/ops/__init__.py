"""Device ops: u8 bilinear resize, u8 Gaussian blur and the fused
resize -> blur -> Oklab kernel."""
