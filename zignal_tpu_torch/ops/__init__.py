"""Device ops: u8 bilinear resize, u8 separable convolution and Gaussian
blur, clamped-window box blur and sharpen, threshold and morphology,
histograms, LUTs, Otsu, equalize and autocontrast, and the kernels: the
fused resize -> blur -> Oklab kernel, the fused filter chain, the separable
u8 convolution and the fused colour chain with its probe."""
