"""Device ops: u8 bilinear resize, u8 separable convolution and Gaussian
blur, clamped-window box blur and sharpen, threshold and morphology, and
the kernels: the fused resize -> blur -> Oklab kernel, the fused filter
chain and the separable u8 convolution."""
