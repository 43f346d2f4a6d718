"""Device ops: resize of every method (u8 and float), separable and 2-D
convolution, Gaussian blur and Sobel, the integral image, clamped-window
box blur, sharpen and adaptive threshold, the order-statistic blurs, Canny
and Shen-Castan, the image pyramid, threshold and morphology, histograms,
LUTs, Otsu, equalize and autocontrast, flood fill, the host quantize and
dither ops under GIF and sixel, and the kernels: the fused resize ->
blur -> Oklab kernel, the fused filter chain, the separable u8 convolution
and the fused colour chain with its probe."""
