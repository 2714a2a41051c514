"""Template builders: PCA/B-spline (ppspline) and Gaussian (ppgauss)."""
