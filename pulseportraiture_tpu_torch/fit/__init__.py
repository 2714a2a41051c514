"""Fourier-domain fits: FFTFIT phase shifts and the portrait fit."""
