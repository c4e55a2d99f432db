"""Device compute ops: SDF math, quad evaluation, rasterizers, blur, binning."""
