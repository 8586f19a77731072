"""Acceptance calibration: the host calibrator (a copy of the JAX
package's) and its device-side lookup."""
