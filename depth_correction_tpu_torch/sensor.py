"""Gaussian-beam sensor optics models (counterpart of
``depth_correction_tpu/sensor.py``).

The reference's beam model (reference: src/depth_correction/sensor.py:
27-99): Rayleigh length, beam radius against depth, and presets for the
Hokuyo UTM-30LX and Ouster OS0 lidars. Informational: not wired into
training (as in the reference).
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Sensor", "Sensors", "rayleigh_length", "beam_radius"]


def rayleigh_length(w0: float, wavelength: float, m2: float = 1.0) -> float:
    """z_R = pi * w0^2 / (M^2 * lambda) (reference: sensor.py:27-40)."""
    return math.pi * w0**2 / (m2 * wavelength)


def beam_radius(z, w0: float, wavelength: float, m2: float = 1.0):
    """w(z) = w0 * sqrt(1 + (z / z_R)^2) (reference: sensor.py:43-63) of a
    float (-> float) or a tensor (-> tensor)."""
    zr = rayleigh_length(w0, wavelength, m2)
    if torch.is_tensor(z):
        return w0 * torch.sqrt(1.0 + (z / zr) ** 2)
    return w0 * math.sqrt(1.0 + (z / zr) ** 2)


@dataclasses.dataclass(frozen=True)
class Sensor:
    """Lidar beam parameters (reference: sensor.py:70-99)."""

    name: str
    wavelength: float  # [m]
    beam_exit_radius: float  # w0 [m]
    m2: float = 1.0  # beam propagation factor

    @property
    def rayleigh_length(self) -> float:
        return rayleigh_length(self.beam_exit_radius, self.wavelength, self.m2)

    def beam_radius(self, depth):
        return beam_radius(depth, self.beam_exit_radius, self.wavelength, self.m2)


class Sensors:
    """Presets (nominal values from the respective datasheets)."""

    hokuyo_utm_30lx = Sensor(name="Hokuyo UTM-30LX", wavelength=905e-9, beam_exit_radius=0.0085)
    ouster_os0 = Sensor(name="Ouster OS0", wavelength=865e-9, beam_exit_radius=0.005)
