"""A trained scene's stand-in: clustered, mostly opaque gaussians in front
of the camera (`scenes.trained_like_gaussians`), whose tiles saturate."""

from splatbench import scenes


def make(generator, points, camera):
  return scenes.trained_like_gaussians(generator, points, camera)
