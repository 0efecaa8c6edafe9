"""The plain reference: a straightforward path tracer in PyTorch over the
benchmark's ``SceneData``, independent of the program under test (it
imports nothing of it). ``render.render_pixels`` recomputes the radiance
sums of chosen pixels from the scene, the camera, the seed and the sample
window, by brute force over every world-space triangle."""
