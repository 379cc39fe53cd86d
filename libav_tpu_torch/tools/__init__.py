"""The port's command-line tools (counterpart of `libav_tpu/tools`).

`avconv` and `avprobe` run the JAX package's CLI code itself, loaded a
second time from its source file as a module of its own
(`hostcode.load_host_module`), whose imports answer the device-facing
names with the port's: the codec lookup bound to a torch device, the
torch.profiler timer. `kernel_probe` times the hand kernels against their
plain versions (counterpart of `pallas_probe`).
"""
