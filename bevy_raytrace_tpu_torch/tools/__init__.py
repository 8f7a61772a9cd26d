"""Developer tools of the port, each runnable as a module:

    python -m bevy_raytrace_tpu_torch.tools.proto_probes   # P1-P5
    python -m bevy_raytrace_tpu_torch.tools.fp32_probe     # V1-V3, rates
    python -m bevy_raytrace_tpu_torch.tools.grad_bench     # gradient step
    python -m bevy_raytrace_tpu_torch.tools.scaling        # sharding record
    python -m bevy_raytrace_tpu_torch.tools.ref_probe      # frame loops

They run on the CUDA device and raise where there is none; `--device cpu`
runs the plain PyTorch versions on the CPU.  Nothing is built at import
time.
"""
