"""Upload of each picture's host state, ms per frame: a benchmark span
around `hwdevice.state_from_numpy`, which copies synchronously with
`torch.tensor(..., device=)`, over the traced run (nested calls count
once). Moves `decode_fps`."""

TARGET = "libav_tpu_torch.avutil.hwdevice:state_from_numpy"


def install(run):
    run.spans.patch("upload", TARGET)
    run.upload_frames0 = run.traced_frames


def read(run):
    frames = run.traced_frames - run.upload_frames0
    seconds = run.spans.spans["upload"].seconds()
    return 1e3 * seconds / frames if frames and seconds else None
