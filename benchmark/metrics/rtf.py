"""rtf (audio_s/s): audio seconds of every render completed in the window
over the window's wall seconds, from the first request's issue to the last
PCM on the host."""


def read(run):
    w = run.window
    return sum(w.audio_s) / w.wall_s if w.wall_s > 0 and w.audio_s else None
