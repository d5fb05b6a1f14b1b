"""The marching pool kernel's share of its roofline: the least time the H100
could take for every job of the window (``costmodel.pool_work``, whose
marching walks are the ``cell_face`` passes the kernel counted, summed over
the job's ``launch`` spans; photons emitted and rounds as ``Run.work``
counts them) over the device time of every ``pool_march`` kernel in the
trace. Nothing where a job's launches lack the count (a program that does
not report it), the spans were dropped or the trace holds no such kernel."""

from portbench import costmodel
from portbench.program_spans import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    seconds = run.trace.kernel_s("pool_march_kernel")
    if seconds <= 0:
        return None
    # the window's job spans, in the order the jobs ran, beside its jobs
    jobs = [s for s in spans if s.name == "job"]
    if len(jobs) != len(run.jobs):
        return None
    faces = {s.job: [] for s in jobs}
    for s in spans:
        if s.name == "launch" and s.job in faces:
            faces[s.job].append(s.attrs.get("cell_face"))
    shapes, bound = {}, 0.0
    for span, job in zip(jobs, run.jobs):
        counts = faces[span.job]
        if not counts or None in counts or span.attrs.get("wl") != job["wl"]:
            return None
        if job["wl"] not in shapes:
            shapes[job["wl"]] = costmodel.launch_shape(run.cell.config, run.cell.traffic,
                                                       job["wl"])
        bound += costmodel.bound_s(*costmodel.pool_work(
            **shapes[job["wl"]], emitted=job["packages"],
            rounds=int(job["detector"][..., 1, 2].sum()), cell_face=sum(counts)))
    return 100.0 * bound / seconds
