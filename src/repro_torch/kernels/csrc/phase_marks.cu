// Phase marks: one empty kernel per phase of a serving step, named after
// its phase, so that a device trace of a replayed CUDA graph shows by name
// where each phase starts (kernels/phase_marks.py). A traced runtime
// captures them into its step graphs; an untraced one holds none.

#include <cuda_runtime.h>

#define PHASE_MARK(name) \
  extern "C" __global__ void phase_mark_##name() {}

// the order of kernels/phase_marks.py's PHASES
PHASE_MARK(chunk)
PHASE_MARK(decode)
PHASE_MARK(attention)
PHASE_MARK(moe)
PHASE_MARK(head)
PHASE_MARK(end)
PHASE_MARK(regather)
PHASE_MARK(mlp)
PHASE_MARK(shared_expert)

extern "C" int phase_mark_launch(int phase, void* stream) {
  static void (*const kMarks[])() = {
      phase_mark_chunk, phase_mark_decode, phase_mark_attention,
      phase_mark_moe,   phase_mark_head,   phase_mark_end,
      phase_mark_regather, phase_mark_mlp, phase_mark_shared_expert};
  if (phase < 0 || phase >= static_cast<int>(sizeof(kMarks) /
                                             sizeof(kMarks[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  kMarks[phase]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
