"""Prompt tokens served (from the cache or computed) plus output tokens
delivered in the window, over the window. A prompt counts in the share of
its prefill that lies in the window (``pbench.readers.prompt_in_window``:
its tokens spread evenly over the ticks from its admission to its first
token), output tokens as they become visible; a tick that the window's end
cuts counts in the share of its time inside. So the work of the window's
ticks is counted by time, not in whole prompts or whole ticks."""

from pbench.readers import prompt_in_window, tokens_in_window


def read(run):
    n = sum(share * len(r.req.prompt) for r, share in prompt_in_window(run))
    return (n + tokens_in_window(run)) / run.seconds
