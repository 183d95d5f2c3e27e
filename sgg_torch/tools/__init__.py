"""The port's command-line tools (``python -m sgg_torch.tools.<name>``):
profilers that split the main paths by stage on the card, the end-to-end
throughput and soak runs, the gate re-probe, the fixture and preflight
tools for real data, the feature-cache IO tools and the CLI dress
rehearsal (``dress_rehearsal.sh``). Each runs on the card unless given
``-device cpu`` and prints one JSON object as its last line."""
