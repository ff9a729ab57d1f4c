"""Evaluation and ratings (torch twin of dotaclient_tpu/eval/):

- eval/rating.py     TrueSkill (1v1 and two-team updates, win
                     probabilities, a rating table with anchors);
- eval/league.py     a self-play actor's local snapshot pool with PFSP;
- eval/evaluator.py  frozen-policy episodes against the scripted bot;
                     `python -m dotaclient_tpu_torch.eval.evaluator`.
"""
