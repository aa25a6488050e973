"""NOS009 positives for the PyTorch rules (under a `scheduler/` segment:
sim/planner scope): draws on torch's global generator and its reseeds,
beside the stdlib's global RNG."""

import random

import torch


def jitter(n):
    a = torch.rand(n)  # NOS009
    b = torch.randn(n, 4)  # NOS009
    c = torch.randint(0, 8, (n,))  # NOS009
    return a, b, c


def shuffle(nodes, probs):
    order = torch.randperm(len(nodes))  # NOS009
    pick = torch.multinomial(probs, 1)  # NOS009
    coin = torch.bernoulli(probs)  # NOS009
    noise = torch.normal(0.0, 1.0, size=(3,))  # NOS009
    return order, pick, coin, noise


def reseed():
    torch.manual_seed(0)  # NOS009
    return random.random()  # NOS009
