#!/bin/bash
# Converged physics of the PyTorch/CUDA port (fermiflow_tpu_torch) on one
# NVIDIA GPU: the JAX package's converged training records, retrained with
# the port's CLIs under the protocol of validation/r5_flagship_ode4.sh and
# validation/sweep_beta_crossover.sh (persistent walkers with per-walker
# tau, 30 Metropolis steps an iteration, steps-per-call 10, float32, seed 42,
# a checkpoint every 500 iterations; the polish resumes the same checkpoint
# directory at a lower lr and a larger --iternum): the six rows of the
# flagship, N = 10 and Taut configurations, then the N = 6 coupling sweep
# (Z = 1, 2, 4, 8) at T = 0 (the r3 protocol, docs/VALIDATION.md:33-37) and
# at beta = 2 (validation/sweep_beta_crossover.sh:19-33), and the beta = 10
# zero-temperature-limit row (docs/VALIDATION.md:21).  Then the port's
# checkpoint evaluator (fermiflow_tpu_torch.cli.eval_at_checkpoint) at the
# converged ground-state checkpoints, both engines, fresh chains; the
# crossover structure (fermiflow_tpu_torch.cli.crossover_analysis) at the
# five N = 6 ground-state checkpoints; and the ODE-steps study
# (fermiflow_tpu_torch.cli.ode_steps_study) at Z = 0.5 and Z = 8.
#
#   bash validation/torch_converged.sh [ROW ...]
#
# ROW: gs_n6 beta_n6 gs_n10 beta_n10 taut_singlet taut_triplet
# gs_n6_z10 gs_n6_z20 gs_n6_z40 gs_n6_z80 beta_n6_z10 beta_n6_z20
# beta_n6_z40 beta_n6_z80 beta_n3_b10 gs_n3_fresh gs_n6_fresh
# gs_n6_z10_fresh gs_n6_z20_fresh beta_n6_fresh gs_n6_z40_fresh
# gs_n6_z80_fresh beta_n6_b10_fresh beta_n6_b40_fresh beta_n3_z05 xover
# odesteps eval
# (default: all of them, in that order); eval_z80 is eval at the Z = 8 checkpoint alone;
# gs_n6_graph (not in the default) is gs_n6 again into records of its own,
# torch_gs_n6_z05_ode4_graph*: the row retrained through the CLI's
# captured chunks, beside the eager chunks' records of gs_n6.
# gs_n3_fresh gs_n6_fresh gs_n6_z10_fresh gs_n6_z20_fresh beta_n6_fresh
# (in the default, before xover) retrain the five round-2 JAX records of
# the reference's fresh-walker protocol (docs/VALIDATION.md:12-17, :23-30)
# under it: the CLIs' default sampling (no --persistent: every iteration
# 100 Metropolis steps at tau 0.1 from fresh Gaussians drawn on the card),
# batch 8192, lr 3e-3, ode 8, steps-per-call 10, the records' 3000 or 2000
# iterations, no polish, into torch_<record>_fresh.jsonl.  The bounds on
# |port - JAX| of the last-500 mean, fixed before the runs: GS N = 3
# 0.002; GS N = 6, Z = 0.5 0.005; Z = 1 0.006; Z = 2 0.010; finite T
# N = 6 (beta 2, deltaE 2, Boltzmann) F 0.005 and |S - S_an| <= 0.02 on
# the last row (validation/torch_converged_summary.py).
# gs_n6_z40_fresh gs_n6_z80_fresh beta_n6_b10_fresh beta_n6_b40_fresh
# beta_n3_z05 (in the default, after beta_n6_fresh) retrain the JAX
# package's last five training records: the fresh protocol at Z = 4 and 8
# (3000 iterations) and at beta = 1 and 4 (Z = 0.5, deltaE 2, Boltzmann,
# 2000), each row first checked at step 1 (10 iterations of its flags at
# the identity flow into torch_<record>_step1.jsonl: E within 0.1 of the
# JAX record's step 1, which confirms Z, or the row is not trained); and
# the persistent finite-T run at N = 3, beta 2, deltaE 2, Z = 0.5,
# Boltzmann, batch 8192, ode 4 (the JAX Config default; its record does
# not say), 3000 at 3e-3 + 1000 at 1e-3 (docs/VALIDATION.md:168-173).
# Bounds on the last-500 means, fixed before the runs: GS Z = 4 0.018,
# Z = 8 0.033; beta = 1 F 0.010, beta = 4 F 0.005, each with the tail
# mean of S - S_an within 0.005 of 0; N = 3 F 0.002 and within 0.004 of
# the reference's 5.5264, the last row's |S - S_an| <= 0.02 and the tail
# mean of S - S_an within 0.005 of the JAX record's.
# xover and odesteps retrain gs_n6 first when $CK lacks its checkpoint.
# Records go to $OUT (validation/runs), each run's wall seconds to
# $OUT/torch_converged_wall.jsonl, checkpoints to $CK (validation/ck), logs
# to $LOGS ($OUT/logs).  A row's training starts from an empty checkpoint directory.
# Summarise with `python validation/torch_converged_summary.py`.
set -u
OUT=${OUT:-validation/runs}
CK=${CK:-validation/ck}
LOGS=${LOGS:-$OUT/logs}
mkdir -p "$OUT" "$CK" "$LOGS"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0

proto="--dtype float32 --seed 42 --persistent --mcmc-steps 30 \
  --steps-per-call 10 --checkpoint-every 500"

wall () {  # wall <record> <rc> <t0> <t1>: print and keep a run's wall time
  local line
  line="{\"record\": \"$1\", \"rc\": $2, \"wall_s\": $(python -c "print($4 - $3)")}"
  echo "$line"
  echo "$line" >> "$OUT/torch_converged_wall.jsonl"
}

seg () {  # seg <cli> <record> <row flags...>: one training segment
  local cli=$1 rec=$2 t0 t1 rc; shift 2
  rm -f "$OUT/$rec.jsonl"
  t0=$(date +%s.%N)
  python -u -m "fermiflow_tpu_torch.cli.$cli" $proto "$@" \
    --metrics "$OUT/$rec.jsonl" > "$LOGS/$rec.log" 2>&1
  rc=$?
  t1=$(date +%s.%N)
  wall "$rec" $rc "$t0" "$t1"
  tail -n 1 "$LOGS/$rec.log"
  [ $rc -eq 0 ] || status=1
}

train () {  # train <cli> <record> <iters> <polish iters|0> <row flags...>
  local cli=$1 rec=$2 it=$3 pol=$4 ck; shift 4
  ck="$CK/torch_$rec"
  rm -rf "$ck"
  seg "$cli" "torch_$rec" --checkpoint-dir "$ck" --iternum "$it" \
    --lr 3e-3 "$@"
  if [ "$pol" -gt 0 ]; then
    seg "$cli" "torch_${rec}_polish" --checkpoint-dir "$ck" \
      --iternum $((it + pol)) --lr 1e-3 "$@"
  fi
}

tool () {  # tool <module> <record> <flags...>: one analysis run
  local mod=$1 rec=$2 t0 t1 rc; shift 2
  t0=$(date +%s.%N)
  python -u -m "fermiflow_tpu_torch.cli.$mod" "$@" --out "$OUT/$rec.json" \
    > "$LOGS/$rec.log" 2>&1
  rc=$?
  t1=$(date +%s.%N)
  wall "$rec" $rc "$t0" "$t1"
  tail -n 1 "$LOGS/$rec.log"
  [ $rc -eq 0 ] || status=1
}

need_gs_n6 () {  # the Z = 0.5 checkpoint, retrained when $CK lacks it
  ls "$CK/torch_gs_n6_z05_ode4"/ckpt_*.pt > /dev/null 2>&1 || train \
    ground_state gs_n6_z05_ode4 3000 1000 --nup 6 --Z 0.5 --batch 8192 \
    --ode-steps 4
}

gs_sweep () {  # gs_sweep <tag> <Z>: the r3 protocol at N = 6
  train ground_state "gs_n6_$1" 3000 2000 --nup 6 --Z "$2" --batch 8192 \
    --ode-steps 8
}

fresh () {  # fresh <cli> <record> <iters> <row flags...>: the CLIs'
  # default fresh-walker protocol, batch 8192, ode 8, no polish
  local proto="--dtype float32 --seed 42 --steps-per-call 10 \
    --checkpoint-every 500"
  train "$1" "$2" "$3" 0 --batch 8192 --ode-steps 8 "${@:4}"
}

step1 () {  # step1 <cli> <record> <JAX step-1 E> <row flags...>: 10
  # iterations of fresh's protocol at the identity flow; true when step
  # 1's E lies within 0.1 of the JAX record's
  local proto="--dtype float32 --seed 42 --steps-per-call 10" rec="torch_$2"
  seg "$1" "${rec}_step1" --iternum 10 --lr 3e-3 --batch 8192 --ode-steps 8 \
    "${@:4}"
  python - "$OUT/${rec}_step1.jsonl" "$3" <<'PY'
import json, sys
e, ref = json.loads(open(sys.argv[1]).readline())["E"], float(sys.argv[2])
ok = abs(e - ref) <= 0.1
print(f"step 1: E {e:.5f}, the JAX record's {ref}: {e - ref:+.5f} "
      f"({'within' if ok else 'BEYOND'} 0.1)")
sys.exit(0 if ok else 1)
PY
}

fresh_checked () {  # fresh_checked <cli> <record> <iters> <JAX step-1 E>
  # <row flags...>: fresh, once step1 confirms the row's configuration
  if step1 "$1" "$2" "$4" "${@:5}"; then
    fresh "$1" "$2" "$3" "${@:5}"
  else
    echo "$2: step 1 misses the JAX record's; the row is not trained"
    status=1
  fi
}

beta_sweep () {  # beta_sweep <tag> <Z>: beta = 2, deltaE = 2 at N = 6
  train finite_t "beta_n6_$1" 3000 1000 --nup 6 --Z "$2" --beta 2.0 \
    --deltaE 2.0 --boltzmann --batch 8192 --ode-steps 8
}

# Z of each N = 6 ground-state checkpoint and its --ode-steps.
XOVER="z05_ode4:0.5:4 z10:1.0:8 z20:2.0:8 z40:4.0:8 z80:8.0:8"

evaluate () {  # evaluate <record> <row flags...>: both engines
  local rec=$1 engine t0 t1 rc; shift
  for engine in hessian_flow nested_jvp; do
    t0=$(date +%s.%N)
    python -u -m fermiflow_tpu_torch.cli.eval_at_checkpoint \
      --ckpt "$CK/torch_$rec" --engine $engine --reps 8 --equil 600 "$@" \
      --out "$OUT/torch_eval_${rec}_$engine.json" \
      > "$LOGS/torch_eval_${rec}_$engine.log" 2>&1
    rc=$?
    t1=$(date +%s.%N)
    wall "torch_eval_${rec}_$engine" $rc "$t0" "$t1"
    tail -n 1 "$LOGS/torch_eval_${rec}_$engine.log"
    [ $rc -eq 0 ] || status=1
  done
}

rows=${*:-gs_n6 beta_n6 gs_n10 beta_n10 taut_singlet taut_triplet \
  gs_n6_z10 gs_n6_z20 gs_n6_z40 gs_n6_z80 beta_n6_z10 beta_n6_z20 \
  beta_n6_z40 beta_n6_z80 beta_n3_b10 gs_n3_fresh gs_n6_fresh \
  gs_n6_z10_fresh gs_n6_z20_fresh beta_n6_fresh gs_n6_z40_fresh \
  gs_n6_z80_fresh beta_n6_b10_fresh beta_n6_b40_fresh beta_n3_z05 xover \
  odesteps eval}
for row in $rows; do
  case $row in
    gs_n6) train ground_state gs_n6_z05_ode4 3000 1000 \
      --nup 6 --Z 0.5 --batch 8192 --ode-steps 4 ;;
    gs_n6_graph) train ground_state gs_n6_z05_ode4_graph 3000 1000 \
      --nup 6 --Z 0.5 --batch 8192 --ode-steps 4 ;;
    beta_n6) train finite_t beta_n6_z05 3000 1000 \
      --nup 6 --Z 0.5 --beta 2.0 --deltaE 2.0 --boltzmann --batch 8192 \
      --ode-steps 8 ;;
    gs_n10) train ground_state gs_n10_z05 3000 2000 \
      --nup 10 --Z 0.5 --batch 4096 --ode-steps 8 ;;
    beta_n10) train finite_t beta_n10_de4 1000 0 \
      --nup 10 --Z 0.5 --beta 1.0 --deltaE 4.0 --boltzmann --batch 2048 \
      --ode-steps 8 ;;
    # The singlet's opposite spins meet at the Coulomb cusp: single
    # iterations' E and E_std jump far beyond the divergence watchdog's
    # defaults (the JAX record gs_n2_taut_singlet.jsonl has five such rows,
    # its run unbroken), so the watchdog is off there.
    taut_singlet) train ground_state gs_n2_taut_singlet 3000 0 \
      --nup 1 --ndown 1 --Z 1.0 --batch 8192 --ode-steps 8 \
      --divergence-window 0 ;;
    taut_triplet) train ground_state gs_n2_taut_triplet 3000 0 \
      --nup 2 --Z 1.7320508075688772 --batch 8192 --ode-steps 8 ;;
    gs_n6_z10) gs_sweep z10 1.0 ;;
    gs_n6_z20) gs_sweep z20 2.0 ;;
    gs_n6_z40) gs_sweep z40 4.0 ;;
    gs_n6_z80) gs_sweep z80 8.0 ;;
    beta_n6_z10) beta_sweep z10 1.0 ;;
    beta_n6_z20) beta_sweep z20 2.0 ;;
    beta_n6_z40) beta_sweep z40 4.0 ;;
    beta_n6_z80) beta_sweep z80 8.0 ;;
    beta_n3_b10) train finite_t beta_n3_b10_z2 1000 0 \
      --nup 3 --Z 2.0 --beta 10.0 --deltaE 2.0 --boltzmann --batch 2048 \
      --ode-steps 8 ;;
    gs_n3_fresh) fresh ground_state gs_n3_z05_fresh 3000 --nup 3 --Z 0.5 ;;
    gs_n6_fresh) fresh ground_state gs_n6_z05_fresh 2000 --nup 6 --Z 0.5 ;;
    gs_n6_z10_fresh) fresh ground_state gs_n6_z10_fresh 2000 --nup 6 \
      --Z 1.0 ;;
    gs_n6_z20_fresh) fresh ground_state gs_n6_z20_fresh 2000 --nup 6 \
      --Z 2.0 ;;
    beta_n6_fresh) fresh finite_t beta_n6_z05_fresh 2000 --nup 6 --Z 0.5 \
      --beta 2.0 --deltaE 2.0 --boltzmann ;;
    gs_n6_z40_fresh) fresh_checked ground_state gs_n6_z40_fresh 3000 49.848 \
      --nup 6 --Z 4.0 ;;
    gs_n6_z80_fresh) fresh_checked ground_state gs_n6_z80_fresh 3000 85.696 \
      --nup 6 --Z 8.0 ;;
    beta_n6_b10_fresh) fresh_checked finite_t beta_n6_b10_fresh 2000 19.870 \
      --nup 6 --Z 0.5 --beta 1.0 --deltaE 2.0 --boltzmann ;;
    beta_n6_b40_fresh) fresh_checked finite_t beta_n6_b40_fresh 2000 18.678 \
      --nup 6 --Z 0.5 --beta 4.0 --deltaE 2.0 --boltzmann ;;
    beta_n3_z05) train finite_t beta_n3_z05 3000 1000 --nup 3 --Z 0.5 \
      --beta 2.0 --deltaE 2.0 --boltzmann --batch 8192 --ode-steps 4 ;;
    xover)
      need_gs_n6
      for spec in $XOVER; do
        IFS=: read -r tag z ode <<< "$spec"
        tool crossover_analysis "torch_xover_${tag%_ode4}" \
          --ckpt "$CK/torch_gs_n6_$tag" --nup 6 --Z "$z" --walkers 32768 \
          --train-batch 8192 --equil 600 --rmax 6.0 --bins 120 \
          --ode-steps "$ode"
      done ;;
    odesteps)
      need_gs_n6
      tool ode_steps_study torch_ode_steps_z05 \
        --ckpt "$CK/torch_gs_n6_z05_ode4" --nup 6 --Z 0.5 --batch 256
      tool ode_steps_study torch_ode_steps_z80 \
        --ckpt "$CK/torch_gs_n6_z80" --nup 6 --Z 8.0 --batch 256 ;;
    eval)
      evaluate gs_n6_z05_ode4 --nup 6 --Z 0.5 --batch 8192 \
        --train-batch 8192 --ode-steps 4
      evaluate gs_n10_z05 --nup 10 --Z 0.5 --batch 4096 --train-batch 4096 \
        --ode-steps 8
      evaluate gs_n2_taut_singlet --nup 1 --ndown 1 --Z 1.0 --batch 8192 \
        --train-batch 8192 --ode-steps 8 ;&  # and on into eval_z80
    eval_z80)
      evaluate gs_n6_z80 --nup 6 --Z 8.0 --batch 8192 --train-batch 8192 \
        --ode-steps 8 ;;
    *) echo "unknown row $row"; exit 2 ;;
  esac
done
echo "TORCH CONVERGED DONE status=$status"
exit $status
